// systolic_gemm: the tiled GEMM with CarbonPATH's mapping knobs (dataflow,
// split-K, tile; paper Sec IV-A), for Hopper.
//
// Replaces the four Pallas TPU kernels of
// src/repro/kernels/systolic_gemm/kernel.py:
//   os_gemm          (_os_kernel)          -> os_gemm_launch
//   os_gemm_splitk   (_os_splitk_kernel)   -> os_gemm_splitk_launch
//   ws_gemm_partials (_spill_kernel)       -> ws_gemm_partials_launch
//   is_gemm_partials (_spill_kernel)       -> is_gemm_partials_launch
// on a (M, K) x (K, N) product whose dimensions are multiples of the tile
// (bm, bk, bn); the wrapper pads. Inputs are float32, bfloat16 or float16
// (a and b of one type); every product and sum is a float32 FFMA.
//
//   OS        one block per (m-block, n-block); the float32 accumulator
//             stays in registers across the k-blocks, walked in order, and
//             is cast to the output type once, at the flush.
//   OS split  one block per (shard s, m-block, n-block); shard s walks
//             k-blocks [s*nk, (s+1)*nk) and writes float32 slab s.
//   WS        one block per (n-block, k-block): the (bk x bn) block of b
//             is loaded into shared memory once and stays there while the
//             block sweeps every m-block, writing one float32 partial
//             (k-block, m-block, n-block) per step.
//   IS        one block per (m-block, k-block): the (bm x bk) block of a
//             stays resident while the block sweeps every n-block.
// The dataflow is the loop order plus which operand is resident in shared
// memory, as the TPU grid order plus the BlockSpec index maps made it.
//
// What bounds it: operations for the real workloads at float32 (WL2:
// 29.7 GFLOP, 0.44 ms at the 67 TFLOP/s FFMA rate, against 0.04 ms of
// operand bytes); the float32 slabs that WS, IS and split-K write add
// K/bk (or splits) x M x N x 4 bytes, which is what the paper charges
// those dataflows for. This simple design does not reach the bound: no
// tensor cores (wgmma), no TMA or cp.async, no double buffering.
//
// Design: 256 threads as 16 x 16; thread (ty, tx) owns output rows
// ty + 16 i and columns tx + 16 j of the (bm x bn) tile, i < bm/16,
// j < bn/16 (so bm, bn are multiples of 16, at most 128: an 8 x 8
// register block). The streamed operands come through shared memory in
// k-chunks of 32, converted to float32 on the way in: a transposed
// (sA[k][m], row pitch bm + 1, so its writes do not conflict) and b as it
// is (sB[k][n]); in the inner loop a warp reads two addresses of sA and
// sixteen of sB per k, all broadcasts. The resident operand of WS/IS is
// staged the same way, whole, once per block. Shared memory per block:
//   OS, split: 4 * 32 * (bm + 1 + bn) bytes
//   WS:        4 * (bk * bn + 32 * (bm + 1))
//   IS:        4 * (bk * (bm + 1) + 32 * bn)
// systolic_gemm_init() raises each kernel's dynamic shared memory limit to
// the device's opt-in maximum (232,448 B on the H100) once, when the
// library is loaded; a tile above it is refused. Offsets are 64-bit: the
// slabs at a full-width LM shape hold 367 M elements.
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers and the current stream, has validated dtypes, shapes and the
// tile, and allocates the outputs. Each launcher returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSide = 16;               // threads per tile side
constexpr int kThreads = kSide * kSide;
constexpr int kFrag = 8;                // rows (columns) a thread owns
constexpr int kMaxTile = kSide * kFrag; // 128
constexpr int kChunk = 32;              // k-depth staged per step

template <typename T> struct Tag { using type = T; };

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}

template <typename O> __device__ __forceinline__ O from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// rows [r0, r0 + rows) x columns [k0, k0 + kc) of a row-major operand
// with row length ld, into s[k * lds + r] (transposed). Neighbouring
// threads read neighbouring k: coalesced.
template <typename T>
__device__ __forceinline__ void stage_t(const T* __restrict__ g, int64_t ld,
                                        int64_t r0, int64_t k0, int rows,
                                        int kc, float* s, int lds) {
  for (int i = threadIdx.x; i < rows * kc; i += kThreads) {
    const int r = i / kc, k = i - r * kc;
    s[k * lds + r] = to_float(g[(r0 + r) * ld + k0 + k]);
  }
}

// rows [k0, k0 + kc) x columns [c0, c0 + cols) of a row-major operand
// with row length ld, into s[k * cols + c] (as it is).
template <typename T>
__device__ __forceinline__ void stage_n(const T* __restrict__ g, int64_t ld,
                                        int64_t k0, int64_t c0, int kc,
                                        int cols, float* s) {
  for (int i = threadIdx.x; i < kc * cols; i += kThreads) {
    const int k = i / cols, c = i - k * cols;
    s[k * cols + c] = to_float(g[(k0 + k) * ld + c0 + c]);
  }
}

// acc[i][j] += sum over k < kc of sA[k][ty + 16 i] * sB[k][tx + 16 j]
__device__ __forceinline__ void mma(const float* sA, int lda, const float* sB,
                                    int ldb, int kc, int fm, int fn,
                                    float (&acc)[kFrag][kFrag]) {
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    float av[kFrag], bv[kFrag];
#pragma unroll
    for (int i = 0; i < kFrag; ++i)
      av[i] = i < fm ? sA[k * lda + ty + kSide * i] : 0.f;
#pragma unroll
    for (int j = 0; j < kFrag; ++j)
      bv[j] = j < fn ? sB[k * ldb + tx + kSide * j] : 0.f;
#pragma unroll
    for (int i = 0; i < kFrag; ++i)
#pragma unroll
      for (int j = 0; j < kFrag; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename O>
__device__ __forceinline__ void flush(O* __restrict__ out, int64_t ldo,
                                      int64_t r0, int64_t c0, int fm, int fn,
                                      const float (&acc)[kFrag][kFrag]) {
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    if (i >= fm) break;
#pragma unroll
    for (int j = 0; j < kFrag; ++j) {
      if (j >= fn) break;
      out[(r0 + ty + kSide * i) * ldo + c0 + tx + kSide * j] =
          from_float<O>(acc[i][j]);
    }
  }
}

// Output-stationary tile (blockIdx.y, blockIdx.x) over k-blocks [kb0, kb1).
template <typename T, typename O>
__device__ __forceinline__ void os_tile(const T* __restrict__ a,
                                        const T* __restrict__ b,
                                        O* __restrict__ out, int64_t K,
                                        int64_t N, int bm, int bk, int bn,
                                        int64_t kb0, int64_t kb1) {
  extern __shared__ float smem[];
  const int lda = bm + 1;
  float* sA = smem;
  float* sB = smem + kChunk * lda;
  const int64_t r0 = (int64_t)blockIdx.y * bm, c0 = (int64_t)blockIdx.x * bn;
  const int fm = bm / kSide, fn = bn / kSide;
  float acc[kFrag][kFrag];
#pragma unroll
  for (int i = 0; i < kFrag; ++i)
#pragma unroll
    for (int j = 0; j < kFrag; ++j) acc[i][j] = 0.f;
  for (int64_t kb = kb0; kb < kb1; ++kb) {  // the TPU grid's k axis, in order
    for (int kc0 = 0; kc0 < bk; kc0 += kChunk) {
      const int kc = min(kChunk, bk - kc0);
      const int64_t k0 = kb * bk + kc0;
      __syncthreads();
      stage_t(a, K, r0, k0, bm, kc, sA, lda);
      stage_n(b, N, k0, c0, kc, bn, sB);
      __syncthreads();
      mma(sA, lda, sB, bn, kc, fm, fn, acc);
    }
  }
  flush(out, N, r0, c0, fm, fn, acc);
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    os_kernel(const T* __restrict__ a, const T* __restrict__ b,
              O* __restrict__ out, int64_t K, int64_t N, int bm, int bk,
              int bn) {
  os_tile<T, O>(a, b, out, K, N, bm, bk, bn, 0, K / bk);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    os_splitk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ slabs, int64_t M, int64_t K,
                     int64_t N, int bm, int bk, int bn, int64_t nk) {
  const int64_t s = blockIdx.z;
  os_tile<T, float>(a, b, slabs + s * M * N, K, N, bm, bk, bn, s * nk,
                    (s + 1) * nk);
}

// WS (kWS) / IS: one float32 partial per (k-block, m-block, n-block), with
// the stationary operand's block resident across the innermost sweep.
template <typename T, bool kWS>
__global__ void __launch_bounds__(kThreads)
    spill_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ slabs, int64_t M, int64_t K, int64_t N,
                 int bm, int bk, int bn) {
  extern __shared__ float smem[];
  const int64_t k0 = (int64_t)blockIdx.y * bk;  // this block's k-block
  float* slab = slabs + (int64_t)blockIdx.y * M * N;
  const int lda = bm + 1;
  const int fm = bm / kSide, fn = bn / kSide;
  float acc[kFrag][kFrag];
  if (kWS) {
    float* sB = smem;                 // resident: b[k0 : k0+bk, c0 : c0+bn]
    float* sA = smem + bk * bn;
    const int64_t c0 = (int64_t)blockIdx.x * bn;
    stage_n(b, N, k0, c0, bk, bn, sB);
    for (int64_t r0 = 0; r0 < M; r0 += bm) {  // the m sweep
#pragma unroll
      for (int i = 0; i < kFrag; ++i)
#pragma unroll
        for (int j = 0; j < kFrag; ++j) acc[i][j] = 0.f;
      for (int kc0 = 0; kc0 < bk; kc0 += kChunk) {
        const int kc = min(kChunk, bk - kc0);
        __syncthreads();
        stage_t(a, K, r0, k0 + kc0, bm, kc, sA, lda);
        __syncthreads();
        mma(sA, lda, sB + kc0 * bn, bn, kc, fm, fn, acc);
      }
      flush(slab, N, r0, c0, fm, fn, acc);
    }
  } else {
    float* sA = smem;                 // resident: a[r0 : r0+bm, k0 : k0+bk]
    float* sB = smem + bk * lda;
    const int64_t r0 = (int64_t)blockIdx.x * bm;
    stage_t(a, K, r0, k0, bm, bk, sA, lda);
    for (int64_t c0 = 0; c0 < N; c0 += bn) {  // the n sweep
#pragma unroll
      for (int i = 0; i < kFrag; ++i)
#pragma unroll
        for (int j = 0; j < kFrag; ++j) acc[i][j] = 0.f;
      for (int kc0 = 0; kc0 < bk; kc0 += kChunk) {
        const int kc = min(kChunk, bk - kc0);
        __syncthreads();
        stage_n(b, N, k0 + kc0, c0, kc, bn, sB);
        __syncthreads();
        mma(sA + kc0 * lda, lda, sB, bn, kc, fm, fn, acc);
      }
      flush(slab, N, r0, c0, fm, fn, acc);
    }
  }
}

template <typename F> bool with_type(int code, F&& f) {
  switch (code) {
    case 0: f(Tag<float>{}); return true;
    case 1: f(Tag<__nv_bfloat16>{}); return true;
    case 2: f(Tag<__half>{}); return true;
    default: return false;
  }
}

size_t os_smem(int bm, int bn) {
  return sizeof(float) * kChunk * (bm + 1 + bn);
}
size_t ws_smem(int bm, int bk, int bn) {
  return sizeof(float) * ((size_t)bk * bn + (size_t)kChunk * (bm + 1));
}
size_t is_smem(int bm, int bk, int bn) {
  return sizeof(float) * ((size_t)bk * (bm + 1) + (size_t)kChunk * bn);
}

int g_smem_limit = 0;  // set by systolic_gemm_init

// The tile is one the kernels take, the shapes are its multiples, and the
// block's shared memory is within the limit.
bool args_ok(int64_t M, int64_t K, int64_t N, int bm, int bk, int bn,
             size_t smem) {
  return bm >= kSide && bn >= kSide && bm <= kMaxTile && bn <= kMaxTile &&
         bm % kSide == 0 && bn % kSide == 0 && bk >= 1 && M > 0 && K > 0 &&
         N > 0 && M % bm == 0 && K % bk == 0 && N % bn == 0 &&
         smem <= (size_t)g_smem_limit;
}

template <typename Kern>
void allow_smem(Kern kernel, int bytes) {
  cudaFuncSetAttribute((const void*)kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Raise every kernel's dynamic shared memory limit to the device's opt-in
// maximum. Called once when the library is loaded, outside any capture.
extern "C" int systolic_gemm_init() {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&g_smem_limit,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int code = 0; code < 3; ++code) {
    with_type(code, [&](auto in) {
      using T = typename decltype(in)::type;
      allow_smem(os_kernel<T, float>, g_smem_limit);
      allow_smem(os_kernel<T, __nv_bfloat16>, g_smem_limit);
      allow_smem(os_kernel<T, __half>, g_smem_limit);
      allow_smem(os_splitk_kernel<T>, g_smem_limit);
      allow_smem(spill_kernel<T, true>, g_smem_limit);
      allow_smem(spill_kernel<T, false>, g_smem_limit);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int os_gemm_launch(const void* a, const void* b, void* out,
                              int64_t M, int64_t K, int64_t N, int bm, int bk,
                              int bn, int in_type, int out_type,
                              void* stream) {
  const size_t smem = os_smem(bm, bn);
  if (!args_ok(M, K, N, bm, bk, bn, smem) || M / bm > 65535 ||
      out_type < 0 || out_type > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(N / bn), (unsigned)(M / bm));
  const bool ok = with_type(in_type, [&](auto in) {
    using T = typename decltype(in)::type;
    with_type(out_type, [&](auto o) {
      using O = typename decltype(o)::type;
      os_kernel<T, O><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const T*)a, (const T*)b, (O*)out, K, N, bm, bk, bn);
    });
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int os_gemm_splitk_launch(const void* a, const void* b,
                                     void* slabs, int64_t M, int64_t K,
                                     int64_t N, int splits, int bm, int bk,
                                     int bn, int in_type, void* stream) {
  const size_t smem = os_smem(bm, bn);
  if (!args_ok(M, K, N, bm, bk, bn, smem) || M / bm > 65535 ||
      splits < 1 || splits > 65535 || K % ((int64_t)splits * bk))
    return (int)cudaErrorInvalidValue;
  const int64_t nk = K / bk / splits;
  const dim3 grid((unsigned)(N / bn), (unsigned)(M / bm), (unsigned)splits);
  const bool ok = with_type(in_type, [&](auto in) {
    using T = typename decltype(in)::type;
    os_splitk_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)a, (const T*)b, (float*)slabs, M, K, N, bm, bk, bn, nk);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ws_gemm_partials_launch(const void* a, const void* b,
                                       void* slabs, int64_t M, int64_t K,
                                       int64_t N, int bm, int bk, int bn,
                                       int in_type, void* stream) {
  const size_t smem = ws_smem(bm, bk, bn);
  if (!args_ok(M, K, N, bm, bk, bn, smem) || K / bk > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(N / bn), (unsigned)(K / bk));
  const bool ok = with_type(in_type, [&](auto in) {
    using T = typename decltype(in)::type;
    spill_kernel<T, true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)a, (const T*)b, (float*)slabs, M, K, N, bm, bk, bn);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int is_gemm_partials_launch(const void* a, const void* b,
                                       void* slabs, int64_t M, int64_t K,
                                       int64_t N, int bm, int bk, int bn,
                                       int in_type, void* stream) {
  const size_t smem = is_smem(bm, bk, bn);
  if (!args_ok(M, K, N, bm, bk, bn, smem) || K / bk > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(M / bm), (unsigned)(K / bk));
  const bool ok = with_type(in_type, [&](auto in) {
    using T = typename decltype(in)::type;
    spill_kernel<T, false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)a, (const T*)b, (float*)slabs, M, K, N, bm, bk, bn);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
