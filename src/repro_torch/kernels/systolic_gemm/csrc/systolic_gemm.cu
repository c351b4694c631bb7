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
// (a and b of one type); every sum is float32.
//
//   OS        one block per (m-block, n-block); the float32 accumulator
//             stays in registers across the k-blocks, walked in order, and
//             is cast to the output type once, at the flush.
//   OS split  one block per (shard s, m-block, n-block); shard s walks
//             k-blocks [s*nk, (s+1)*nk) and writes float32 slab s.
//   WS        one block per (n-block, k-block): the (bk x bn) block of b
//             is loaded into shared memory once and stays there while the
//             block sweeps every m-block in ascending order, writing one
//             float32 partial (k-block, m-block, n-block) per step.
//   IS        one block per (m-block, k-block): the (bm x bk) block of a
//             stays resident while the block sweeps every n-block.
// The dataflow is the loop order plus which operand is resident in shared
// memory, as the TPU grid order plus the BlockSpec index maps made it.
// Each partial is written once, with no atomics and no reduction across
// blocks.
//
// What bounds it: operations for the real workloads at float32 (WL2:
// 29.7 GFLOP, 0.44 ms at the 67 TFLOP/s FFMA rate, against 0.04 ms of
// operand bytes); the float32 slabs that WS, IS and split-K write add
// K/bk (or splits) x M x N x 4 bytes, which is what the paper charges
// those dataflows for, and which bound WS/IS in 16-bit (WL2: 465 MB,
// 0.139 ms at 3.35 TB/s).
//
// OS and split-K: 256 threads as 16 x 16; thread (ty, tx) owns output rows
// ty + 16 i and columns tx + 16 j of the (bm x bn) tile, i < bm/16,
// j < bn/16 (an 8 x 8 register block). The operands come through shared
// memory in k-chunks of 32, converted to float32 on the way in: a
// transposed (sA[k][m], row pitch bm + 1) and b as it is (sB[k][n]); FFMA,
// no tensor cores, no double buffering. Shared memory per block:
//   OS, split: 4 * 32 * (bm + 1 + bn) bytes
//
// WS and IS take one of two kernels, by spill_path() (mirrored by
// ops.spill_path in Python; the launcher is told the path and refuses a
// mismatch):
//
// "simt" (float32 operands, and every 16-bit tile the other path does not
//   take): 256 threads as 16 x 16; thread (ty, tx) owns rows 4ty + i and
//   64 + 4ty + i, columns 4tx + j and 64 + 4tx + j (i, j < 4; the halves
//   past bm or bn idle), so its 8 + 8 operands of one k are four LDS.128.
//   The resident block and the streamed chunks (k-depth 32) are float32 in
//   shared memory: a transposed (sA[k][m], pitch bm + 4, 16-B aligned), b
//   as it is (sB[k][n], pitch bn). The streamed operand is double-buffered:
//   the next chunk (of this step or the next) is loaded into registers
//   (16-B loads, or 8-B for 16-bit types; scalar when bk % 4 != 0) before
//   this chunk's FFMAs, converted and stored into the other buffer after
//   them, with one __syncthreads per chunk; so the loads, and the
//   float4 slab stores of a finished step, overlap the products. A full
//   32-deep chunk is unrolled, each k's operands loaded one k ahead; the
//   128 x 128 tile has its own instantiation with compile-time pitches,
//   so every shared load takes an immediate offset (126 registers, two
//   blocks per SM). FFMA in float32 throughout (no TF32: the float32
//   contract is 1e-5 x Mag).
//   Shared memory per block (ops.smem_bytes mirrors it):
//     WS: 4 * (bk * bn + 2 * 32 * (bm + 4))
//     IS: 4 * (bk * (bm + 4) + 2 * 32 * bn)
//
// "wgmma" (bfloat16 / float16 with bm, bn in {64, 128} and bk % 16 == 0):
//   warp-specialised. One producer warp issues TMA loads
//   (cp.async.bulk.tensor, mbarrier completion): the resident block once,
//   then the streamed tiles through a ring of 2-4 stages (as many as fit
//   in the simt footprint above, so that one accepted-tile set serves
//   both paths). bm/64 consumer warpgroups each run wgmma.mma_async
//   m64nNk16 (N = bn) with float32 accumulators in registers. a is
//   K-major (k-chunk KC = 64 when 64 | bk, with 128-byte swizzle; else
//   KC = 16, with 32-byte swizzle); b is MN-major (transpose-B set;
//   64-column atoms, 128-byte swizzle). A step's slab tile is written
//   with 8-byte stores straight from the accumulators, while the ring
//   already holds the next step's tiles. Tensor maps are encoded on the
//   host per launch (cuTensorMapEncodeTiled, looked up at init with
//   cudaGetDriverEntryPoint, so the library needs no -lcuda) and
//   passed as __grid_constant__ parameters, which a CUDA graph captures
//   by value.
//
// systolic_gemm_init() raises each kernel's dynamic shared memory limit to
// the device's opt-in maximum (232,448 B on the H100) once, when the
// library is loaded; a tile above it is refused. Offsets are 64-bit: the
// slabs at a full-width LM shape hold 367 M elements.
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers and the current stream, has validated dtypes, shapes and the
// tile, and allocates the outputs. Each launcher returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it refuses.

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// WS / IS, "simt" path: pipelined FFMA
// ---------------------------------------------------------------------------

constexpr int kSpillKc = 32;   // k-depth of one streamed chunk
constexpr int kPitchPad = 4;   // sA[k][m] pitch bm + 4: rows stay 16-B aligned

// four consecutive elements, as loaded: 16 B of float32, 8 B of 16-bit
template <typename T> struct QuadOf { using type = uint2; };
template <> struct QuadOf<float> { using type = float4; };
template <typename T> using quad_t = typename QuadOf<T>::type;

__device__ __forceinline__ float4 quad_float(float4 q, Tag<float>) {
  return q;
}
__device__ __forceinline__ float4 quad_float(uint2 q, Tag<__nv_bfloat16>) {
  return make_float4(
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(q.x & 0xffff))),
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(q.x >> 16))),
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(q.y & 0xffff))),
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(q.y >> 16))));
}
__device__ __forceinline__ float4 quad_float(uint2 q, Tag<__half>) {
  return make_float4(
      __half2float(__ushort_as_half((unsigned short)(q.x & 0xffff))),
      __half2float(__ushort_as_half((unsigned short)(q.x >> 16))),
      __half2float(__ushort_as_half((unsigned short)(q.y & 0xffff))),
      __half2float(__ushort_as_half((unsigned short)(q.y >> 16))));
}

// p[0..4), p 4-element aligned
template <typename T>
__device__ __forceinline__ quad_t<T> load_quad(const T* p) {
  return __ldg(reinterpret_cast<const quad_t<T>*>(p));
}

// p[0..n), n <= 4, zeros after; any alignment
__device__ __forceinline__ float4 load_quad_scalar(const float* p, int n) {
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f,
                     n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}
template <typename T>
__device__ __forceinline__ uint2 load_quad_scalar(const T* p, int n) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  const uint32_t e0 = n > 0 ? u[0] : 0u, e1 = n > 1 ? u[1] : 0u;
  const uint32_t e2 = n > 2 ? u[2] : 0u, e3 = n > 3 ? u[3] : 0u;
  return make_uint2(e0 | (e1 << 16), e2 | (e3 << 16));
}

// A (rows x kc) tile of a row-major a (row length K), held in registers
// between its load and its transposed store into s[k * lds + r]. Group
// g = tid + 256 p is (row g / 8, k-quad g % 8): a warp reads four rows'
// 128-B runs.
template <typename T, bool kVec>
struct ATile {
  quad_t<T> q[4];

  __device__ __forceinline__ void load(const T* __restrict__ a, int64_t K,
                                       int64_t r0, int64_t k0, int rows,
                                       int kc) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int g = threadIdx.x + kThreads * p, r = g >> 3, c = (g & 7) * 4;
      if (r < rows && c < kc) {
        const T* src = a + (r0 + r) * K + k0 + c;
        q[p] = kVec ? load_quad(src) : load_quad_scalar(src, kc - c);
      }
    }
  }

  __device__ __forceinline__ void store(float* s, int lds, int rows,
                                        int kc) const {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int g = threadIdx.x + kThreads * p, r = g >> 3, c = (g & 7) * 4;
      if (r < rows && c < kc) {
        const float4 f = quad_float(q[p], Tag<T>{});
        s[c * lds + r] = f.x;
        if (c + 1 < kc) s[(c + 1) * lds + r] = f.y;
        if (c + 2 < kc) s[(c + 2) * lds + r] = f.z;
        if (c + 3 < kc) s[(c + 3) * lds + r] = f.w;
      }
    }
  }
};

// A (kc x cols) tile of a row-major b (row length N), stored as it is into
// s[k * cols + c]; cols % 16 == 0, so every quad is aligned.
template <typename T>
struct BTile {
  quad_t<T> q[4];

  __device__ __forceinline__ void load(const T* __restrict__ b, int64_t N,
                                       int64_t k0, int64_t c0, int kc,
                                       int cols) {
    const int nq = cols >> 2;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int g = threadIdx.x + kThreads * p, k = g / nq;
      if (k < kc) q[p] = load_quad(b + (k0 + k) * N + c0 + (g - k * nq) * 4);
    }
  }

  __device__ __forceinline__ void store(float* s, int kc, int cols) const {
    const int nq = cols >> 2;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int g = threadIdx.x + kThreads * p, k = g / nq;
      if (k < kc)
        *reinterpret_cast<float4*>(s + k * cols + (g - k * nq) * 4) =
            quad_float(q[p], Tag<T>{});
    }
  }
};

// This thread's rows (columns) in each half of the tile are live when
// the half's first one is inside bm (bn). A dead half reads the tile's
// first rows (columns) instead, so every shared load is unconditional;
// its sums are never stored. kFull: bm = bn = 128, every half live, so
// the offsets are known to differ by 64.
template <bool kFull>
struct Halves {
  bool m0, m1, n0, n1;
  int a0, a1, b0, b1;  // offsets into a row of sA[k][.] / sB[k][.]
  __device__ __forceinline__ Halves(int bm, int bn) {
    const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
    m0 = kFull || 4 * ty < bm;
    m1 = kFull || 64 + 4 * ty < bm;
    n0 = kFull || 4 * tx < bn;
    n1 = kFull || 64 + 4 * tx < bn;
    a0 = m0 ? 4 * ty : 0;
    a1 = kFull ? a0 + 64 : m1 ? 64 + 4 * ty : 0;
    b0 = n0 ? 4 * tx : 0;
    b1 = kFull ? b0 + 64 : n1 ? 64 + 4 * tx : 0;
  }
};

// This thread's 8 + 8 operands of one k: four LDS.128.
struct KOperands {
  float4 a0, a1, b0, b1;
};

template <bool kFull>
__device__ __forceinline__ KOperands load_k(const float* sA, const float* sB,
                                            const Halves<kFull>& h) {
  return {*reinterpret_cast<const float4*>(sA + h.a0),
          *reinterpret_cast<const float4*>(sA + h.a1),
          *reinterpret_cast<const float4*>(sB + h.b0),
          *reinterpret_cast<const float4*>(sB + h.b1)};
}

__device__ __forceinline__ void fma_k(const KOperands& o,
                                      float (&acc)[kFrag][kFrag]) {
  const float av[kFrag] = {o.a0.x, o.a0.y, o.a0.z, o.a0.w,
                           o.a1.x, o.a1.y, o.a1.z, o.a1.w};
  const float bv[kFrag] = {o.b0.x, o.b0.y, o.b0.z, o.b0.w,
                           o.b1.x, o.b1.y, o.b1.z, o.b1.w};
#pragma unroll
  for (int i = 0; i < kFrag; ++i)
#pragma unroll
    for (int j = 0; j < kFrag; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// acc[i][j] += sum over k < kc of sA[k][row i] * sB[k][column j]. A full
// chunk is unrolled with the next k's operands loaded before this k's
// FFMAs; a shorter (last) chunk runs a plain loop. With kFull the pitches
// are compile-time (bm + 4, bn), so every load has an immediate offset.
template <bool kFull>
__device__ __forceinline__ void spill_mma(const float* sA, int lda_rt,
                                          const float* sB, int ldb_rt, int kc,
                                          const Halves<kFull>& h,
                                          float (&acc)[kFrag][kFrag]) {
  const int lda = kFull ? kMaxTile + kPitchPad : lda_rt;
  const int ldb = kFull ? kMaxTile : ldb_rt;
  if (kc == kSpillKc) {
    KOperands cur = load_k(sA, sB, h);
#pragma unroll
    for (int k = 0; k < kSpillKc; ++k) {
      KOperands nxt = cur;
      if (k + 1 < kSpillKc)
        nxt = load_k(sA + (k + 1) * lda, sB + (k + 1) * ldb, h);
      fma_k(cur, acc);
      cur = nxt;
    }
  } else {
    for (int k = 0; k < kc; ++k)
      fma_k(load_k(sA + k * lda, sB + k * ldb, h), acc);
  }
}

// The (bm x bn) tile at (r0, c0) of out (row length ldo), float4 stores.
template <typename H>
__device__ __forceinline__ void spill_flush(float* __restrict__ out,
                                            int64_t ldo, int64_t r0,
                                            int64_t c0, const H& h,
                                            const float (&acc)[kFrag][kFrag]) {
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    if (!(i < 4 ? h.m0 : h.m1)) continue;
    float* row = out + (r0 + (i < 4 ? 0 : 64) + 4 * ty + (i & 3)) * ldo + c0;
    if (h.n0)
      *reinterpret_cast<float4*>(row + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (h.n1)
      *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// WS (kWS) / IS: one float32 partial per (k-block, m-block, n-block), with
// the stationary operand's block resident across the innermost sweep. The
// sweep is one flat sequence of (step, chunk) pairs, so the first chunk of
// step s + 1 is loaded while the last chunk of step s is multiplied.
template <typename T, bool kWS, bool kVec, bool kFull>
__global__ void __launch_bounds__(kThreads)
    spill_simt_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      float* __restrict__ slabs, int64_t M, int64_t K,
                      int64_t N, int bm, int bk, int bn) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lda = bm + kPitchPad;
  const int64_t k0 = (int64_t)blockIdx.y * bk;  // this block's k-block
  float* slab = slabs + (int64_t)blockIdx.y * M * N;
  const int64_t fixed = (int64_t)blockIdx.x * (kWS ? bn : bm);  // c0 / r0
  const int64_t steps = kWS ? M / bm : N / bn;
  const int chunks = (bk + kSpillKc - 1) / kSpillKc;
  // resident: WS sB[k][n] = b[k0 + k][fixed + n]; IS sA[k][m] = a[fixed +
  // m][k0 + k]. Then two buffers of the streamed operand's chunk.
  float* res = smem;
  float* ring = smem + (kWS ? bk * bn : bk * lda);
  const int buf = kSpillKc * (kWS ? lda : bn);
  const Halves<kFull> h(bm, bn);

  ATile<T, kVec> ta;   // WS streams a; IS stages its resident a with it
  BTile<T> tb;         // IS streams b; WS stages its resident b with it
  for (int c = 0; c < chunks; ++c) {
    const int kc = min(kSpillKc, bk - c * kSpillKc);
    if (kWS) {
      tb.load(b, N, k0 + c * kSpillKc, fixed, kc, bn);
      tb.store(res + c * kSpillKc * bn, kc, bn);
    } else {
      ta.load(a, K, fixed, k0 + c * kSpillKc, bm, kc);
      ta.store(res + c * kSpillKc * lda, lda, bm, kc);
    }
  }
  {
    const int kc = min(kSpillKc, bk);
    if (kWS) {
      ta.load(a, K, 0, k0, bm, kc);
      ta.store(ring, lda, bm, kc);
    } else {
      tb.load(b, N, k0, 0, kc, bn);
      tb.store(ring, kc, bn);
    }
  }
  __syncthreads();

  float acc[kFrag][kFrag];
  const int64_t total = steps * chunks;
  int64_t step = 0;
  int c = 0;
  for (int64_t t = 0; t < total; ++t) {
    int cn = c + 1;
    int64_t sn = step;
    if (cn == chunks) {
      cn = 0;
      ++sn;
    }
    const bool more = t + 1 < total;
    const int kcn = min(kSpillKc, bk - cn * kSpillKc);
    if (more) {  // the next chunk, into registers
      if (kWS)
        ta.load(a, K, sn * bm, k0 + cn * kSpillKc, bm, kcn);
      else
        tb.load(b, N, k0 + cn * kSpillKc, sn * bn, kcn, bn);
    }
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kFrag; ++i)
#pragma unroll
        for (int j = 0; j < kFrag; ++j) acc[i][j] = 0.f;
    }
    const int kc = min(kSpillKc, bk - c * kSpillKc);
    const float* cur = ring + (t & 1) * buf;
    if (kWS)
      spill_mma(cur, lda, res + c * kSpillKc * bn, bn, kc, h, acc);
    else
      spill_mma(res + c * kSpillKc * lda, lda, cur, bn, kc, h, acc);
    if (c == chunks - 1)
      spill_flush(slab, N, kWS ? step * bm : fixed, kWS ? fixed : step * bn,
                  h, acc);
    if (more) {
      float* nxt = ring + ((t + 1) & 1) * buf;
      if (kWS)
        ta.store(nxt, lda, bm, kcn);
      else
        tb.store(nxt, kcn, bn);
    }
    __syncthreads();
    step = sn;
    c = cn;
  }
}

// ---------------------------------------------------------------------------
// WS / IS, "wgmma" path: TMA loads into a ring, wgmma products
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kMaxStages = 4;
constexpr int kAlignSlack = 1024; // swizzled tiles sit on 1024-B boundaries
constexpr int kBarBytes = 128;    // 2 * kMaxStages + 1 mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of `map` at (column x, row y) into shared memory at dst,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-B units) and the swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N float32, this thread's N / 2) += A * B over k16, or = A * B
// when scale_d is 0. A: K-major, swizzled (imm-trans-a 0); B: MN-major
// (imm-trans-b 1), 128-byte swizzle.
__device__ __forceinline__ void wgmma_64xN(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d,
                                          Tag<__nv_bfloat16>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_64xN(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d,
                                          Tag<__half>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_64xN(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d,
                                          Tag<__nv_bfloat16>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_64xN(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d,
                                          Tag<__half>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <typename T, bool kWS, int kN, int kKC>
__global__ void __launch_bounds__(2 * kWgThreads + 32)
    spill_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       float* __restrict__ slabs, int M, int N, int bm,
                       int bk, int stages) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kRow = kKC * 2;           // bytes of one a row in a chunk
  constexpr uint32_t kModeA = kKC == 64 ? 1 : 3;
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int consumers = bm / 64 * kWgThreads;
  const int chunks = bk / kKC;
  const int k0 = blockIdx.y * bk;
  const int fixed = blockIdx.x * (kWS ? kN : bm);  // c0 (WS) / r0 (IS)
  const int steps = kWS ? M / bm : N / kN;
  // resident: WS b block as bn/64 column atoms of bk rows x 128 B; IS a
  // block as bk/KC chunks of bm rows x KC * 2 B. Ring stage: WS a tile
  // (bm rows x KC * 2 B); IS b tile (bn/64 atoms of KC rows x 128 B).
  const int res_bytes = 2 * bk * (kWS ? kN : bm);
  const int stage_bytes = 2 * kKC * (kWS ? bm : kN);
  uint8_t* res = base;
  uint8_t* ring = base + res_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  uint64_t* empty = full + kMaxStages;
  uint64_t* res_bar = empty + kMaxStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {  // the producer warp; one thread issues
    if (threadIdx.x != consumers) return;
    mbar_expect_tx(res_bar, res_bytes);
    if (kWS) {
      for (int j = 0; j < kN / 64; ++j)
        for (int q = 0; q < chunks; ++q)
          tma_load(res + j * bk * 128 + q * kKC * 128, &map_b, res_bar,
                   fixed + 64 * j, k0 + q * kKC);
    } else {
      for (int q = 0; q < chunks; ++q)
        tma_load(res + q * bm * kRow, &map_a, res_bar, k0 + q * kKC, fixed);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int step = 0; step < steps; ++step) {
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], stage_bytes);
        uint8_t* dst = ring + s * stage_bytes;
        if (kWS) {
          tma_load(dst, &map_a, &full[s], k0 + c * kKC, step * bm);
        } else {
          for (int j = 0; j < kN / 64; ++j)
            tma_load(dst + j * kKC * 128, &map_b, &full[s],
                     step * kN + 64 * j, k0 + c * kKC);
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each step
  const int wg = threadIdx.x / kWgThreads;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t lbo_b = kWS ? bk * 128 : kKC * 128;  // column-atom stride
  float d[kN / 2];
  mbar_wait(res_bar, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int step = 0; step < steps; ++step) {
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[s], phase);
      const uint8_t* ta = kWS ? ring + s * stage_bytes
                              : res + c * bm * kRow;
      const uint8_t* tb = kWS ? res + c * kKC * 128 : ring + s * stage_bytes;
      ta += wg * 64 * kRow;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kKC / 16; ++k) {
        const uint64_t da = smem_desc(ta + k * 32, 16, 8 * kRow, kModeA);
        const uint64_t db = smem_desc(tb + k * 16 * 128, lbo_b, 1024, 1);
        wgmma_64xN(d, da, db, c > 0 || k > 0, Tag<T>{});
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(d);
      mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    // the step's (bm x bn) partial, 8-B stores from the accumulators
    const int64_t r0 = (int64_t)(kWS ? step * bm : fixed) + wg * 64 +
                       warp * 16 + lane / 4;
    const int64_t c0 = (int64_t)(kWS ? fixed : step * kN) + 2 * (lane % 4);
    float* out = slabs + (int64_t)blockIdx.y * M * N + r0 * N + c0;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(out + 8 * N + 8 * j) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
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

// The simt path's shared memory for a WS (ws) or IS tile; it is also the
// footprint that decides which tiles are accepted, on both paths. Mirrored
// by ops.smem_bytes.
size_t spill_smem(bool ws, int bm, int bk, int bn) {
  const size_t lda = (size_t)bm + kPitchPad;
  return sizeof(float) * (ws ? (size_t)bk * bn + 2 * kSpillKc * lda
                             : (size_t)bk * lda + 2 * kSpillKc * (size_t)bn);
}

// The path of a WS/IS call: 1 ("wgmma") for 16-bit operands at bm, bn in
// {64, 128} and bk % 16 == 0, else 0 ("simt"). Mirrored by ops.spill_path.
int spill_path_of(int in_type, int bm, int bk, int bn) {
  return in_type != 0 && (bm == 64 || bm == 128) && (bn == 64 || bn == 128) &&
         bk % 16 == 0;
}

int wgmma_kc(int bk) { return bk % 64 ? 16 : 64; }

int64_t wgmma_resident(bool ws, int bm, int bk, int bn) {
  return 2 * (int64_t)bk * (ws ? bn : bm);
}

int64_t wgmma_stage(bool ws, int bm, int bk, int bn) {
  return 2 * (int64_t)wgmma_kc(bk) * (ws ? bm : bn);
}

// Ring stages that fit beside the resident block inside spill_smem: 2 to 4
// for every tile spill_path_of routes to wgmma.
int wgmma_stages(bool ws, int bm, int bk, int bn) {
  const int64_t spare = (int64_t)spill_smem(ws, bm, bk, bn) - kAlignSlack -
                        kBarBytes - wgmma_resident(ws, bm, bk, bn);
  const int64_t n = spare / wgmma_stage(ws, bm, bk, bn);
  return (int)(n < kMaxStages ? n : kMaxStages);
}

size_t wgmma_smem(bool ws, int bm, int bk, int bn, int stages) {
  return (size_t)(kAlignSlack + kBarBytes + wgmma_resident(ws, bm, bk, bn) +
                  stages * wgmma_stage(ws, bm, bk, bn));
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

// cuTensorMapEncodeTiled, looked up by systolic_gemm_init
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled g_encode = nullptr;

CUtensorMapDataType tma_type(Tag<__nv_bfloat16>) {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
CUtensorMapDataType tma_type(Tag<__half>) {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// A row-major (rows x cols) 16-bit matrix read in (box_rows x box_cols)
// boxes with the given swizzle.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              int64_t rows, int64_t cols, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return g_encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                  steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool kWS> void allow_simt(int bytes) {
  allow_smem(spill_simt_kernel<T, kWS, false, false>, bytes);
  allow_smem(spill_simt_kernel<T, kWS, false, true>, bytes);
  allow_smem(spill_simt_kernel<T, kWS, true, false>, bytes);
  allow_smem(spill_simt_kernel<T, kWS, true, true>, bytes);
}

template <typename T, bool kWS> void allow_wgmma(int bytes) {
  allow_smem(spill_wgmma_kernel<T, kWS, 64, 16>, bytes);
  allow_smem(spill_wgmma_kernel<T, kWS, 64, 64>, bytes);
  allow_smem(spill_wgmma_kernel<T, kWS, 128, 16>, bytes);
  allow_smem(spill_wgmma_kernel<T, kWS, 128, 64>, bytes);
}

template <typename T, bool kWS, int kN, int kKC>
void launch_wgmma_kernel(const CUtensorMap& ma, const CUtensorMap& mb,
                         float* slabs, int64_t M, int64_t N, int bm, int bk,
                         int stages, dim3 grid, size_t smem,
                         cudaStream_t stream) {
  spill_wgmma_kernel<T, kWS, kN, kKC>
      <<<grid, bm / 64 * kWgThreads + 32, smem, stream>>>(
          ma, mb, slabs, (int)M, (int)N, bm, bk, stages);
}

// The wgmma path of WS (kWS) / IS for 16-bit T.
template <typename T, bool kWS>
int spill_wgmma(const void* a, const void* b, float* slabs, int64_t M,
                int64_t K, int64_t N, int bm, int bk, int bn,
                cudaStream_t stream) {
  const int kc = wgmma_kc(bk), stages = wgmma_stages(kWS, bm, bk, bn);
  if (g_encode == nullptr || stages < 2 || M > INT32_MAX || K > INT32_MAX ||
      N > INT32_MAX || ((uintptr_t)a | (uintptr_t)b) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!make_map(&ma, tma_type(Tag<T>{}), a, M, K, bm, kc,
                kc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_32B) ||
      !make_map(&mb, tma_type(Tag<T>{}), b, K, N, kc, 64,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(kWS ? N / bn : M / bm), (unsigned)(K / bk));
  const size_t smem = wgmma_smem(kWS, bm, bk, bn, stages);
  if (bn == 64 && kc == 64)
    launch_wgmma_kernel<T, kWS, 64, 64>(ma, mb, slabs, M, N, bm, bk, stages,
                                        grid, smem, stream);
  else if (bn == 64)
    launch_wgmma_kernel<T, kWS, 64, 16>(ma, mb, slabs, M, N, bm, bk, stages,
                                        grid, smem, stream);
  else if (kc == 64)
    launch_wgmma_kernel<T, kWS, 128, 64>(ma, mb, slabs, M, N, bm, bk, stages,
                                         grid, smem, stream);
  else
    launch_wgmma_kernel<T, kWS, 128, 16>(ma, mb, slabs, M, N, bm, bk, stages,
                                         grid, smem, stream);
  return (int)cudaGetLastError();
}

// WS (kWS) / IS on the path the caller names; a path that spill_path_of
// does not give for this dtype and tile is refused.
template <bool kWS>
int spill_launch(const void* a, const void* b, void* slabs, int64_t M,
                 int64_t K, int64_t N, int bm, int bk, int bn, int in_type,
                 int path, void* stream) {
  const size_t smem = spill_smem(kWS, bm, bk, bn);
  if (!args_ok(M, K, N, bm, bk, bn, smem) || K / bk > 65535 ||
      in_type < 0 || in_type > 2 || path != spill_path_of(in_type, bm, bk, bn))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (path == 1) {
    return in_type == 1
               ? spill_wgmma<__nv_bfloat16, kWS>(a, b, (float*)slabs, M, K,
                                                 N, bm, bk, bn, st)
               : spill_wgmma<__half, kWS>(a, b, (float*)slabs, M, K, N, bm,
                                          bk, bn, st);
  }
  const dim3 grid((unsigned)(kWS ? N / bn : M / bm), (unsigned)(K / bk));
  with_type(in_type, [&](auto in) {
    using T = typename decltype(in)::type;
    const bool full = bm == kMaxTile && bn == kMaxTile;
    auto kern = bk % 4 ? (full ? spill_simt_kernel<T, kWS, false, true>
                               : spill_simt_kernel<T, kWS, false, false>)
                       : (full ? spill_simt_kernel<T, kWS, true, true>
                               : spill_simt_kernel<T, kWS, true, false>);
    kern<<<grid, kThreads, smem, st>>>((const T*)a, (const T*)b,
                                       (float*)slabs, M, K, N, bm, bk, bn);
  });
  return (int)cudaGetLastError();
}

}  // namespace

// Raise every kernel's dynamic shared memory limit to the device's opt-in
// maximum, and fetch the tensor-map encoder. Called once when the library
// is loaded, outside any capture.
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
      allow_simt<T, true>(g_smem_limit);
      allow_simt<T, false>(g_smem_limit);
    });
  }
  allow_wgmma<__nv_bfloat16, true>(g_smem_limit);
  allow_wgmma<__nv_bfloat16, false>(g_smem_limit);
  allow_wgmma<__half, true>(g_smem_limit);
  allow_wgmma<__half, false>(g_smem_limit);
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                   cudaEnableDefault, &found);
#else
  cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                          &found);
#endif
  if (fn != nullptr && found == cudaDriverEntryPointSuccess)
    g_encode = reinterpret_cast<EncodeTiled>(fn);
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

// path: 0 "simt", 1 "wgmma" (ops.spill_path)
extern "C" int ws_gemm_partials_launch(const void* a, const void* b,
                                       void* slabs, int64_t M, int64_t K,
                                       int64_t N, int bm, int bk, int bn,
                                       int in_type, int path, void* stream) {
  return spill_launch<true>(a, b, slabs, M, K, N, bm, bk, bn, in_type, path,
                            stream);
}

extern "C" int is_gemm_partials_launch(const void* a, const void* b,
                                       void* slabs, int64_t M, int64_t K,
                                       int64_t N, int bm, int bk, int bn,
                                       int in_type, int path, void* stream) {
  return spill_launch<false>(a, b, slabs, M, K, N, bm, bk, bn, in_type, path,
                             stream);
}
