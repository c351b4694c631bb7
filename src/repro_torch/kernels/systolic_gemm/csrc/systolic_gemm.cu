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
// operand bytes) and at 16-bit OS (0.030 ms at the 989 TFLOP/s tensor-core
// rate); the float32 slabs that WS, IS and split-K write add K/bk (or
// splits) x M x N x 4 bytes, which is what the paper charges those
// dataflows for, and which bound them in 16-bit (WL2: WS/IS 465 MB, 0.139
// ms at 3.35 TB/s; split-K 2 155 MB, 0.046 ms).
//
// Every site takes one of two kernels, by path_of() (mirrored by
// ops.kernel_path in Python, a function of the dtype and the tile alone;
// the launcher is told the path and refuses a mismatch): "wgmma" for
// bfloat16 / float16 at bm, bn in {64, 128} and bk % 16 == 0, else
// "simt".
//
// OS and split-K (_os_kernel, _os_splitk_kernel), "simt": pipelined FFMA
//   in float32 (no TF32, as the float32 contract is 1e-5 x Mag), bound by
//   FFMA issue. So the thread block follows the tile and no register lane
//   idles: each thread owns a 4 x 4 block ((bm/4)(bn/4) threads) while
//   that is at most 256 threads, else an 8 x 8 block as two 4-row by two
//   4-column halves, bm/2 and bn/2 apart ((bm/8)(bn/8) threads, 80 to
//   256). A thread's operands of one k are kF/2 LDS.128 (8 or 16 FFMA
//   each), loaded one k ahead. The k range streams through shared memory
//   in 32-deep chunks of both operands, float32, a transposed (sA[k][m],
//   pitch bm + 4) and b as it is; chunk c + 1 is loaded into registers in
//   rounds of four 16-B loads a thread (8-B for 16-bit; scalar when
//   bk % 4 != 0) while chunk c is multiplied, and stored into the other
//   buffer, with one __syncthreads per chunk. The 128 x 128 tile has its
//   own instantiation with compile-time pitches, capped at 128 registers
//   so that two blocks share an SM. One epilogue per tile, from the
//   registers, in the output type (the float32 slab for split-K).
//   Shared memory per block (ops.smem_bytes mirrors it; no bk term, so
//   every bm, bn is accepted at any bk):
//     OS, split: 4 * 2 * 32 * (bm + 4 + bn)
//
// OS and split-K, "wgmma": bound by the tensor-core rate (os_gemm) or by
//   the float32 slab writes (split-K). Warp-specialised, as WS/IS's
//   below, with no resident operand: one producer warp streams the a tile (bm x KC) and
//   the b tile (KC x bn) of each k-chunk by TMA into one mbarrier ring;
//   bm/64 consumer warpgroups run m64nNk16 with scale-d 0 on the first
//   chunk only, so the float32 accumulators stay in registers across all
//   k-blocks, and wait for the previous chunk's group only (wait_group 1)
//   before releasing its stage. The ring holds 96 KB (3 stages of 32 KB
//   at 128 x 128, KC = 64), so that two blocks fit on one SM: the grid is
//   the dataflow's and not persistent, and the second block hides one
//   tile's epilogue (direct stores from the accumulators, in the output
//   type) behind another tile's products.
//
// WS and IS:
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

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kSide = 16;               // threads per tile side
constexpr int kThreads = kSide * kSide;
constexpr int kFrag = 8;                // rows (columns) a thread owns
constexpr int kMaxTile = kSide * kFrag; // 128
constexpr int kChunk = 32;              // k-depth of one streamed chunk (simt)

template <typename T> struct Tag { using type = T; };

// ---------------------------------------------------------------------------
// WS / IS, "simt" path: pipelined FFMA
// ---------------------------------------------------------------------------

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
  if (kc == kChunk) {
    KOperands cur = load_k(sA, sB, h);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      KOperands nxt = cur;
      if (k + 1 < kChunk)
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
  const int chunks = (bk + kChunk - 1) / kChunk;
  // resident: WS sB[k][n] = b[k0 + k][fixed + n]; IS sA[k][m] = a[fixed +
  // m][k0 + k]. Then two buffers of the streamed operand's chunk.
  float* res = smem;
  float* ring = smem + (kWS ? bk * bn : bk * lda);
  const int buf = kChunk * (kWS ? lda : bn);
  const Halves<kFull> h(bm, bn);

  ATile<T, kVec> ta;   // WS streams a; IS stages its resident a with it
  BTile<T> tb;         // IS streams b; WS stages its resident b with it
  for (int c = 0; c < chunks; ++c) {
    const int kc = min(kChunk, bk - c * kChunk);
    if (kWS) {
      tb.load(b, N, k0 + c * kChunk, fixed, kc, bn);
      tb.store(res + c * kChunk * bn, kc, bn);
    } else {
      ta.load(a, K, fixed, k0 + c * kChunk, bm, kc);
      ta.store(res + c * kChunk * lda, lda, bm, kc);
    }
  }
  {
    const int kc = min(kChunk, bk);
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
    const int kcn = min(kChunk, bk - cn * kChunk);
    if (more) {  // the next chunk, into registers
      if (kWS)
        ta.load(a, K, sn * bm, k0 + cn * kChunk, bm, kcn);
      else
        tb.load(b, N, k0 + cn * kChunk, sn * bn, kcn, bn);
    }
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kFrag; ++i)
#pragma unroll
        for (int j = 0; j < kFrag; ++j) acc[i][j] = 0.f;
    }
    const int kc = min(kChunk, bk - c * kChunk);
    const float* cur = ring + (t & 1) * buf;
    if (kWS)
      spill_mma(cur, lda, res + c * kChunk * bn, bn, kc, h, acc);
    else
      spill_mma(res + c * kChunk * lda, lda, cur, bn, kc, h, acc);
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
constexpr int kBarBytes = 128;    // WS/IS: 2 * kMaxStages + 1 mbarriers

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
// Wait until at most N committed groups of this warpgroup are pending.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
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
      wgmma_wait<0>();
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

// ---------------------------------------------------------------------------
// OS / OS split-K, "simt" path: pipelined FFMA, the thread block sized to
// the tile
// ---------------------------------------------------------------------------

// The (kF x kF) register block of one thread: thread (ty, tx), tx <
// bn / kF, owns rows 4 ty + i and columns 4 tx + j (i, j < 4), and with
// kF = 8 also rows bm / 2 + 4 ty + i and columns bn / 2 + 4 tx + j. Every
// lane is inside the tile.
template <int kF>
struct OsLanes {
  int a[kF / 4], b[kF / 4];  // offsets into a row of sA[k][.] / sB[k][.]
  __device__ __forceinline__ OsLanes(int bm, int bn) {
    const int tpr = bn / kF;  // threads a row
    const int ty = threadIdx.x / tpr, tx = threadIdx.x % tpr;
    a[0] = 4 * ty;
    b[0] = 4 * tx;
    if constexpr (kF == 8) {
      a[1] = a[0] + bm / 2;
      b[1] = b[0] + bn / 2;
    }
  }
};

// This thread's kF + kF operands of one k: kF / 2 LDS.128.
template <int kF>
struct OsOperands {
  float4 a[kF / 4], b[kF / 4];
};

template <int kF>
__device__ __forceinline__ OsOperands<kF> os_load_k(const float* sA,
                                                    const float* sB,
                                                    const OsLanes<kF>& l) {
  OsOperands<kF> o;
#pragma unroll
  for (int h = 0; h < kF / 4; ++h) {
    o.a[h] = *reinterpret_cast<const float4*>(sA + l.a[h]);
    o.b[h] = *reinterpret_cast<const float4*>(sB + l.b[h]);
  }
  return o;
}

template <int kF>
__device__ __forceinline__ void os_fma_k(const OsOperands<kF>& o,
                                         float (&acc)[kF][kF]) {
  float av[kF], bv[kF];
#pragma unroll
  for (int h = 0; h < kF / 4; ++h) {
    av[4 * h] = o.a[h].x, av[4 * h + 1] = o.a[h].y;
    av[4 * h + 2] = o.a[h].z, av[4 * h + 3] = o.a[h].w;
    bv[4 * h] = o.b[h].x, bv[4 * h + 1] = o.b[h].y;
    bv[4 * h + 2] = o.b[h].z, bv[4 * h + 3] = o.b[h].w;
  }
#pragma unroll
  for (int i = 0; i < kF; ++i)
#pragma unroll
    for (int j = 0; j < kF; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// One k-chunk (kc <= 32 deep) of both operands, staged through registers
// in rounds of four quads a thread, each quad at a fixed stride from the
// thread's first, so no round needs a division. a: thread t < nt8 (nt
// rounded down to a multiple of 8) takes k-quad t % 8 of rows t / 8 +
// j rs, rs = nt8 / 8 (a warp reads four rows' 128-B runs), into sA[k][m]
// (transposed, pitch lda). b: thread t takes column quad t % (bn / 4) of
// k-rows t / (bn / 4) + j ks, ks = nt / (bn / 4) (exact: nt is a multiple
// of bn / 4), into sB[k][n] as it is. Rounds r < ra take a's quads j =
// 4 r + p, the rest b's quads j = 4 (r - ra) + p, p < 4.
template <typename T, bool kVec>
struct OsStage {
  quad_t<T> q[4];
  int row, c;  // this thread's first a row and a k offset (4 (t % 8))
  int k, cq;   // its first b k-row and b column offset
  int rs, ks;  // rows (k-rows) between its a (b) quads

  __device__ __forceinline__ OsStage(int bm, int bn, int nt) {
    const int t = threadIdx.x, nt8 = nt & ~7, nq = bn >> 2;
    rs = nt8 >> 3;
    row = t < nt8 ? t >> 3 : bm;  // threads past nt8 stage no a
    c = (t & 7) * 4;
    k = t / nq;
    cq = (t - k * nq) * 4;
    ks = nt / nq;
  }

  // round r of the chunk at k offset k0 (kc deep) into registers
  __device__ __forceinline__ void load(const T* __restrict__ a,
                                       const T* __restrict__ b, int64_t K,
                                       int64_t N, int64_t r0, int64_t c0,
                                       int64_t k0, int kc, int bm, int ra,
                                       int r) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (r < ra) {
        const int m = row + (4 * r + p) * rs;
        if (m < bm && c < kc) {
          const T* src = a + (r0 + m) * K + k0 + c;
          q[p] = kVec ? load_quad(src) : load_quad_scalar(src, kc - c);
        }
      } else {
        const int kk = k + (4 * (r - ra) + p) * ks;
        if (kk < kc) q[p] = load_quad(b + (k0 + kk) * N + c0 + cq);
      }
    }
  }

  // round r from the registers into the buffers sA / sB
  __device__ __forceinline__ void store(float* sA, int lda, float* sB,
                                        int bn, int kc, int bm, int ra,
                                        int r) const {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (r < ra) {
        const int m = row + (4 * r + p) * rs;
        if (m < bm && c < kc) {
          const float4 f = quad_float(q[p], Tag<T>{});
          float* d = sA + c * lda + m;
          d[0] = f.x;
          if (c + 1 < kc) d[lda] = f.y;
          if (c + 2 < kc) d[2 * lda] = f.z;
          if (c + 3 < kc) d[3 * lda] = f.w;
        }
      } else {
        const int kk = k + (4 * (r - ra) + p) * ks;
        if (kk < kc)
          *reinterpret_cast<float4*>(sB + kk * bn + cq) =
              quad_float(q[p], Tag<T>{});
      }
    }
  }
};

// four float32 values to out[0..4), in the output type
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  __half2 lo = __floats2half2_rn(v.x, v.y), hi = __floats2half2_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

template <typename O, int kF>
__device__ __forceinline__ void os_flush(O* __restrict__ out, int64_t N,
                                         int64_t r0, int64_t c0,
                                         const OsLanes<kF>& l,
                                         const float (&acc)[kF][kF]) {
#pragma unroll
  for (int i = 0; i < kF; ++i) {
    O* row = out + (r0 + l.a[i / 4] + (i & 3)) * N + c0;
#pragma unroll
    for (int h = 0; h < kF / 4; ++h)
      store4(row + l.b[h], make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                       acc[i][4 * h + 2], acc[i][4 * h + 3]));
  }
}

// The (bm x bn) output tile (blockIdx.y, blockIdx.x) over k in [z klen,
// (z + 1) klen), z = blockIdx.z, written at element z M N of out in the
// type out_type (0 float32, 1 bfloat16, 2 float16): os_gemm has one z and
// klen = K; split-K shard z writes its float32 slab. The k range is
// walked in 32-deep chunks, double-buffered: chunk c + 1 is staged in
// rounds (2 at 128 x 128, up to 4 at kF = 4, up to 5 otherwise), round s
// loaded at k = kGap s of chunk c and stored into the other buffer kGap
// k-steps later (the last round after the chunk), so the loads overlap
// the products and one __syncthreads per chunk suffices. kFull:
// bm = bn = 128, compile-time pitches and thread count. The register cap
// (128 at kF = 8: two blocks of 256 threads per SM; 64 at kF = 4) keeps
// the compiler from spending registers on loads hoisted further ahead,
// which would halve the blocks an SM holds.
template <typename T, int kF, bool kVec, bool kFull>
__global__ void __launch_bounds__(kThreads, kF == 8 ? 2 : 4)
    os_simt_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   void* __restrict__ out, int out_type, int64_t M,
                   int64_t K, int64_t N, int bm_rt, int bn_rt,
                   int64_t klen) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bm = kFull ? kMaxTile : bm_rt, bn = kFull ? kMaxTile : bn_rt;
  const int nt = kFull ? kThreads : bm * bn / (kF * kF);
  const int lda = bm + kPitchPad;
  const int buf = kChunk * (lda + bn);  // one buffer: sA, then sB
  const int64_t r0 = (int64_t)blockIdx.y * bm, c0 = (int64_t)blockIdx.x * bn;
  const int64_t k0 = (int64_t)blockIdx.z * klen;
  const int64_t chunks = (klen + kChunk - 1) / kChunk;
  // k-steps between staging slots: as many as the tile's rounds allow
  // (2 at 128 x 128, at most 4 at kF = 4, at most 5 otherwise)
  constexpr int kGap = kFull ? 16 : kF == 4 ? 8 : 4;

  OsStage<T, kVec> st(bm, bn, nt);
  const int quads_a = (bm + st.rs - 1) / st.rs;       // a thread's, at most
  const int quads_b = (kChunk + st.ks - 1) / st.ks;
  const int ra = (quads_a + 3) / 4, rounds = ra + (quads_b + 3) / 4;
  {
    const int kc = klen < kChunk ? (int)klen : kChunk;
    for (int r = 0; r < rounds; ++r) {
      st.load(a, b, K, N, r0, c0, k0, kc, bm, ra, r);
      st.store(smem, lda, smem + kChunk * lda, bn, kc, bm, ra, r);
    }
  }
  __syncthreads();

  const OsLanes<kF> l(bm, bn);
  float acc[kF][kF];
#pragma unroll
  for (int i = 0; i < kF; ++i)
#pragma unroll
    for (int j = 0; j < kF; ++j) acc[i][j] = 0.f;
  for (int64_t c = 0; c < chunks; ++c) {
    const float* sA = smem + (c & 1) * buf;
    const float* sB = sA + kChunk * lda;
    float* nA = smem + ((c + 1) & 1) * buf;
    float* nB = nA + kChunk * lda;
    const bool more = c + 1 < chunks;
    const int64_t kn0 = k0 + (c + 1) * kChunk;
    const int64_t left = klen - c * kChunk;  // k still to multiply
    const int kc = left < kChunk ? (int)left : kChunk;
    const int kcn = !more ? 0 : left - kChunk < kChunk ? (int)(left - kChunk)
                                                       : kChunk;
    if (kc == kChunk) {
      OsOperands<kF> cur = os_load_k(sA, sB, l);
      // slot s: round s - 1 out, round s in, then kGap k-steps. At a
      // runtime tile the slot loop stays rolled, so no round's addresses
      // are hoisted into registers across the chunks; at 128 x 128 its two
      // slots unroll with compile-time offsets.
#pragma unroll(kFull ? 2 : 1)
      for (int s = 0; s < kChunk / kGap; ++s) {
        if (more) {
          if (s >= 1 && s - 1 < rounds)
            st.store(nA, lda, nB, bn, kcn, bm, ra, s - 1);
          if (s < rounds) st.load(a, b, K, N, r0, c0, kn0, kcn, bm, ra, s);
        }
        const float* pA = sA + s * kGap * lda;
        const float* pB = sB + s * kGap * bn;
#pragma unroll
        for (int k = 0; k < kGap; ++k) {
          OsOperands<kF> nxt = cur;
          if (k + 1 < kGap || s + 1 < kChunk / kGap)
            nxt = os_load_k(pA + (k + 1) * lda, pB + (k + 1) * bn, l);
          os_fma_k(cur, acc);
          cur = nxt;
        }
      }
      if (more && rounds * kGap >= kChunk)
        st.store(nA, lda, nB, bn, kcn, bm, ra, rounds - 1);
    } else {  // a shorter chunk is the last one: nothing to stage
      for (int k = 0; k < kc; ++k)
        os_fma_k(os_load_k(sA + k * lda, sB + k * bn, l), acc);
    }
    __syncthreads();
  }
  const int64_t at = (int64_t)blockIdx.z * M * N;
  if (out_type == 0)
    os_flush(reinterpret_cast<float*>(out) + at, N, r0, c0, l, acc);
  else if (out_type == 1)
    os_flush(reinterpret_cast<__nv_bfloat16*>(out) + at, N, r0, c0, l, acc);
  else
    os_flush(reinterpret_cast<__half*>(out) + at, N, r0, c0, l, acc);
}

// ---------------------------------------------------------------------------
// OS / OS split-K, "wgmma" path: both operands through a TMA ring, the
// accumulator in registers across all k-chunks
// ---------------------------------------------------------------------------

constexpr int kOsMaxStages = 8;          // 2 * 8 mbarriers fill kBarBytes
constexpr int kOsRingBytes = 96 * 1024; // see os_wgmma_stages

// two float32 values to out[0..2), in the output type
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// A warpgroup's (64 x N) accumulator tile, at out (row length N_ld), from
// the m64nNk16 fragment: thread (warp w, lane l) holds rows 16 w + l / 4
// and + 8, columns 8 j + 2 (l % 4) + {0, 1}.
template <typename O, int R>
__device__ __forceinline__ void wg_flush(O* __restrict__ out, int64_t ld,
                                         const float (&d)[R]) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  O* p = out + (int64_t)(warp * 16 + lane / 4) * ld + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    store2(p + 8 * j, d[4 * j], d[4 * j + 1]);
    store2(p + 8 * ld + 8 * j, d[4 * j + 2], d[4 * j + 3]);
  }
}

// The (bm x kN) output tile (blockIdx.y, blockIdx.x) over `chunks`
// k-chunks of kKC from k = z chunks kKC, z = blockIdx.z, written at
// element z M N of out in the type out_type (as os_simt_kernel). Stage s
// of the ring holds chunk c's a tile (bm rows x kKC * 2 B, K-major) and
// b tile (kN / 64 column atoms of kKC rows x 128 B); the producer warp
// refills a stage once every consumer has released it. Each consumer
// warpgroup issues chunk c's kKC / 16 products, then waits until only
// that group is pending (wait_group 1), so chunk c - 1's stage is free
// and is released while chunk c runs.
template <typename T, int kN, int kKC>
__global__ void __launch_bounds__(2 * kWgThreads + 32)
    os_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    void* __restrict__ out, int out_type, int M, int N,
                    int bm, int chunks, int stages) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kRow = kKC * 2;  // bytes of one a row in a chunk
  constexpr uint32_t kModeA = kKC == 64 ? 1 : 3;
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int consumers = bm / 64 * kWgThreads;
  const int a_bytes = bm * kRow;
  const int stage_bytes = a_bytes + kN * kRow;
  const int r0 = blockIdx.y * bm, c0 = blockIdx.x * kN;
  const int kbeg = blockIdx.z * chunks * kKC;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + stages * stage_bytes);
  uint64_t* empty = full + kOsMaxStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {  // the producer warp; one thread issues
    if (threadIdx.x != consumers) return;
    int s = 0;
    uint32_t phase = 0;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&empty[s], phase ^ 1);
      mbar_expect_tx(&full[s], stage_bytes);
      uint8_t* dst = base + s * stage_bytes;
      const int k = kbeg + c * kKC;
      tma_load(dst, &map_a, &full[s], k, r0);
      for (int j = 0; j < kN / 64; ++j)
        tma_load(dst + a_bytes + j * kKC * 128, &map_b, &full[s],
                 c0 + 64 * j, k);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / kWgThreads;
  float d[kN / 2];
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int c = 0; c < chunks; ++c) {
    mbar_wait(&full[s], phase);
    const uint8_t* ta = base + s * stage_bytes + wg * 64 * kRow;
    const uint8_t* tb = base + s * stage_bytes + a_bytes;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKC / 16; ++k) {
      const uint64_t da = smem_desc(ta + k * 32, 16, 8 * kRow, kModeA);
      const uint64_t db = smem_desc(tb + k * 16 * 128, kKC * 128, 1024, 1);
      wgmma_64xN(d, da, db, c > 0 || k > 0, Tag<T>{});
    }
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1's products are done
    fence_acc(d);
    if (c > 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  const int64_t at = (int64_t)blockIdx.z * M * N +
                     (int64_t)(r0 + wg * 64) * N + c0;
  if (out_type == 0)
    wg_flush(reinterpret_cast<float*>(out) + at, N, d);
  else if (out_type == 1)
    wg_flush(reinterpret_cast<__nv_bfloat16*>(out) + at, N, d);
  else
    wg_flush(reinterpret_cast<__half*>(out) + at, N, d);
}

template <typename F> bool with_type(int code, F&& f) {
  switch (code) {
    case 0: f(Tag<float>{}); return true;
    case 1: f(Tag<__nv_bfloat16>{}); return true;
    case 2: f(Tag<__half>{}); return true;
    default: return false;
  }
}

// The simt path's shared memory for an OS tile: two buffers of a 32-deep
// chunk of both operands, whatever bk. It is the footprint that decides
// the accepted OS tiles (every bm, bn, any bk); the wgmma ring
// (os_wgmma_smem) is as independent of bk. Mirrored by ops.smem_bytes.
size_t os_smem(int bm, int bn) {
  return sizeof(float) * 2 * kChunk * ((size_t)bm + kPitchPad + bn);
}

// The register block side of the OS simt kernel: 4 while (bm / 4)(bn / 4)
// threads are at most 256, else 8 ((bm / 8)(bn / 8) threads, 80 to 256).
// Either way no lane idles, and a thread does at least 8 FFMA per LDS.128.
int os_frag(int bm, int bn) { return bm * bn <= 16 * kThreads ? 4 : 8; }

// The simt path's shared memory for a WS (ws) or IS tile; it is also the
// footprint that decides which tiles are accepted, on both paths. Mirrored
// by ops.smem_bytes.
size_t spill_smem(bool ws, int bm, int bk, int bn) {
  const size_t lda = (size_t)bm + kPitchPad;
  return sizeof(float) * (ws ? (size_t)bk * bn + 2 * kChunk * lda
                             : (size_t)bk * lda + 2 * kChunk * (size_t)bn);
}

// The path of a call at any of the four sites: 1 ("wgmma") for 16-bit
// operands at bm, bn in {64, 128} and bk % 16 == 0, else 0 ("simt").
// Mirrored by ops.kernel_path.
int path_of(int in_type, int bm, int bk, int bn) {
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
// for every tile path_of routes to wgmma.
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

int os_wgmma_stage(int bm, int bk, int bn) {
  return 2 * wgmma_kc(bk) * (bm + bn);
}

// OS ring stages: as many as 96 KB hold, up to 8. At 128 x 128, KC = 64
// that is 3 stages of 32 KB, so a block takes 99,456 B and two blocks fit
// on one SM (228 KB): the grid is not persistent, and the second block
// is what overlaps one tile's epilogue with another tile's loads. Small
// stages (KC = 16, or 64 x 64) get more of them, up to the 8 whose
// barriers kBarBytes holds.
int os_wgmma_stages(int bm, int bk, int bn) {
  const int n = kOsRingBytes / os_wgmma_stage(bm, bk, bn);
  return n < kOsMaxStages ? n : kOsMaxStages;
}

size_t os_wgmma_smem(int bm, int bk, int bn) {
  return (size_t)(kAlignSlack + kBarBytes +
                  os_wgmma_stages(bm, bk, bn) * os_wgmma_stage(bm, bk, bn));
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

// f(N, KC) with N = bn and KC = kc as std::integral_constant, for the
// (bn, kc) pairs the wgmma kernels are compiled for: bn in {64, 128}, kc
// in {16, 64}.
template <typename F> void with_n_kc(int bn, int kc, F&& f) {
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I16 = std::integral_constant<int, 16>;
  if (bn == 64 && kc == 64)
    f(I64{}, I64{});
  else if (bn == 64)
    f(I64{}, I16{});
  else if (kc == 64)
    f(I128{}, I64{});
  else
    f(I128{}, I16{});
}

template <typename T> void allow_wgmma(int bytes) {
  for (int bn : {64, 128})
    for (int kc : {16, 64})
      with_n_kc(bn, kc, [&](auto n, auto k) {
        constexpr int kN = decltype(n)::value, kKC = decltype(k)::value;
        allow_smem(spill_wgmma_kernel<T, true, kN, kKC>, bytes);
        allow_smem(spill_wgmma_kernel<T, false, kN, kKC>, bytes);
        allow_smem(os_wgmma_kernel<T, kN, kKC>, bytes);
      });
}

template <typename T> void allow_os(int bytes) {
  allow_smem(os_simt_kernel<T, 4, false, false>, bytes);
  allow_smem(os_simt_kernel<T, 4, true, false>, bytes);
  allow_smem(os_simt_kernel<T, 8, false, false>, bytes);
  allow_smem(os_simt_kernel<T, 8, true, false>, bytes);
  allow_smem(os_simt_kernel<T, 8, false, true>, bytes);
  allow_smem(os_simt_kernel<T, 8, true, true>, bytes);
}

// The tensor maps of both wgmma kernels: a (M x K) in (bm x kc) boxes
// (128-B swizzle at kc = 64, else 32-B) and b (K x N) in (kc x 64)
// column atoms (128-B swizzle). False for operands TMA cannot take.
template <typename T>
bool operand_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                  const void* b, int64_t M, int64_t K, int64_t N, int bm,
                  int kc) {
  if (g_encode == nullptr || M > INT32_MAX || K > INT32_MAX ||
      N > INT32_MAX || ((uintptr_t)a | (uintptr_t)b) % 16)
    return false;
  return make_map(ma, tma_type(Tag<T>{}), a, M, K, bm, kc,
                  kc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_32B) &&
         make_map(mb, tma_type(Tag<T>{}), b, K, N, kc, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// The wgmma path of WS (kWS) / IS for 16-bit T.
template <typename T, bool kWS>
int spill_wgmma(const void* a, const void* b, float* slabs, int64_t M,
                int64_t K, int64_t N, int bm, int bk, int bn,
                cudaStream_t stream) {
  const int kc = wgmma_kc(bk), stages = wgmma_stages(kWS, bm, bk, bn);
  CUtensorMap ma, mb;
  if (stages < 2 || !operand_maps<T>(&ma, &mb, a, b, M, K, N, bm, kc))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(kWS ? N / bn : M / bm), (unsigned)(K / bk));
  const size_t smem = wgmma_smem(kWS, bm, bk, bn, stages);
  with_n_kc(bn, kc, [&](auto n, auto k) {
    spill_wgmma_kernel<T, kWS, decltype(n)::value, decltype(k)::value>
        <<<grid, bm / 64 * kWgThreads + 32, smem, stream>>>(
            ma, mb, slabs, (int)M, (int)N, bm, bk, stages);
  });
  return (int)cudaGetLastError();
}

// WS (kWS) / IS on the path the caller names; a path that path_of does
// not give for this dtype and tile is refused.
template <bool kWS>
int spill_launch(const void* a, const void* b, void* slabs, int64_t M,
                 int64_t K, int64_t N, int bm, int bk, int bn, int in_type,
                 int path, void* stream) {
  const size_t smem = spill_smem(kWS, bm, bk, bn);
  if (!args_ok(M, K, N, bm, bk, bn, smem) || K / bk > 65535 ||
      in_type < 0 || in_type > 2 || path != path_of(in_type, bm, bk, bn))
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

// The wgmma path of OS / split-K for 16-bit T: `splits` shards of nk
// k-blocks each.
template <typename T>
int os_wgmma(const void* a, const void* b, void* out, int out_type,
             int64_t M, int64_t K, int64_t N, int splits, int64_t nk, int bm,
             int bk, int bn, cudaStream_t stream) {
  const int kc = wgmma_kc(bk);
  CUtensorMap ma, mb;
  if (!operand_maps<T>(&ma, &mb, a, b, M, K, N, bm, kc))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(N / bn), (unsigned)(M / bm), (unsigned)splits);
  const int chunks = (int)(nk * bk / kc), stages = os_wgmma_stages(bm, bk, bn);
  const size_t smem = os_wgmma_smem(bm, bk, bn);
  with_n_kc(bn, kc, [&](auto n, auto k) {
    os_wgmma_kernel<T, decltype(n)::value, decltype(k)::value>
        <<<grid, bm / 64 * kWgThreads + 32, smem, stream>>>(
            ma, mb, out, out_type, (int)M, (int)N, bm, chunks, stages);
  });
  return (int)cudaGetLastError();
}

// The simt path of OS / split-K.
template <typename T>
void os_simt(const void* a, const void* b, void* out, int out_type,
             int64_t M, int64_t K, int64_t N, int splits, int64_t nk, int bm,
             int bk, int bn, cudaStream_t stream) {
  const int f = os_frag(bm, bn);
  const bool full = bm == kMaxTile && bn == kMaxTile, vec = bk % 4 == 0;
  auto kern = f == 4 ? (vec ? os_simt_kernel<T, 4, true, false>
                            : os_simt_kernel<T, 4, false, false>)
              : full ? (vec ? os_simt_kernel<T, 8, true, true>
                            : os_simt_kernel<T, 8, false, true>)
                     : (vec ? os_simt_kernel<T, 8, true, false>
                            : os_simt_kernel<T, 8, false, false>);
  const dim3 grid((unsigned)(N / bn), (unsigned)(M / bm), (unsigned)splits);
  kern<<<grid, bm * bn / (f * f), os_smem(bm, bn), stream>>>(
      (const T*)a, (const T*)b, out, out_type, M, K, N, bm, bn, nk * bk);
}

// OS (splits = 1, out_type as asked) and split-K (float32 slabs) on the
// path the caller names; a path that path_of does not give for this
// dtype and tile is refused.
int os_launch(const void* a, const void* b, void* out, int64_t M, int64_t K,
              int64_t N, int splits, int bm, int bk, int bn, int in_type,
              int out_type, int path, void* stream) {
  if (in_type < 0 || in_type > 2 || out_type < 0 || out_type > 2 ||
      path != path_of(in_type, bm, bk, bn))  // path 1: bm, bn in {64, 128}
    return (int)cudaErrorInvalidValue;
  const size_t smem = path == 1 ? os_wgmma_smem(bm, bk, bn) : os_smem(bm, bn);
  if (!args_ok(M, K, N, bm, bk, bn, smem) || M / bm > 65535 || splits < 1 ||
      splits > 65535 || K % ((int64_t)splits * bk))
    return (int)cudaErrorInvalidValue;
  const int64_t nk = K / bk / splits;
  const cudaStream_t st = (cudaStream_t)stream;
  if (path == 1)
    return in_type == 1 ? os_wgmma<__nv_bfloat16>(a, b, out, out_type, M, K,
                                                  N, splits, nk, bm, bk, bn,
                                                  st)
                        : os_wgmma<__half>(a, b, out, out_type, M, K, N,
                                           splits, nk, bm, bk, bn, st);
  with_type(in_type, [&](auto in) {
    using T = typename decltype(in)::type;
    os_simt<T>(a, b, out, out_type, M, K, N, splits, nk, bm, bk, bn, st);
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
      allow_os<T>(g_smem_limit);
      allow_simt<T, true>(g_smem_limit);
      allow_simt<T, false>(g_smem_limit);
    });
  }
  allow_wgmma<__nv_bfloat16>(g_smem_limit);
  allow_wgmma<__half>(g_smem_limit);
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

// path: 0 "simt", 1 "wgmma" (ops.kernel_path), at all four sites
extern "C" int os_gemm_launch(const void* a, const void* b, void* out,
                              int64_t M, int64_t K, int64_t N, int bm, int bk,
                              int bn, int in_type, int out_type, int path,
                              void* stream) {
  return os_launch(a, b, out, M, K, N, 1, bm, bk, bn, in_type, out_type, path,
                   stream);
}

extern "C" int os_gemm_splitk_launch(const void* a, const void* b,
                                     void* slabs, int64_t M, int64_t K,
                                     int64_t N, int splits, int bm, int bk,
                                     int bn, int in_type, int path,
                                     void* stream) {
  return os_launch(a, b, slabs, M, K, N, splits, bm, bk, bn, in_type, 0, path,
                   stream);
}

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
