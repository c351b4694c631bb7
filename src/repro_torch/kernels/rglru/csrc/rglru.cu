// rglru: the RG-LRU gated linear recurrence with a state in and out, for
// Hopper.
//
// Replaces the Pallas TPU kernel ``_rglru_kernel`` launched by
// ``rglru_pallas`` in src/repro/kernels/rglru/kernel.py, and computes the
// function the serving path needs, the model's ``_assoc_scan`` with a
// start state (src/repro/models/rglru.py): per batch row and channel c,
//   h_t[c] = a_t[c] * h_{t-1}[c] + b_t[c]        for t = 0 .. T-1,
// from h_{-1} = h0 (zeros when h0 is null), writing h [B,T,C] and, when
// h_out is not null, the final state h_out [B,C]. Any T >= 1, C >= 1 and
// B <= 65535 work, with no padding. h_out may alias h0 (the decode cache's
// in-place update): every state element is read, before its chain, and
// written, after it, by one thread only.
//
// Rounding: the product and then the sum are rounded (__fmul_rn, then
// __fadd_rn, which the compiler does not contract into an FMA), in time
// order from h0, as the plain torch version rounds them, so the two are
// bitwise equal. That is why the chain stays sequential in t: a chunked
// two-pass or associative scan would find more parallelism over T, but
// it re-associates the products, changes the rounding and breaks the
// bitwise check.
//
// What bounds it: the bytes. At prefill (B = 4, T = 3072, C = 4096) it
// reads a and b and writes h once, 604 MB, 0.180 ms at 3.35 TB/s, against
// two flops per element (1.5 us at 67 TFLOP/s); the dependent chain is
// 3,072 multiply-add pairs, ~12 us. The parallelism is the B*C chains
// (16,384 at prefill), so each chain must keep many steps of loads in
// flight: 3.35 TB/s over ~1 us of loaded latency is ~25 KB a SM. At decode
// (T = 1) the launch and one round trip to memory bound it; at short T
// (a few stages) the chain's latency with one or two warps a SM.
//
// Two kernels, chosen by the launcher:
// - rglru_ring_kernel (T >= 2). Two warps a block, a thread a channel:
//   block (x, row) owns channels 64x .. 64x+63 of batch row `row`, so the
//   prefill runs 256 blocks, ~1.9 a SM, all resident. Loads of a and b go
//   through a ring of kStages = 3 stages in shared memory, each a [kTC =
//   32 steps x 64 channels] tile of both arrays, filled by cp.async while
//   the threads step through an earlier stage: two stages (32 KB) in
//   flight a block, ~62 KB a SM (the register double buffer it replaces
//   kept one 32-step chunk, <= 32 KB a SM). A thread reads its stage into
//   registers, then runs the chain and writes h at every step, 128
//   coalesced bytes a warp. 48 KB of static shared memory a block.
//   cp.async rather than TMA: it needs no tensor map encoded on the host
//   at each of the serving path's launches (832 a serve_hybrid run), and
//   one loop serves both copy widths, 16 bytes a thread (16 threads a
//   256-byte row, when C % 4 == 0 and a, b start on 16 bytes) and 4 bytes
//   (any other C or base), chosen by the launcher.
// - rglru_step_kernel (T = 1, one decode step). An elementwise update over
//   the B*C flat elements, four a thread as float4 loads and stores when
//   every pointer starts on 16 bytes (else one a thread), kStepThreads a
//   block: one load of a, b and h0 and one store of h and h_out each, with
//   no ring, no barrier and no loop.
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers and the current stream, has validated float32 dtypes,
// contiguity and shapes, and allocates the outputs. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty shape or a
// batch above the grid's y limit. rglru_geometry reports the launch that
// rglru_launch would make for the same arguments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCB = 64;            // channels (threads) per block
constexpr int kTC = 32;            // time steps per stage
constexpr int kStages = 3;         // stages in the ring
constexpr int kStepThreads = 128;  // threads a block of the one-step kernel

struct __align__(16) Ring {
  float a[kStages][kTC][kCB];
  float b[kStages][kTC][kCB];
};
static_assert(sizeof(Ring) <= 48 * 1024, "static shared memory");
static_assert(kCB % 32 == 0 && kTC % 4 == 0, "whole warps, whole passes");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// Start the copies of the n steps of one stage (n <= kTC) of channels
// c0 .. c0+cw-1 into ring slot `slot`; `off` is the offset of (row, t0,
// c0). With 16-byte copies, thread l copies columns 4 (l % kQ) .. +3 of
// rows l / kQ, l / kQ + 4, ...: kQ threads a row, 4 rows a pass.
template <bool kVec>
__device__ __forceinline__ void load_stage(Ring& ring, int slot,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int64_t off, int C, int cw,
                                           int n) {
  const int tid = threadIdx.x;
  if (kVec) {
    constexpr int kQ = kCB / 4;            // 16-byte pieces a row
    constexpr int kRows = kCB / kQ;        // rows a pass: 4
    const int q = 4 * (tid % kQ), i0 = tid / kQ;
    if (q >= cw) return;
    const int64_t pass = (int64_t)kRows * C;
    const float* pa = a + off + (int64_t)i0 * C + q;
    const float* pb = b + off + (int64_t)i0 * C + q;
#pragma unroll
    for (int k = 0; k < kTC / kRows; ++k) {
      const int i = i0 + k * kRows;
      if (i < n) {
        cp_async16(&ring.a[slot][i][q], pa);
        cp_async16(&ring.b[slot][i][q], pb);
      }
      pa += pass;
      pb += pass;
    }
  } else if (tid < cw) {                  // 4 bytes a thread, a channel
    const float* pa = a + off + tid;
    const float* pb = b + off + tid;
    for (int i = 0; i < n; ++i, pa += C, pb += C) {
      cp_async4(&ring.a[slot][i][tid], pa);
      cp_async4(&ring.b[slot][i][tid], pb);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kCB)
rglru_ring_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* h0, float* __restrict__ h, float* h_out,
                  int T, int C) {
  __shared__ Ring ring;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCB;
  const int cw = min(kCB, C - c0);
  const bool live = tid < cw;
  const int64_t row = blockIdx.y;
  const int64_t base = row * T * C + c0;   // (row, 0, c0)
  const int64_t stage_stride = (int64_t)kTC * C;
  const int stages = (T + kTC - 1) / kTC;
  float hv = (live && h0 != nullptr) ? h0[row * C + c0 + tid] : 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages)
      load_stage<kVec>(ring, s, a, b, base + s * stage_stride, C, cw,
                       min(kTC, T - s * kTC));
    cp_async_commit();
  }
  float* hp = h + base + tid;
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s landed
    __syncthreads();               // every thread's, and stage s-1 is read
    const int next = s + kStages - 1;
    if (next < stages)
      load_stage<kVec>(ring, next % kStages, a, b,
                       base + next * stage_stride, C, cw,
                       min(kTC, T - next * kTC));
    cp_async_commit();
    const int slot = s % kStages;
    const int n = min(kTC, T - s * kTC);
    if (live) {
      if (n == kTC) {              // the stage into registers, then the chain
        float av[kTC], bv[kTC];
#pragma unroll
        for (int i = 0; i < kTC; ++i) {
          av[i] = ring.a[slot][i][tid];
          bv[i] = ring.b[slot][i][tid];
        }
#pragma unroll
        for (int i = 0; i < kTC; ++i) {
          hv = step(av[i], hv, bv[i]);
          hp[(int64_t)i * C] = hv;
        }
      } else {
        for (int i = 0; i < n; ++i) {
          hv = step(ring.a[slot][i][tid], hv, ring.b[slot][i][tid]);
          hp[(int64_t)i * C] = hv;
        }
      }
    }
    hp += stage_stride;
  }
  if (live && h_out != nullptr) h_out[row * C + c0 + tid] = hv;
}

template <bool kVec, int kThreads>
__global__ void __launch_bounds__(kThreads)
rglru_step_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* h0, float* __restrict__ h, float* h_out,
                  int64_t n) {
  constexpr int kW = kVec ? 4 : 1;
  const int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kW;
  if (i >= n) return;
  if (kVec && i + 4 <= n) {
    const float4 av = *reinterpret_cast<const float4*>(a + i);
    const float4 bv = *reinterpret_cast<const float4*>(b + i);
    float4 hv = h0 != nullptr ? *reinterpret_cast<const float4*>(h0 + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    hv.x = step(av.x, hv.x, bv.x);
    hv.y = step(av.y, hv.y, bv.y);
    hv.z = step(av.z, hv.z, bv.z);
    hv.w = step(av.w, hv.w, bv.w);
    *reinterpret_cast<float4*>(h + i) = hv;
    if (h_out != nullptr) *reinterpret_cast<float4*>(h_out + i) = hv;
    return;
  }
  for (int64_t j = i; j < n && j < i + kW; ++j) {   // scalar, or the tail
    const float hv = step(a[j], h0 != nullptr ? h0[j] : 0.f, b[j]);
    h[j] = hv;
    if (h_out != nullptr) h_out[j] = hv;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The launch rglru_launch makes: kernel (0 ring, 1 step), the copy width
// (1: 16 bytes, 0: 4 bytes), grid and block.
struct Plan {
  int kernel, vec;
  dim3 grid;
  int threads;
};

Plan plan(const void* a, const void* b, const void* h0, const void* h,
          const void* h_out, int B, int T, int C) {
  Plan p{};
  if (T == 1) {
    const int64_t n = (int64_t)B * C;
    p.kernel = 1;
    p.vec = aligned16(a) && aligned16(b) && aligned16(h) &&
            (h0 == nullptr || aligned16(h0)) &&
            (h_out == nullptr || aligned16(h_out));
    const int64_t per_block = (int64_t)kStepThreads * (p.vec ? 4 : 1);
    p.grid = dim3((unsigned)((n + per_block - 1) / per_block));
    p.threads = kStepThreads;
  } else {
    p.kernel = 0;
    p.vec = C % 4 == 0 && aligned16(a) && aligned16(b);
    p.grid = dim3((C + kCB - 1) / kCB, B);
    p.threads = kCB;
  }
  return p;
}

}  // namespace

extern "C" int rglru_launch(const void* a, const void* b, const void* h0,
                            void* h, void* h_out, int B, int T, int C,
                            void* stream) {
  if (B < 1 || T < 1 || C < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(a, b, h0, h, h_out, B, T, C);
  const cudaStream_t s = (cudaStream_t)stream;
  const float *fa = (const float*)a, *fb = (const float*)b,
              *f0 = (const float*)h0;
  float *fh = (float*)h, *fo = (float*)h_out;
  if (p.kernel == 1) {
    const int64_t n = (int64_t)B * C;
    if (p.vec)
      rglru_step_kernel<true, kStepThreads>
          <<<p.grid, p.threads, 0, s>>>(fa, fb, f0, fh, fo, n);
    else
      rglru_step_kernel<false, kStepThreads>
          <<<p.grid, p.threads, 0, s>>>(fa, fb, f0, fh, fo, n);
  } else if (p.vec) {
    rglru_ring_kernel<true><<<p.grid, p.threads, 0, s>>>(fa, fb, f0, fh, fo,
                                                        T, C);
  } else {
    rglru_ring_kernel<false><<<p.grid, p.threads, 0, s>>>(fa, fb, f0, fh,
                                                         fo, T, C);
  }
  return (int)cudaGetLastError();
}

// out[8]: kernel (0 ring, 1 step), vec (1: 16-byte copies, or float4 for
// the step kernel), grid x, grid y, threads a block, static shared bytes
// a block, steps a stage, stages.
extern "C" void rglru_geometry(const void* a, const void* b, const void* h0,
                               const void* h, const void* h_out, int B,
                               int T, int C, int* out) {
  const Plan p = plan(a, b, h0, h, h_out, B, T, C);
  out[0] = p.kernel;
  out[1] = p.vec;
  out[2] = (int)p.grid.x;
  out[3] = (int)p.grid.y;
  out[4] = p.threads;
  out[5] = p.kernel == 0 ? (int)sizeof(Ring) : 0;
  out[6] = p.kernel == 0 ? kTC : 1;
  out[7] = p.kernel == 0 ? kStages : 0;
}
