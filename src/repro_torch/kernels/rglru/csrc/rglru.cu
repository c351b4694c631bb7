// rglru: the RG-LRU gated linear recurrence with a state in and out, for
// Hopper.
//
// Replaces the Pallas TPU kernel ``_rglru_kernel`` launched by
// ``rglru_pallas`` in src/repro/kernels/rglru/kernel.py, and computes the
// function the serving path needs, the model's ``_assoc_scan`` with a
// start state (src/repro/models/rglru.py): per batch row and channel c,
//   h_t[c] = a_t[c] * h_{t-1}[c] + b_t[c]        for t = 0 .. T-1,
// from h_{-1} = h0 (zeros when h0 is null), writing h [B,T,C] and, when
// h_out is not null, the final state h_out [B,C]. Any T >= 1 and C >= 1
// work, with no padding: T = 1 is one decode step. h_out may alias h0 (an
// in-place cache update): each thread reads its h0 entry before the loop
// and writes its h_out entry after, and no thread touches another's.
//
// Rounding: the product and then the sum are rounded (__fmul_rn, then
// __fadd_rn, which the compiler does not contract into an FMA), as the
// plain torch version rounds them, so the two are bitwise equal.
//
// What bounds it: the bytes. At prefill (B = 4, T = 3072, C = 4096) it
// reads a and b and writes h once, 604 MB, 0.180 ms at 3.35 TB/s, against
// two flops per element (1.5 us at 67 TFLOP/s); at decode (T = 1) the
// launch. The recurrence is sequential in t, so the parallelism is the
// B*C channels: 16,384 threads at prefill, about four warps per SM. The
// TPU kernel held the carry in VMEM across a sequential time grid; here
// the time loop runs inside the thread, which keeps h in a register.
//
// Design: one thread per (b, c), threads of a block on neighbouring c, so
// every load and store of a warp is one coalesced 128-byte line; 128
// threads a block, so the prefill's 128 blocks spread over the SMs. The
// loads of a and b do not depend on h: the thread loads the next kUnroll
// steps of a and b while it steps through the current ones, which keeps
// 2 * kUnroll loads in flight per thread to cover the memory latency with
// so few warps. A chunked two-pass scan, for more parallelism over T, is
// later work.
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers and the current stream, has validated float32 dtypes,
// contiguity and shapes, and allocates the outputs. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty shape or a
// batch above the grid's y limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads (channels) per block
constexpr int kUnroll = 32;     // time steps loaded ahead

__device__ __forceinline__ void load_steps(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int64_t off, int64_t stride,
                                           int n, float (&av)[kUnroll],
                                           float (&bv)[kUnroll]) {
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    if (i < n) {
      av[i] = a[off + i * stride];
      bv[i] = b[off + i * stride];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* h0, float* __restrict__ h, float* h_out, int T,
             int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t row = blockIdx.y;
  const int64_t stride = C;
  int64_t off = row * T * stride + c;
  float hv = (h0 != nullptr) ? h0[row * stride + c] : 0.f;

  float an[kUnroll], bn[kUnroll];
  load_steps(a, b, off, stride, min(kUnroll, T), an, bn);
  for (int t0 = 0; t0 < T; t0 += kUnroll) {
    const int n = min(kUnroll, T - t0);
    float ac[kUnroll], bc[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ac[i] = an[i];
      bc[i] = bn[i];
    }
    const int64_t next = off + kUnroll * stride;
    if (t0 + kUnroll < T)                   // the next steps, in flight
      load_steps(a, b, next, stride, min(kUnroll, T - t0 - kUnroll), an,
                 bn);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (i < n) {
        hv = __fadd_rn(__fmul_rn(ac[i], hv), bc[i]);
        h[off + i * stride] = hv;
      }
    }
    off = next;
  }
  if (h_out != nullptr) h_out[row * stride + c] = hv;
}

}  // namespace

extern "C" int rglru_launch(const void* a, const void* b, const void* h0,
                            void* h, void* h_out, int B, int T, int C,
                            void* stream) {
  if (B < 1 || T < 1 || C < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  rglru_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h,
      (float*)h_out, T, C);
  return (int)cudaGetLastError();
}
