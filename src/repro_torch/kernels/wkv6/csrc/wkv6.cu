// wkv6: the RWKV-6 (Finch) WKV recurrence with a state in and out, for
// Hopper.
//
// Replaces the Pallas TPU kernel ``_wkv6_kernel`` launched by
// ``wkv6_pallas`` in src/repro/kernels/wkv6/kernel.py, and computes the
// function the serving path needs, the model's ``wkv_scan``
// (src/repro/models/rwkv6.py): per row g of G = batch x heads,
//   kv_t    = k_t v_t^T                              (D x D)
//   y_t[v]  = sum_k r_t[k] * (S[k,v] + u[k] * kv_t[k,v])
//   S[k,v] <- w_t[k] * S[k,v] + kv_t[k,v]
// for t = 0 .. T-1, from S = s0[g] (zeros when s0 is null), writing
// y [G,T,D] and the final state s_out[g] [D,D] (indexed [k,v]). Any
// T >= 1 works, T = 1 being one decode step. u is read as row g % u_rows,
// so a per-head u [H,D] serves rows g = b*H + h with no copy. s_out may
// alias s0 (an in-place cache update): each thread reads its state column
// before the loop and writes it after, and no thread touches another's.
//
// What bounds it: at prefill (G = 160, T = 512, D = 64) the bytes: about
// 0.032 ms for r,k,v,w,y and the final state at 3.35 TB/s, against
// 5*D*D + 5*D flops per (g,t) (the readout sum_k r_k S[k,v] plus the bonus
// v_v * sum_k r_k u_k k_k, and the update w*S + k v^T), 1.70 GFLOP or
// about 0.025 ms at the 67 TFLOP/s fp32 rate; at decode (T = 1) the
// state's bytes in and out. This simple design is
// far from that: each step's 64-term readout is one dependent chain of
// FMAs, and a block holds two warps.
//
// Design: one block per row g, one thread per value column v, D threads.
// The thread keeps its state column S[:,v] (D floats) in registers for
// the whole sequence. The TPU kernel held the D x D state in VMEM across
// a sequential time grid; here the time loop is inside the block. Time
// comes in chunks of CT steps: the block stages r, k, v, w of the chunk
// in shared memory with coalesced loads (4*CT independent loads per
// thread), then each thread steps through the chunk, reading r_t, k_t,
// w_t and u as broadcasts and its own v_t[v], and looping over k in the
// plain version's order. y_t[v] is stored at once, coalesced across the
// block.
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers and the current stream, has validated float32 dtypes,
// contiguity, shapes and D, and allocates the outputs. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;

template <int D, int CT>
__global__ void __launch_bounds__(D)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, int u_rows, const float* s0,
            float* __restrict__ y, float* s_out, int T) {
  __shared__ __align__(16) float sr[CT][D];
  __shared__ __align__(16) float sk[CT][D];
  __shared__ __align__(16) float sv[CT][D];
  __shared__ __align__(16) float sw[CT][D];
  __shared__ __align__(16) float su[D];

  const int g = blockIdx.x;
  const int j = threadIdx.x;               // the value column v of this thread
  const int64_t base = (int64_t)g * T * D;
  const int64_t sbase = (int64_t)g * D * D;

  float s[D];                               // S[:, j], in registers
  if (s0 != nullptr) {
#pragma unroll
    for (int q = 0; q < D; ++q) s[q] = s0[sbase + q * D + j];
  } else {
#pragma unroll
    for (int q = 0; q < D; ++q) s[q] = 0.f;
  }
  su[j] = u[(int64_t)(g % u_rows) * D + j];

  for (int t0 = 0; t0 < T; t0 += CT) {
    const int n = min(CT, T - t0);
    __syncthreads();                        // previous chunk consumed
    for (int i = 0; i < n; ++i) {
      const int64_t off = base + (int64_t)(t0 + i) * D + j;
      sr[i][j] = r[off];
      sk[i][j] = k[off];
      sv[i][j] = v[off];
      sw[i][j] = w[off];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float vj = sv[i][j];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < D; ++q) {
        const float kv = sk[i][q] * vj;
        acc += sr[i][q] * (s[q] + su[q] * kv);
        s[q] = sw[i][q] * s[q] + kv;
      }
      y[base + (int64_t)(t0 + i) * D + j] = acc;
    }
  }

#pragma unroll
  for (int q = 0; q < D; ++q) s_out[sbase + q * D + j] = s[q];
}

}  // namespace

extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, int u_rows,
                           const void* s0, void* y, void* s_out, int G,
                           int T, int D, void* stream) {
  if (D != 64) return (int)cudaErrorInvalidValue;
  wkv6_kernel<64, kChunk><<<G, 64, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, u_rows, (const float*)s0, (float*)y, (float*)s_out,
      T);
  return (int)cudaGetLastError();
}
