// prefix_select: the fused prefix-table gather -> split-K select ->
// per-system segment reduction of the tempering evaluator, for Hopper.
//
// Replaces the Pallas TPU kernel ``_select_kernel`` launched by
// ``prefix_select`` in src/repro/kernels/prefix_gather/kernel.py.
//
// What it computes, per system p, sim metric f < F and chiplet slot c < C:
//   s0, e0 = clip(start[p,c], 0, t0[p]), clip(end[p,c], 0, t0[p])
//   s1, e1 = clip(start[p,c], 0, t1[p]), clip(end[p,c], 0, t1[p])
//   sel[p,c,f] = split[p] == 1 ? pref1[f,r,e1] - pref1[f,r,s1]
//                              : pref0[f,r,e0] - pref0[f,r,s0]
//   total[p,f] = sum over c of sel[p,c,f], in slot order
// with r = rows[p,c]. The tables are int64 prefix sums [F, R, T+1]; the
// rows already carry any workload-stack offset, so the same kernel serves
// the single-workload table [F, A*S*3, T+1] and the workload-stacked
// table [F, Wk*A*S*3, T_bucket+1] (per-row t0/t1 clip bounds).
//
// What bounds it: bytes. Each system moves a few hundred bytes (two
// table entries per (slot, metric), a dozen 4-byte indices, (C+1)*F
// outputs) and does one int64 subtraction and one add per output; the
// tables (<= ~250 KB) stay resident in the 50 MB L2 across the launch.
//
// Design: one thread per (system, metric). The TPU kernel walked one
// system per grid step with the tables resident in VMEM; here the
// systems are spread over the SMs instead, and each thread loops over
// the C slots in order, so `total` is accumulated in the same slot
// order as the plain version (int64 addition is exact either way).
// Neighbouring threads differ in f, so the sel and total stores of a
// warp are contiguous. Only the selected split-K table is read.
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers and the current stream, has validated shapes, dtypes and the
// clip bounds, and allocates the outputs. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void prefix_select_kernel(
    const int64_t* __restrict__ pref0, const int64_t* __restrict__ pref1,
    int R, int T0b, int T1b, int F,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ start,
    const int32_t* __restrict__ end, const int32_t* __restrict__ split,
    const int32_t* __restrict__ t0, const int32_t* __restrict__ t1,
    int P, int C, int64_t* __restrict__ sel, int64_t* __restrict__ total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)P * F) return;
  const int p = (int)(idx / F);
  const int f = (int)(idx % F);
  const bool sp = split[p] == 1;
  const int t = sp ? t1[p] : t0[p];
  const int Tb = sp ? T1b : T0b;
  const int64_t* tab = (sp ? pref1 : pref0) + (int64_t)f * R * Tb;
  int64_t tot = 0;
  for (int c = 0; c < C; ++c) {
    const int64_t pc = (int64_t)p * C + c;
    const int64_t* row = tab + (int64_t)rows[pc] * Tb;
    const int s = min(max(start[pc], 0), t);
    const int e = min(max(end[pc], 0), t);
    const int64_t d = row[e] - row[s];
    sel[pc * F + f] = d;
    tot += d;
  }
  total[(int64_t)p * F + f] = tot;
}

}  // namespace

extern "C" int prefix_select_launch(
    const void* pref0, const void* pref1, int R, int T0b, int T1b, int F,
    const void* rows, const void* start, const void* end, const void* split,
    const void* t0, const void* t1, int P, int C, void* sel, void* total,
    void* stream) {
  const int threads = 256;
  const int64_t work = (int64_t)P * F;
  if (work > 0) {
    const unsigned blocks = (unsigned)((work + threads - 1) / threads);
    prefix_select_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)pref0, (const int64_t*)pref1, R, T0b, T1b, F,
        (const int32_t*)rows, (const int32_t*)start, (const int32_t*)end,
        (const int32_t*)split, (const int32_t*)t0, (const int32_t*)t1, P, C,
        (int64_t*)sel, (int64_t*)total);
  }
  return (int)cudaGetLastError();
}
