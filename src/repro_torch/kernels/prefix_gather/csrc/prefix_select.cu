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
//   total[p,f] = sum over c of sel[p,c,f]
// with r = rows[p,c]. The tables are int64 prefix sums [F, R, T+1]; the
// rows already carry any workload-stack offset, so the same kernel serves
// the single-workload table [F, A*S*3, T+1] and the workload-stacked
// table [F, Wk*A*S*3, T_bucket+1] (per-row t0/t1 clip bounds).
//
// What bounds it: the latency of its dependent loads. Each system moves a
// few hundred bytes (two table entries per (slot, metric), a dozen 4-byte
// indices, (C+1)*F outputs; 0.066 us for P = 512 at 3.35 TB/s) and does
// one int64 subtraction and one add per output; the tables (<= ~250 KB)
// stay resident in the 50 MB L2 across calls. What is left above the
// launch is the chain of round trips to L2 each thread waits on.
//
// Design: one thread per output (system, slot, metric), so the chain is
// two load levels (the kernel it replaces had one thread per (system,
// metric) walking the C slots: 1 + 6 x 2 dependent loads, 10 blocks at
// P = 512).
// - First level: rows, start and end of the slot and split, t0 and t1 of
//   the system, six independent loads issued back to back. The bound is
//   t0 + (t1 - t0) * [split == 1] in inline PTX: written as a select (even
//   of volatile loads), ptxas issues the t1 load predicated on split, one
//   more dependent level. The clip and the choice of table are arithmetic.
// - Second level: the two entries row[e], row[s] of the selected table.
//   Only that table is read.
// - prefix_select_kernel (1 <= C*F <= 128, the main path): block (F, C, z)
//   with z = min(64, 128 / (C*F)) systems (5 x 6 x 4 on the main path; 128
//   blocks at P = 512), no division: thread (f, c, q) is output (q, c, f),
//   in sel's order, so a warp's stores are one contiguous run. Each
//   difference also goes to shared memory; after one barrier the threads
//   of slot 0 sum their system's C slots there, in slot order, and write
//   the totals, one contiguous run a system. int64 addition is exact, so
//   the bits match the plain sum. (64-bit atomicAdd on shared memory
//   compiles to a compare-and-swap loop that the C slots of a system
//   serialise on; a looping thread-per-(system, slot) kernel ran slower.)
// - prefix_select_loop_kernel (any other C*F): a block of 128 threads
//   holds one system (C = 0: 128 systems, zero totals) and loops over its
//   outputs; the differences take C*F*8 bytes of shared memory (opted in
//   above 48 KB), and a launch needing more than 227 KB (C*F above
//   29,056) is refused.

// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers and the current stream, has validated shapes, dtypes and the
// clip bounds, and allocates the outputs. Returns cudaGetLastError(), or
// cudaErrorInvalidValue when C*F is beyond the shared memory.
// prefix_select_geometry reports the launch for given P, C and F.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // threads a block
constexpr int kMaxZ = 64;          // a block's z dimension limit
constexpr int kMaxSmem = 232448;   // shared memory a block can opt in to

// A 4-byte load of the first level, issued where it stands.
__device__ __forceinline__ int ld_first(const int32_t* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// b0 + (b1 - b0) * one, in PTX. Written as a select, ptxas loads b1 only
// where it is chosen, after split arrives: one more dependent level.
__device__ __forceinline__ int pick(int b0, int b1, int one) {
  int v;
  asm("mad.lo.s32 %0, %1, %2, %3;" : "=r"(v) : "r"(b1 - b0), "r"(one),
      "r"(b0));
  return v;
}

// sel[p, c, f]: the first level (the slot's row and range, the system's
// split and bounds), then the second (two entries of the selected table).
__device__ __forceinline__ int64_t select_one(
    const int64_t* __restrict__ pref0, const int64_t* __restrict__ pref1,
    int R, int T0b, int T1b, const int32_t* rows, const int32_t* start,
    const int32_t* end, const int32_t* split, const int32_t* t0,
    const int32_t* t1, int64_t p, int64_t pc, int f) {
  const int r = ld_first(rows + pc), st = ld_first(start + pc);
  const int en = ld_first(end + pc), sp = ld_first(split + p);
  const int b0 = ld_first(t0 + p), b1 = ld_first(t1 + p);
  const bool one = sp == 1;
  const int t = pick(b0, b1, one);
  const int Tb = one ? T1b : T0b;
  const int64_t* rw = (one ? pref1 : pref0) + ((int64_t)f * R + r) * Tb;
  return rw[min(max(en, 0), t)] - rw[min(max(st, 0), t)];
}

// One output a thread: block (F, C, systems), C * F <= kThreads. Thread
// (f, c, q) is output (q, c, f) of the block, in sel's order; the block's
// differences stay in shared memory for the totals.
__global__ void __launch_bounds__(kThreads) prefix_select_kernel(
    const int64_t* __restrict__ pref0, const int64_t* __restrict__ pref1,
    int R, int T0b, int T1b, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ start, const int32_t* __restrict__ end,
    const int32_t* __restrict__ split, const int32_t* __restrict__ t0,
    const int32_t* __restrict__ t1, int P, int64_t* __restrict__ sel,
    int64_t* __restrict__ total) {
  __shared__ int64_t diff[kThreads];
  const int F = blockDim.x, C = blockDim.y;
  const int f = threadIdx.x, c = threadIdx.y, q = threadIdx.z;
  const int i = (q * C + c) * F + f;
  const int64_t p = (int64_t)blockIdx.x * blockDim.z + q;
  if (p < P) {
    const int64_t d = select_one(pref0, pref1, R, T0b, T1b, rows, start,
                                 end, split, t0, t1, p, p * C + c, f);
    sel[p * C * F + c * F + f] = d;
    diff[i] = d;
  }
  __syncthreads();
  if (c == 0 && p < P) {             // total[p, f]: its C slots
    int64_t sum = 0;
    for (int cc = 0; cc < C; ++cc) sum += diff[(q * C + cc) * F + f];
    total[p * F + f] = sum;
  }
}

// Any other C * F (above kThreads, or 0): a block holds one system (or,
// for C = 0, kThreads systems with zero totals) and its threads loop over
// the outputs, the differences in dynamic shared memory [C * F].
__global__ void __launch_bounds__(kThreads) prefix_select_loop_kernel(
    const int64_t* __restrict__ pref0, const int64_t* __restrict__ pref1,
    int R, int T0b, int T1b, int F, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ start, const int32_t* __restrict__ end,
    const int32_t* __restrict__ split, const int32_t* __restrict__ t0,
    const int32_t* __restrict__ t1, int P, int C, int64_t* __restrict__ sel,
    int64_t* __restrict__ total) {
  extern __shared__ int64_t diffs[];
  const int W = C * F;
  const int pb = W < 1 ? kThreads : 1;
  const int64_t p0 = (int64_t)blockIdx.x * pb;
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const int c = i / F, f = i - c * F;
    const int64_t d = select_one(pref0, pref1, R, T0b, T1b, rows, start,
                                 end, split, t0, t1, p0, p0 * C + c, f);
    sel[p0 * W + i] = d;
    diffs[i] = d;
  }
  __syncthreads();
  const int n = (int)min((int64_t)pb, (int64_t)P - p0) * F;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int q = k / F, f = k - q * F;
    int64_t sum = 0;
    for (int c = 0; c < C; ++c) sum += diffs[(int64_t)c * F + f];
    total[(p0 + q) * F + f] = sum;
  }
}

// The launch: kernel 0 (one output a thread) or 1 (loop), grid, block,
// dynamic shared bytes.
struct Plan {
  int kernel, systems;   // systems a block
  dim3 grid, block;
  int64_t smem;
};

Plan plan(int P, int C, int F) {
  const int64_t W = (int64_t)C * F;
  Plan p{};
  if (W >= 1 && W <= kThreads) {
    p.kernel = 0;
    p.systems = (int)min((int64_t)kMaxZ, kThreads / W);
    p.block = dim3(F, C, p.systems);
  } else {
    p.kernel = 1;
    p.systems = W < 1 ? kThreads : 1;
    p.block = dim3(kThreads);
    p.smem = W * (int64_t)sizeof(int64_t);
  }
  p.grid = dim3((unsigned)((P + p.systems - 1) / p.systems));
  return p;
}

}  // namespace

extern "C" int prefix_select_launch(
    const void* pref0, const void* pref1, int R, int T0b, int T1b, int F,
    const void* rows, const void* start, const void* end, const void* split,
    const void* t0, const void* t1, int P, int C, void* sel, void* total,
    void* stream) {
  if (P < 1 || F < 1) return (int)cudaGetLastError();   // nothing to write
  const Plan pl = plan(P, C, F);
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t *p0 = (const int64_t*)pref0, *p1 = (const int64_t*)pref1;
  const int32_t *ro = (const int32_t*)rows, *st = (const int32_t*)start,
                *en = (const int32_t*)end, *sp = (const int32_t*)split,
                *a0 = (const int32_t*)t0, *a1 = (const int32_t*)t1;
  if (pl.kernel == 0) {
    prefix_select_kernel<<<pl.grid, pl.block, 0, s>>>(
        p0, p1, R, T0b, T1b, ro, st, en, sp, a0, a1, P, (int64_t*)sel,
        (int64_t*)total);
  } else {
    if (pl.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    if (pl.smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          prefix_select_loop_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
      if (err != cudaSuccess) return (int)err;
    }
    prefix_select_loop_kernel<<<pl.grid, pl.block, (size_t)pl.smem, s>>>(
        p0, p1, R, T0b, T1b, F, ro, st, en, sp, a0, a1, P, C, (int64_t*)sel,
        (int64_t*)total);
  }
  return (int)cudaGetLastError();
}

// out[7]: kernel (0 one output a thread, 1 loop), blocks, block x, y, z
// (threads a block: F, C, systems; or 128, 1, 1), systems a block,
// dynamic shared bytes a block.
extern "C" void prefix_select_geometry(int P, int C, int F, int* out) {
  const Plan pl = plan(P, C, F);
  out[0] = pl.kernel;
  out[1] = P > 0 ? (int)pl.grid.x : 0;
  out[2] = (int)pl.block.x;
  out[3] = (int)pl.block.y;
  out[4] = (int)pl.block.z;
  out[5] = pl.systems;
  out[6] = (int)pl.smem;
}
