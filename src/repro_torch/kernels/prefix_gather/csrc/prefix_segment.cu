// prefix_segment: the single-table prefix gather and per-system segment
// reduction, for Hopper.
//
// Replaces the Pallas TPU kernel ``_gather_kernel`` launched by
// ``prefix_segment`` in src/repro/kernels/prefix_gather/kernel.py.
//
// What it computes, per system p and chiplet slot c < C, with
// r = rows[p,c], s = start[p,c], e = end[p,c] (no clipping):
//   diff[p,c] = pref[r,e] - pref[r,s]
//   total[p]  = diff[p,0] + diff[p,1] + ... + diff[p,C-1], in slot order,
//               starting from slot 0's difference as the TPU kernel does
// for a [R, T+1] table of float64, float32, int64 or int32, in the
// table's type.
//
// What bounds it: the latency of its dependent loads. Each system moves a
// few dozen bytes (2C table entries, 3C int32 indices, C + 1 outputs; 0.02
// us for P = 512 at 3.35 TB/s) and does one subtraction and one add a
// slot; the table stays in the 50 MB L2 across calls. What is left above
// the launch is the chain of round trips to L2 each thread waits on, and
// the L1 traffic of the gathers.
//
// Design: one thread per (system, slot), so the chain is two load levels
// and no loop over slots: level one is the slot's three indices, level two
// its two table entries. A warp holds 32 / C whole systems (C <= 32), so
// its index loads and its diff store are each one contiguous run, and the
// system's total is summed on its slot-0 lane from the other lanes'
// differences by warp shuffles, in slot order from slot 0's difference
// (the plain version's rounding order). No shared memory, no barrier.
// - segment_unrolled_kernel<V, C> (1 <= C <= 8, the main path has C = 6):
//   C at compile time, so a lane's system and slot come without a
//   division and the C - 1 shuffles are issued back to back.
// - segment_grouped_kernel<V> (any other C): the same with C at run time;
//   for C > 32 a warp holds one system and takes its slots in groups of 32
//   in turn, each group with the two levels.
// The grouped kernel computes every C too, but at C = 6 it is 0.21-0.26 us
// slower than the unrolled one on an H100 (the division by C and the
// shuffle loop at run time; scripts/prefix_segment_probe.py, variant
// "grouped"). Every load is a read-only ld.global.nc in inline PTX. 128
// threads a block, measured against 32 and 64 (the same script).
//
// The first design tried, one thread per system with the C slots unrolled
// and all 3C index loads issued before the 2C table loads, was slower at
// P = 512 and slowed as blocks grew: ptxas sank loads below the first use
// of the level before (the SASS showed three and more levels), and each
// thread issues 3C strided index loads and 2C gathers. The probe keeps it
// as a variant.
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers, the table's type code (0 float64, 1 float32, 2 int64,
// 3 int32) and the current stream, has validated the indices against
// the table, and allocates the outputs. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a type code it does not know or no slots.
// prefix_segment_geometry reports the launch for given P and C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // threads a block
constexpr int kMaxUnrolled = 8;    // the largest C of the unrolled kernel
constexpr unsigned kFull = 0xffffffffu;

// One int32 index, read-only, issued where it stands.
__device__ __forceinline__ int ld_index(const int32_t* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// One table entry, read-only, issued where it stands.
__device__ __forceinline__ double ld_entry(const double* p) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_entry(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int64_t ld_entry(const int64_t* p) {
  int64_t v;
  asm volatile("ld.global.nc.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int32_t ld_entry(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// diff[i] for slot i = p * C + c: its three indices, then its two entries.
template <typename V>
__device__ __forceinline__ V slot_diff(const V* pref, int T1,
                                       const int32_t* rows,
                                       const int32_t* start,
                                       const int32_t* end, int64_t i) {
  const int r = ld_index(rows + i), s = ld_index(start + i);
  const int e = ld_index(end + i);
  const V* row = pref + (int64_t)r * T1;
  const V hi = ld_entry(row + e), lo = ld_entry(row + s);
  return hi - lo;
}

// Lane (q, c) of a warp is slot c of system warp * (32 / C) + q.
template <typename V, int C>
__global__ void __launch_bounds__(kThreads) segment_unrolled_kernel(
    const V* __restrict__ pref, int T1, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ start, const int32_t* __restrict__ end,
    int P, V* __restrict__ diff, V* __restrict__ total) {
  static_assert(C >= 1 && C <= 32, "a system must fit a warp");
  constexpr int S = 32 / C;                          // systems a warp
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int q = lane / C, c = lane - q * C;
  const int64_t p = warp * S + q;
  const bool on = q < S && p < P;
  V d = V(0);
  if (on) {
    d = slot_diff(pref, T1, rows, start, end, p * C + c);
    diff[p * C + c] = d;
  }
  V tot = d;
#pragma unroll
  for (int k = 1; k < C; ++k) tot = tot + __shfl_down_sync(kFull, d, k);
  if (on && c == 0) total[p] = tot;
}

// Any C: L = min(C, 32) lanes a system, 32 / L systems a warp; for C > 32
// the warp's one system takes its slots in groups of 32 in turn. The
// slot-0 lane sums the differences in slot order as they are shuffled to
// it.
template <typename V>
__global__ void __launch_bounds__(kThreads) segment_grouped_kernel(
    const V* __restrict__ pref, int T1, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ start, const int32_t* __restrict__ end,
    int P, int C, V* __restrict__ diff, V* __restrict__ total) {
  const int L = min(C, 32), S = 32 / L;
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int q = lane / L, c = lane - q * L;
  const int64_t p = warp * S + q;
  const bool on = q < S && p < P;
  V tot = V(0);
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int n = min(L, C - c0);                    // slots in this group
    V d = V(0);
    if (on && c < n) {
      d = slot_diff(pref, T1, rows, start, end, p * C + c0 + c);
      diff[p * C + c0 + c] = d;
    }
    for (int j = 0; j < n; ++j) {
      const V v = __shfl_sync(kFull, d, min(q * L + j, 31));
      tot = c0 + j == 0 ? v : tot + v;
    }
  }
  if (on && c == 0) total[p] = tot;
}

// The launch: kernel 0 (unrolled) or 1 (grouped), blocks, systems a warp.
struct Plan {
  int kernel, blocks, systems;
};

Plan plan(int P, int C) {
  Plan pl{};
  pl.kernel = C >= 1 && C <= kMaxUnrolled ? 0 : 1;
  pl.systems = C >= 1 ? 32 / min(C, 32) : 0;
  const int64_t warps = pl.systems ? ((int64_t)P + pl.systems - 1) /
                                         pl.systems : 0;
  pl.blocks = (int)((warps * 32 + kThreads - 1) / kThreads);
  return pl;
}

template <typename V>
struct Args {
  const V* pref;
  int T1;
  const int32_t *rows, *start, *end;
  int P, C;
  V *diff, *total;
};

template <typename V, int C>
void unrolled(const Plan& pl, const Args<V>& a, cudaStream_t s) {
  segment_unrolled_kernel<V, C><<<pl.blocks, kThreads, 0, s>>>(
      a.pref, a.T1, a.rows, a.start, a.end, a.P, a.diff, a.total);
}

// Launches the kernel plan() picks, the one prefix_segment_geometry
// reports.
template <typename V>
void launch(const void* pref, int T1, const void* rows, const void* start,
            const void* end, int P, int C, void* diff, void* total,
            cudaStream_t s) {
  const Args<V> a{(const V*)pref, T1, (const int32_t*)rows,
                  (const int32_t*)start, (const int32_t*)end, P, C,
                  (V*)diff, (V*)total};
  const Plan pl = plan(P, C);
  if (pl.kernel == 1) {
    segment_grouped_kernel<V><<<pl.blocks, kThreads, 0, s>>>(
        a.pref, a.T1, a.rows, a.start, a.end, a.P, a.C, a.diff, a.total);
    return;
  }
  static_assert(kMaxUnrolled == 8, "a case for every unrolled C");
  switch (C) {
    case 1: return unrolled<V, 1>(pl, a, s);
    case 2: return unrolled<V, 2>(pl, a, s);
    case 3: return unrolled<V, 3>(pl, a, s);
    case 4: return unrolled<V, 4>(pl, a, s);
    case 5: return unrolled<V, 5>(pl, a, s);
    case 6: return unrolled<V, 6>(pl, a, s);
    case 7: return unrolled<V, 7>(pl, a, s);
    case 8: return unrolled<V, 8>(pl, a, s);
  }
}

}  // namespace

extern "C" int prefix_segment_launch(const void* pref, int T1,
                                     const void* rows, const void* start,
                                     const void* end, int P, int C,
                                     void* diff, void* total, int type,
                                     void* stream) {
  if (P <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (type) {
    case 0: launch<double>(pref, T1, rows, start, end, P, C, diff, total, s);
      break;
    case 1: launch<float>(pref, T1, rows, start, end, P, C, diff, total, s);
      break;
    case 2: launch<int64_t>(pref, T1, rows, start, end, P, C, diff, total, s);
      break;
    case 3: launch<int32_t>(pref, T1, rows, start, end, P, C, diff, total, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out[4]: kernel (0 unrolled, 1 grouped), blocks, threads a block,
// systems a warp.
extern "C" void prefix_segment_geometry(int P, int C, int* out) {
  const Plan pl = plan(P, C);
  out[0] = pl.kernel;
  out[1] = P > 0 ? pl.blocks : 0;
  out[2] = kThreads;
  out[3] = pl.systems;
}
