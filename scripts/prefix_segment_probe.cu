// Variants of the single-table prefix gather, for
// scripts/prefix_segment_probe.py: what the time of the committed kernels
// (src/repro_torch/kernels/prefix_gather/csrc/prefix_segment.cu, included
// below) is made of, how it moves with the block size, and the designs
// they were chosen over.
//
// probe_launch(variant, threads, pref, T1, rows, start, end, P, C, diff,
//              total, type, stream), `threads` 32, 64 or 128:
//   0 "empty": a kernel that does nothing, at the committed kernel's grid
//     for `threads` a block;
//   1 "indices": the committed layout (a thread per slot) with the first
//     load level alone, each lane storing what it read, and no total
//     (1 <= C <= 8);
//   2 "kernel": the committed kernel for C (the unrolled one for
//     1 <= C <= 8, else the grouped one) at `threads` a block;
//   4 "system": one thread per system with the C slots unrolled, all 3C
//     index loads (W int32 a load: the widest of 4, 2 and 1 that divides C
//     and the pointers' alignment) before the 2C table loads, a warp
//     barrier after each level (the first design tried), at `threads` a
//     block (1 <= C <= 8);
//   5 "grouped": the committed kernel with C at run time
//     (segment_grouped_kernel), at any C, at `threads` a block.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a variant,
// type, C or block size it does not take.

#include "../src/repro_torch/kernels/prefix_gather/csrc/prefix_segment.cu"

namespace {

__global__ void empty_kernel() {}

template <typename V, int C>
__global__ void __launch_bounds__(kThreads) indices_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ start,
    const int32_t* __restrict__ end, int P, V* __restrict__ diff) {
  constexpr int S = 32 / C;
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int q = lane / C, c = lane - q * C;
  const int64_t p = warp * S + q;
  if (q >= S || p >= P) return;
  const int64_t i = p * C + c;
  diff[i] = V(ld_index(rows + i) + ld_index(start + i) + ld_index(end + i));
}

// W int32 indices from p, read-only.
template <int W>
__device__ __forceinline__ void ld_indices(const int32_t* p, int* v) {
  if constexpr (W == 1) {
    asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v[0]) : "l"(p));
  } else if constexpr (W == 2) {
    asm volatile("ld.global.nc.v2.b32 {%0, %1}, [%2];"
                 : "=r"(v[0]), "=r"(v[1]) : "l"(p));
  } else {
    asm volatile("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "l"(p));
  }
}

template <typename V, int C, int W>
__global__ void __launch_bounds__(kThreads) system_kernel(
    const V* __restrict__ pref, int T1, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ start, const int32_t* __restrict__ end,
    int P, V* __restrict__ diff, V* __restrict__ total) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int64_t base = p * C;
  int r[C], s[C], e[C];
#pragma unroll
  for (int c = 0; c < C; c += W) ld_indices<W>(rows + base + c, r + c);
#pragma unroll
  for (int c = 0; c < C; c += W) ld_indices<W>(start + base + c, s + c);
#pragma unroll
  for (int c = 0; c < C; c += W) ld_indices<W>(end + base + c, e + c);
  __syncwarp();
  V hi[C], lo[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const V* row = pref + (int64_t)r[c] * T1;
    hi[c] = ld_entry(row + e[c]);
    lo[c] = ld_entry(row + s[c]);
  }
  __syncwarp();
  V tot = hi[0] - lo[0];
  diff[base] = tot;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const V d = hi[c] - lo[c];
    diff[base + c] = d;
    tot = tot + d;
  }
  total[p] = tot;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
}

template <typename V, int C, int W>
void system_launch(int threads, const Args<V>& a, cudaStream_t s) {
  system_kernel<V, C, W><<<(a.P + threads - 1) / threads, threads, 0, s>>>(
      a.pref, a.T1, a.rows, a.start, a.end, a.P, a.diff, a.total);
}

template <typename V, int C>
void by_c(int variant, int blocks, int threads, const Args<V>& a,
          cudaStream_t s) {
  if (variant == 1) {
    indices_kernel<V, C><<<blocks, threads, 0, s>>>(a.rows, a.start, a.end,
                                                     a.P, a.diff);
    return;
  }
  if (variant == 2) {
    segment_unrolled_kernel<V, C><<<blocks, threads, 0, s>>>(
        a.pref, a.T1, a.rows, a.start, a.end, a.P, a.diff, a.total);
    return;
  }
  auto fits = [&](int w) {
    return C % w == 0 && aligned(a.rows, 4 * w) &&
           aligned(a.start, 4 * w) && aligned(a.end, 4 * w);
  };
  if constexpr (C % 4 == 0) {
    if (fits(4)) return system_launch<V, C, 4>(threads, a, s);
  }
  if constexpr (C % 2 == 0) {
    if (fits(2)) return system_launch<V, C, 2>(threads, a, s);
  }
  system_launch<V, C, 1>(threads, a, s);
}

template <typename V>
int variant_run(int variant, int threads, const void* pref, int T1,
                const void* rows, const void* start, const void* end, int P,
                int C, void* diff, void* total, cudaStream_t s) {
  const int S = plan(P, C).systems;
  const int64_t warps = ((int64_t)P + S - 1) / S;
  const int blocks = (int)((warps * 32 + threads - 1) / threads);
  const Args<V> a{(const V*)pref, T1, (const int32_t*)rows,
                  (const int32_t*)start, (const int32_t*)end, P, C,
                  (V*)diff, (V*)total};
  if (variant == 0) {
    empty_kernel<<<blocks, threads, 0, s>>>();
  } else if (variant == 5 || (variant == 2 && C > kMaxUnrolled)) {
    segment_grouped_kernel<V><<<blocks, threads, 0, s>>>(
        a.pref, T1, a.rows, a.start, a.end, P, C, a.diff, a.total);
  } else if (variant == 1 || variant == 2 || variant == 4) {
    switch (C) {
      case 1: by_c<V, 1>(variant, blocks, threads, a, s); break;
      case 2: by_c<V, 2>(variant, blocks, threads, a, s); break;
      case 3: by_c<V, 3>(variant, blocks, threads, a, s); break;
      case 4: by_c<V, 4>(variant, blocks, threads, a, s); break;
      case 5: by_c<V, 5>(variant, blocks, threads, a, s); break;
      case 6: by_c<V, 6>(variant, blocks, threads, a, s); break;
      case 7: by_c<V, 7>(variant, blocks, threads, a, s); break;
      case 8: by_c<V, 8>(variant, blocks, threads, a, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_launch(int variant, int threads, const void* pref,
                            int T1, const void* rows, const void* start,
                            const void* end, int P, int C, void* diff,
                            void* total, int type, void* stream) {
  if (P <= 0 || C <= 0 || threads < 32 || threads > kThreads ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (type) {
    case 0: return variant_run<double>(variant, threads, pref, T1, rows,
                                       start, end, P, C, diff, total, s);
    case 1: return variant_run<float>(variant, threads, pref, T1, rows,
                                      start, end, P, C, diff, total, s);
    case 2: return variant_run<int64_t>(variant, threads, pref, T1, rows,
                                        start, end, P, C, diff, total, s);
    case 3: return variant_run<int32_t>(variant, threads, pref, T1, rows,
                                        start, end, P, C, diff, total, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
