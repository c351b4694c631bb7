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
// What bounds it: bytes. Each system reads 2C table entries and 3C int32
// indices and writes C + 1 values; one subtraction and one add per slot.
// The table stays in the 50 MB L2 across the launch.
//
// Design: one thread per system. The TPU kernel walked one system per
// grid step with the indices in SMEM and the table resident in VMEM; here
// the systems are spread over the SMs, and each thread loops over its
// slots in order, so `total` rounds as the plain version's slot-order sum
// does (floating point sums depend on that order).
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers, the table's type code (0 float64, 1 float32, 2 int64,
// 3 int32) and the current stream, has validated the indices against
// the table, and allocates the outputs. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a type code it does not know.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void prefix_segment_kernel(const V* __restrict__ pref, int T1,
                                      const int32_t* __restrict__ rows,
                                      const int32_t* __restrict__ start,
                                      const int32_t* __restrict__ end, int P,
                                      int C, V* __restrict__ diff,
                                      V* __restrict__ total) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  V tot = V(0);
  for (int c = 0; c < C; ++c) {
    const int64_t pc = p * C + c;
    const V* row = pref + (int64_t)rows[pc] * T1;
    const V d = row[end[pc]] - row[start[pc]];
    diff[pc] = d;
    tot = c == 0 ? d : tot + d;
  }
  total[p] = tot;
}

template <typename V>
void launch(const void* pref, int T1, const void* rows, const void* start,
            const void* end, int P, int C, void* diff, void* total,
            cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((P + threads - 1) / threads);
  prefix_segment_kernel<V><<<blocks, threads, 0, stream>>>(
      (const V*)pref, T1, (const int32_t*)rows, (const int32_t*)start,
      (const int32_t*)end, P, C, (V*)diff, (V*)total);
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
