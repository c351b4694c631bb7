// Variants of one RG-LRU decode step (T = 1), for
// scripts/rglru_decode_probe.py: what the time of the committed step
// kernel (src/repro_torch/kernels/rglru/csrc/rglru.cu, included below) is
// made of, against kernels that do less.
//
// probe_launch(variant, threads, a, b, h0, h, h_out, B, C, stream):
//   0 "empty": a kernel that does nothing, at the step kernel's grid;
//   1 "copy": h = a, float4, one load and one store a thread;
//   2 "step": the committed step kernel, float4, at `threads` a block;
//   3 "step_scalar": the committed step kernel, one element a thread.
// h0 or h_out may be null. Returns cudaGetLastError().

#include "../src/repro_torch/kernels/rglru/csrc/rglru.cu"

namespace {

__global__ void empty_kernel() {}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const float* __restrict__ a, float* __restrict__ h, int64_t n) {
  const int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i + 4 <= n)
    *reinterpret_cast<float4*>(h + i) =
        *reinterpret_cast<const float4*>(a + i);
}

template <bool kVec, int kThreads>
void launch_step(const float* a, const float* b, const float* h0, float* h,
                 float* h_out, int64_t n, cudaStream_t s) {
  const int64_t per = (int64_t)kThreads * (kVec ? 4 : 1);
  rglru_step_kernel<kVec, kThreads>
      <<<(unsigned)((n + per - 1) / per), kThreads, 0, s>>>(a, b, h0, h,
                                                           h_out, n);
}

template <bool kVec>
int step_by_threads(int threads, const float* a, const float* b,
                    const float* h0, float* h, float* h_out, int64_t n,
                    cudaStream_t s) {
  switch (threads) {
    case 32: launch_step<kVec, 32>(a, b, h0, h, h_out, n, s); break;
    case 64: launch_step<kVec, 64>(a, b, h0, h, h_out, n, s); break;
    case 128: launch_step<kVec, 128>(a, b, h0, h, h_out, n, s); break;
    case 256: launch_step<kVec, 256>(a, b, h0, h, h_out, n, s); break;
    case 512: launch_step<kVec, 512>(a, b, h0, h, h_out, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_launch(int variant, int threads, const void* a,
                            const void* b, const void* h0, void* h,
                            void* h_out, int B, int C, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float *fa = (const float*)a, *fb = (const float*)b,
              *f0 = (const float*)h0;
  float *fh = (float*)h, *fo = (float*)h_out;
  const int64_t n = (int64_t)B * C;
  const unsigned step_blocks = (unsigned)((n / 4 + 127) / 128);
  switch (variant) {
    case 0:
      empty_kernel<<<step_blocks, 128, 0, s>>>();
      break;
    case 1:
      copy_kernel<128><<<step_blocks, 128, 0, s>>>(fa, fh, n);
      break;
    case 2:
      return step_by_threads<true>(threads, fa, fb, f0, fh, fo, n, s);
    case 3:
      return step_by_threads<false>(threads, fa, fb, f0, fh, fo, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
