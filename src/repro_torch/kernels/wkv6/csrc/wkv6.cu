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
// for t = 0 .. T-1, from S = s0[g] (zeros when s0 is null), writing y
// and the final state s_out[g] [D,D] (indexed [k,v]). Any T >= 1 works,
// T = 1 being one decode step. r, k, v, w and y lie in the model's
// (B, T, H, D) layout, row g = b*H + h; a (G, T, D) tensor is the case
// H = 1. u is read as row g % u_rows, so a per-head u [H,D] serves every
// row with no copy. s_out may alias s0 (an in-place cache update): each
// state element is read, before the loop, and written, after it, by one
// thread only.
//
// What bounds it: at prefill (G = 160, T = 512, D = 64) the bytes, about
// 0.032 ms for r,k,v,w,y and the final state at 3.35 TB/s, against
// 5*D*D + 5*D flops per (g,t) (the readout sum_k r_k S[k,v] plus the
// bonus v_v * sum_k r_k u_k k_k, and the update w*S + k v^T), 1.70 GFLOP
// or about 0.025 ms at the 67 TFLOP/s fp32 rate; at decode (T = 1) the
// state's bytes in and out. Each step depends on the last, so the kernel
// cannot stream at either rate: it runs at the pace the SMs dispatch each
// step's FP32 and shared-memory instructions, and the latency of the
// readout's cross-lane sum.
//
// Design. The state is split over columns and over lanes:
// - Columns v of S are independent, so block (g, y) owns the kVB = 32
//   value columns v0 = 32 y .. v0+31 of row g: grid (G, 2), 320 blocks at
//   prefill, 2.4 a SM.
// - Each thread keeps a 4 x 4 block of S in registers: rows 4p .. 4p+3,
//   columns vq .. vq+3. Per step it reads 16 floats from shared memory
//   (r, k, w of its rows, v of its columns: four 16-byte loads) for 16
//   state elements; a thread holding one column of 16 rows reads 49, and
//   shared memory, not FP32, set its pace. Rows meet only in the readout,
//   so the 16 lanes p of a column group (lane = q + 2 p) sum it by
//   shuffles. Steps go in pairs: the pair's 8 sums (2 steps x 4 columns)
//   are reduce-scattered over lane masks 16, 8, 4 (each level keeps half
//   and adds the partner's half) and finished by a butterfly at mask 2,
//   7 shuffles a pair, leaving each lane one y. An odd count gets a
//   neutral step (r = k = v = 0, w = 1), which leaves S exactly as it was.
// - The bonus is folded into each lane's sums, (sum over its rows of
//   r u k) times v: 3 FP32 instructions per state element a step, plus 3
//   per column for the bonus, and no pass or barrier of its own.
// - Time comes in chunks of kCT = 16 steps through a ring of 3 chunks in
//   shared memory, filled by cp.async (16 bytes a thread, coalesced rows
//   of the (B, T, H, D) layout): chunks c+1 and c+2 land while chunk c is
//   stepped, one barrier a chunk. A full chunk's 8 pairs are one straight
//   run, so a pair's shuffles overlap the next pair's products; its y
//   stays in registers until the chunk ends, is staged in shared memory
//   and written in coalesced rows.
// - 47,104 B of shared memory and at most 128 registers a thread (4
//   blocks a SM) keep all 320 prefill blocks resident at once.
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers and the current stream, has validated float32 dtypes,
// contiguity, 16-byte alignment, shapes and D, and allocates the outputs.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unsupported
// D.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                  // head width (key = value width)
constexpr int kKT = 4;                  // state rows k per thread
constexpr int kVT = 4;                  // state columns v per thread
constexpr int kVB = 32;                 // value columns per block
constexpr int kCT = 16;                 // time steps per chunk
constexpr int kStages = 3;              // chunks in the ring
constexpr int kP = kD / kKT;            // lanes sharing a column group: 16
constexpr int kQW = 32 / kP;            // column groups per warp: 2
constexpr int kThreads = kP * kVB / kVT;  // 128
constexpr int kMinBlocks = 4;           // caps registers at 128 a thread
static_assert(kKT == 4 && kVT == 4 && kP == 16,
              "lane layout: lane = q + 2 p, rows 4 p .. 4 p + 3");
static_assert(kVB % (kQW * kVT) == 0, "whole warps per block");
static_assert(kCT % 2 == 0, "steps go in pairs");

struct Stage {
  float r[kCT][kD];
  float k[kCT][kD];
  float w[kCT][kD];
  float v[kCT][kVB];
};

struct __align__(16) Smem {
  Stage stage[kStages];
  float y[2][kCT][kVB];                 // y of the last two chunks
};
static_assert(sizeof(Smem) <= 48 * 1024, "static shared memory");

__device__ __forceinline__ void cp_async16(void* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Start the copies of steps t0 .. t0+n-1 into one stage: the full rows of
// r, k, w and this block's columns of v. `row` is the offset of (b, 0, h,
// 0), `ts` the stride of one step (H*D). An odd n gets a neutral step n
// (r = k = v = 0, w = 1: S is left exactly as it was), so that steps go
// in pairs.
__device__ __forceinline__ void load_chunk(
    Stage& st, const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w, int64_t row,
    int64_t ts, int v0, int t0, int n) {
  for (int idx = threadIdx.x; idx < n * (kD / 4); idx += kThreads) {
    const int i = idx / (kD / 4), q = idx % (kD / 4);
    const int64_t off = row + (int64_t)(t0 + i) * ts + 4 * q;
    cp_async16(&st.r[i][4 * q], r + off);
    cp_async16(&st.k[i][4 * q], k + off);
    cp_async16(&st.w[i][4 * q], w + off);
  }
  for (int idx = threadIdx.x; idx < n * (kVB / 4); idx += kThreads) {
    const int i = idx / (kVB / 4), q = idx % (kVB / 4);
    const int64_t off = row + (int64_t)(t0 + i) * ts + v0 + 4 * q;
    cp_async16(&st.v[i][4 * q], v + off);
  }
  if (n & 1) {
    for (int idx = threadIdx.x; idx < kD; idx += kThreads) {
      st.r[n][idx] = 0.f;
      st.k[n][idx] = 0.f;
      st.w[n][idx] = 1.f;
    }
    for (int idx = threadIdx.x; idx < kVB; idx += kThreads) st.v[n][idx] = 0.f;
  }
}

// Write n staged steps of y (this block's columns) in coalesced rows.
__device__ __forceinline__ void store_y(const float (*ys)[kVB],
                                        float* __restrict__ y, int64_t row,
                                        int64_t ts, int v0, int t0, int n) {
  for (int idx = threadIdx.x; idx < n * (kVB / 4); idx += kThreads) {
    const int i = idx / (kVB / 4), q = idx % (kVB / 4);
    *reinterpret_cast<float4*>(y + row + (int64_t)(t0 + i) * ts + v0 +
                               4 * q) = ld4(&ys[i][4 * q]);
  }
}

// One step on this thread's 4 x 4 block of S (rows kp .. kp+3, columns
// vq .. vq+3). a[c] gets its part of y_t[vq + c]: the readout over its
// rows, sum_k r[k] S[k][c] (S before the update), plus the bonus over its
// rows, (sum_k r[k] u[k] k[k]) v[c]. Then S[k][c] <- w[k] S[k][c] +
// k[k] v[c].
__device__ __forceinline__ void step(const Stage& st, int i, int kp, int vq,
                                     const float (&uu)[4],
                                     float (&s)[4][kVT], float* a) {
  const float4 v4 = ld4(&st.v[i][vq]);
  const float4 r4 = ld4(&st.r[i][kp]);
  const float4 k4 = ld4(&st.k[i][kp]);
  const float4 w4 = ld4(&st.w[i][kp]);
  const float vv[kVT] = {v4.x, v4.y, v4.z, v4.w};
  const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
  const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
  const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
  float bonus = rr[0] * uu[0] * kk[0];
#pragma unroll
  for (int e = 1; e < 4; ++e) bonus = fmaf(rr[e] * uu[e], kk[e], bonus);
#pragma unroll
  for (int c = 0; c < kVT; ++c) a[c] = bonus * vv[c];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < kVT; ++c) {
      a[c] = fmaf(rr[e], s[e][c], a[c]);
      s[e][c] = fmaf(ww[e], s[e][c], kk[e] * vv[c]);
    }
}

// The steps of one chunk (n of them, in pairs; all kCT when kFull, so the
// compiler sees one straight run and overlaps a pair's reduction with the
// next pair's products). out[j] gets this lane's share of pair j: after
// a reduce-scatter over the 16 lanes of its column group (p's bits 3, 2,
// 1 at lane masks 16, 8, 4: each level keeps half the sums and adds the
// partner's half) and a butterfly over p's bit 0 (mask 2), y of step
// 2 j + b3, column vq + 2 b2 + b1.
template <bool kFull>
__device__ __forceinline__ void chunk_steps(const Stage& st, int n, int p,
                                            int kp, int vq,
                                            const float (&uu)[4],
                                            float (&s)[4][kVT],
                                            float (&out)[kCT / 2]) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool b3 = (p >> 3) & 1, b2 = (p >> 2) & 1, b1 = (p >> 1) & 1;
#pragma unroll
  for (int j = 0; j < kCT / 2; ++j) {
    if (!kFull && 2 * j >= n) break;
    float a[2 * kVT];                 // a[4 t + c]: step 2 j + t, column c
    step(st, 2 * j, kp, vq, uu, s, a);
    step(st, 2 * j + 1, kp, vq, uu, s, a + kVT);
    float x[4], z[2];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      x[m] = (b3 ? a[m + 4] : a[m]) +
             __shfl_xor_sync(kAll, b3 ? a[m] : a[m + 4], 16);
#pragma unroll
    for (int m = 0; m < 2; ++m)
      z[m] = (b2 ? x[m + 2] : x[m]) +
             __shfl_xor_sync(kAll, b2 ? x[m] : x[m + 2], 8);
    const float t =
        (b1 ? z[1] : z[0]) + __shfl_xor_sync(kAll, b1 ? z[0] : z[1], 4);
    out[j] = t + __shfl_xor_sync(kAll, t, 2);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, int u_rows, const float* s0,
            float* __restrict__ y, float* s_out, int H, int T) {
  __shared__ Smem sm;

  const int g = blockIdx.x;
  const int v0 = blockIdx.y * kVB;
  const int lane = threadIdx.x & 31;
  const int p = lane / kQW;                      // the lane's k-slice
  const int q = (threadIdx.x >> 5) * kQW + lane % kQW;  // its column group
  const int kp = 4 * p, vq = kVT * q;     // rows kp + e, columns vq + c
  const int b = g / H, h = g - b * H;
  const int64_t ts = (int64_t)H * kD;
  const int64_t row = ((int64_t)b * T * H + h) * kD;
  const int nchunks = (T + kCT - 1) / kCT;

  // the first kStages - 1 chunks in flight, one commit group each
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks)
      load_chunk(sm.stage[c], r, k, v, w, row, ts, v0, c * kCT,
                 min(kCT, T - c * kCT));
    cp_async_commit();
  }

  // u[kp + e] and S[kp + e][v0 + vq + c], in registers for the sequence
  const float4 u4 = ld4(u + (int64_t)(g % u_rows) * kD + kp);
  const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
  const int64_t sbase = (int64_t)g * kD * kD + v0 + vq;
  float s[4][kVT];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 x = s0 != nullptr ? ld4(s0 + sbase + (kp + e) * kD)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    s[e][0] = x.x;
    s[e][1] = x.y;
    s[e][2] = x.z;
    s[e][3] = x.w;
  }

  for (int c = 0; c < nchunks; ++c) {
    const int n = min(kCT, T - c * kCT);
    const Stage& st = sm.stage[c % kStages];
    cp_async_wait<kStages - 2>();    // this thread's copies of chunk c
    __syncthreads();                 // everyone's; chunk c-1 consumed
    {
      const int cn = c + kStages - 1;  // refill the stage chunk c-1 used
      if (cn < nchunks)
        load_chunk(sm.stage[cn % kStages], r, k, v, w, row, ts, v0,
                   cn * kCT, min(kCT, T - cn * kCT));
      cp_async_commit();
    }
    if (c > 0)                       // the previous chunk's y
      store_y(sm.y[(c - 1) & 1], y, row, ts, v0, (c - 1) * kCT, kCT);

    float out[kCT / 2];
    if (n == kCT)
      chunk_steps<true>(st, n, p, kp, vq, uu, s, out);
    else
      chunk_steps<false>(st, n, p, kp, vq, uu, s, out);
    if ((p & 1) == 0) {              // one of the two lanes holding each
      const int ti = (p >> 3) & 1, col = vq + 2 * ((p >> 2) & 1) +
                                         ((p >> 1) & 1);
#pragma unroll
      for (int j = 0; j < kCT / 2; ++j)
        if (2 * j < n) sm.y[c & 1][2 * j + ti][col] = out[j];
    }
  }
  __syncthreads();
  const int last = nchunks - 1;
  store_y(sm.y[last & 1], y, row, ts, v0, last * kCT, T - last * kCT);

#pragma unroll
  for (int e = 0; e < 4; ++e)
    *reinterpret_cast<float4*>(s_out + sbase + (kp + e) * kD) =
        make_float4(s[e][0], s[e][1], s[e][2], s[e][3]);
}

}  // namespace

extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, int u_rows,
                           const void* s0, void* y, void* s_out, int B,
                           int T, int H, int D, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, kD / kVB);
  wkv6_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, u_rows, (const float*)s0, (float*)y, (float*)s_out,
      H, T);
  return (int)cudaGetLastError();
}

// The launch geometry: value columns per block, lanes per column group,
// steps per chunk, ring stages, threads per block, static shared bytes
// per block; the grid is (G, D / columns per block).
extern "C" void wkv6_geometry(int* out) {
  out[0] = kVB;
  out[1] = kP;
  out[2] = kCT;
  out[3] = kStages;
  out[4] = kThreads;
  out[5] = (int)sizeof(Smem);
}
