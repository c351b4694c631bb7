// topology: the fused evaluator's topology stage for Hopper, one thread a
// design row.
//
// Replaces no TPU kernel. The JAX package computes this stage as plain jnp
// (src/repro/pathfinding/device.py, _topology_jax), which XLA fuses into a
// few programs; run eagerly, its torch version (ref.py, topology_plain)
// issues ~3,950 launches of nanoseconds of work each at C = 6. This kernel
// is that whole stage in one launch.
//
// What it computes, per row p of the encoded population v [P, W] (int64)
// with die areas areas [P, C] (float64): the 3D chain (members by
// non-increasing area, ties by slot) and its bonds; the planar order
// (non-members ascending, then the hybrid's base die); the slicing
// floorplan (C - 1 levels of the greedy left/right split, cuts alternating
// vertical and horizontal); the plane-pair links and their bandwidths with
// the Eq. 6 perimeter cap, then the chain bonds; the link-id table; the
// DRAM attach (eff_bw, dram_e); a BFS from every source with queue-order
// ties and the reduction route from the destination die back to it (hops,
// hops3, inc); and the package terms (pkg_area, assembly, interp,
// p25_rate). It also writes the inputs of the bonding tail, which the
// wrapper runs in torch (ref.py, bonding): its ** and its row sum keep
// torch's own rounding and reduction order.
//
// The contract is bitwise equality with the plain version on the same
// card. So the float64 arithmetic keeps the plain version's operation
// order everywhere (the sequential planar sum, the per-group folds in
// sorted order, left-to-right products), and is written with __dadd_rn,
// __dsub_rn, __dmul_rn, __ddiv_rn and __dsqrt_rn, which nvcc never
// contracts into an FMA. Sorts are stable, argmax takes the first index,
// minima propagate NaN as torch.minimum does, and an absent link is inf.
// Where the plain version sums one-hot terms (scatters onto a
// permutation), at most one term is nonzero, so any order is exact.
//
// What bounds it: the latency of each row's serial float64 and integer
// chains (O(C^3) steps: the floorplan's C - 1 levels of O(C^2) group
// folds, and C BFS of O(C^2)). Its bytes are ~1.9 KB a row at C = 6 (the
// row and its areas in; inc, 960 B, and the rest out), 0.3 us for P = 512
// at 3.35 TB/s. Design: a thread owns a row, with its state in registers
// and local arrays sized by C at compile time (1 <= C <= 8; every space
// of the repo has C = 6), or by kMaxC with C at run time above that. 32
// threads a block, so 512 rows spread over 16 SMs rather than 4. No shared
// memory, no barrier.
//
// Plain C interface (loaded with ctypes): the wrapper passes device
// pointers, the encoding's columns and style codes (layout, 10 ints) and
// the outputs (outs, in the order of struct Out), has checked shapes,
// dtypes and contiguity, and allocates the outputs. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for P < 1 or C outside
// [1, kMaxC].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;       // threads (rows) a block
constexpr int kMaxUnrolled = 8;    // the largest C with its own instance
constexpr int kMaxC = 32;          // the encoding's stack column: 32 bits
constexpr int kUnreached = 1000000;  // a BFS rank not yet given
constexpr double kTol = 1e-9;      // abutment and edge tolerance

struct Layout {
  int n, style, mem, pair25, pair3, stack;  // columns of v
  int s2d, s25, s3d, shyb;                  // style codes
};

// Outputs, each contiguous: [P, C], [P, L], [P, C, L] (inc, source-major)
// or [P]; row_f [P, 6] = n_f, m_f, cl_f, y25, y3, cfp3 and row_b [P, 3] =
// is25, is3d, ishyb feed the bonding tail.
struct Out {
  double *eff_bw, *dram_e;
  int64_t *hops, *hops3;
  double *link_bw, *link_e, *inc, *pkg_area, *assembly, *p25_rate;
  uint8_t *interp, *is2d;
  int64_t* dest;
  double *a_bond, *row_f;
  uint8_t* row_b;
};

struct Args {
  const int64_t* v;
  int W;
  const double* areas;
  int P, C;
  const double* m_bw;
  int M;
  // package rows [n25, 7] and [n3, 7]: pitch, yield, carbon a mm^2,
  // assembly scale, rate, efficiency, energy a bit
  const double* p25;
  const uint8_t* p25_interp;
  int n25;
  const double* p3;
  int n3;
  double acost;
  int split_hops3;                   // hop latencies differ by link kind
  Layout col;
  Out out;
};

__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}

// torch.minimum: NaN propagates, else the smaller.
__device__ __forceinline__ double tmin(double a, double b) {
  return (a != a || a < b) ? a : b;
}

// torch.clamp(x, min=1.0): NaN propagates.
__device__ __forceinline__ double clamp1(double x) {
  return x < 1.0 ? 1.0 : x;
}

// torch.clamp(x, lo, hi) on an index.
__device__ __forceinline__ int64_t clampi(int64_t x, int64_t lo,
                                          int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// out[0..C) = the stable ascending argsort of key[0..C).
template <int CM>
__device__ __forceinline__ void argsort(const double (&key)[CM], int C,
                                        int (&out)[CM]) {
  for (int c = 0; c < C; ++c) {
    int r = 0;
    for (int c2 = 0; c2 < C; ++c2)
      r += key[c2] < key[c] || (key[c2] == key[c] && c2 < c);
    out[r] = c;
  }
}

// A plane link's bandwidth over a length x (mm) of bumps at pitch (um):
// (rate * 1e9) * clamp(trunc((x * 1e3) / pitch), min=1) * eta.
__device__ __forceinline__ double bumps_bw(double x, double r25,
                                           double pitch, double eta) {
  return mul(mul(r25, clamp1(trunc(dvd(mul(x, 1e3), pitch)))), eta);
}

// CT: C at compile time (1..kMaxUnrolled), or kMaxC with a.C at run time.
template <int CT>
__global__ void __launch_bounds__(kThreads)
    topology_kernel(const __grid_constant__ Args a) {
  constexpr int CM = CT;                 // array extents
  const int C = CT <= kMaxUnrolled ? CT : a.C;
  const int n_plane = C * (C - 1) / 2;   // link ids >= n_plane: chain bonds
  const int L = n_plane + C - 1;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.P) return;
  const Layout& col = a.col;
  const Out& o = a.out;
  const int64_t* row = a.v + p * a.W;

  const int64_t n = row[col.n], style = row[col.style];
  const bool is2d = style == col.s2d, is25 = style == col.s25;
  const bool is3d = style == col.s3d, ishyb = style == col.shyb;
  const bool bonded = is3d || ishyb, plane_row = is25 || ishyb;
  const double memtot = a.m_bw[clampi(row[col.mem], 0, a.M - 1)];
  const int64_t i25 = clampi(row[col.pair25], 0, a.n25 - 1);
  const double* r25p = a.p25 + i25 * 7;
  const double* r3p = a.p3 + clampi(row[col.pair3], 0, a.n3 - 1) * 7;
  const double pitch25 = r25p[0], y25 = r25p[1], cfp25 = r25p[2];
  const double scale25 = r25p[3], rate25 = r25p[4], eta25 = r25p[5];
  const double ebit25 = r25p[6];
  const double pitch3 = r3p[0], y3 = r3p[1], cfp3 = r3p[2];
  const double scale3 = r3p[3], rate3 = r3p[4], eta3 = r3p[5];
  const double ebit3 = r3p[6];

  double area[CM];
  for (int c = 0; c < C; ++c) area[c] = a.areas[p * C + c];

  // -- 3D chain: members by non-increasing area, ties by slot ------------
  const int64_t stack = row[col.stack];
  bool member[CM];
  int chain_len = 0;
  double key[CM];
  for (int c = 0; c < C; ++c) {
    const bool act = c < n;
    member[c] = ishyb ? (((stack >> c) & 1) == 1 && act) : (is3d && act);
    chain_len += member[c];
    key[c] = member[c] ? -area[c] : INFINITY;
  }
  int chain[CM];
  argsort(key, C, chain);
  double a_chain[CM];
  for (int t = 0; t < C; ++t) a_chain[t] = area[chain[t]];
  // bond t joins tiers t and t + 1 (Eq. 7: bumps over the smaller face)
  double cbw[CM];
  for (int t = 0; t + 1 < C; ++t) {
    cbw[t] = INFINITY;
    if (t + 1 < chain_len && bonded) {
      const double face = tmin(a_chain[t], a_chain[t + 1]);
      const double nb3 = clamp1(trunc(dvd(mul(face, 1e6),
                                          mul(pitch3, pitch3))));
      cbw[t] = mul(mul(mul(rate3, 1e9), nb3), eta3);
    }
  }

  // -- planar order: non-members ascending, then the hybrid's base -------
  int porder[CM];
  int n_nonmem = 0;
  for (int c = 0; c < C; ++c)
    if (c < n && !member[c]) porder[n_nonmem++] = c;
  for (int c = 0, k = n_nonmem; c < C; ++c)
    if (!(c < n && !member[c])) porder[k++] = c;
  if (ishyb && n_nonmem < C) porder[n_nonmem] = chain[0];
  const int m = n_nonmem + (ishyb ? 1 : 0);   // planar dies (valid j < m)
  double ar_p[CM];
  double tot = 0.0;
  for (int j = 0; j < C; ++j) {
    ar_p[j] = j < m ? area[porder[j]] : 0.0;
    tot = add(tot, ar_p[j]);
  }
  const double side = __dsqrt_rn(mul(tot, 1.0 + 0.10));

  // -- slicing floorplan, level by level ---------------------------------
  // the greedy order (area desc, ties by position) holds at every level
  int sorder[CM], inv[CM];
  for (int j = 0; j < C; ++j) key[j] = j < m ? -ar_p[j] : INFINITY;
  argsort(key, C, sorder);
  double contrib[CM];
  bool valid_s[CM];
  for (int t = 0; t < C; ++t) {
    inv[sorder[t]] = t;
    valid_s[t] = sorder[t] < m;
    contrib[t] = valid_s[t] ? ar_p[sorder[t]] : 0.0;
  }
  int64_t g[CM];
  double bx[CM], by[CM], bw[CM], bh[CM];
  for (int j = 0; j < C; ++j) {
    g[j] = 0;
    bx[j] = by[j] = 0.0;
    bw[j] = bh[j] = side;
  }
  const int levels = C > 1 ? C - 1 : 1;
  for (int level = 0; level < levels; ++level) {
    int64_t gs[CM];
    for (int t = 0; t < C; ++t) gs[t] = g[sorder[t]];
    // greedy pass in sorted order: left iff al <= ar of the group so far
    bool left[CM];
    for (int t = 0; t < C; ++t) {
      double al = 0.0, ar = 0.0;
      for (int t2 = 0; t2 < t; ++t2) {
        if (gs[t2] != gs[t]) continue;
        if (left[t2]) al = add(al, contrib[t2]);
        else ar = add(ar, contrib[t2]);
      }
      left[t] = al <= ar;
    }
    // each position's group totals, folded in sorted order
    for (int j = 0; j < C; ++j) {
      double al = 0.0, ar = 0.0;
      int cnt = 0;
      for (int t2 = 0; t2 < C; ++t2) {
        if (gs[t2] != g[j]) continue;
        if (left[t2]) al = add(al, contrib[t2]);
        else ar = add(ar, contrib[t2]);
        cnt += valid_s[t2];
      }
      const double den = add(al, ar);
      const double frac = dvd(al, den > 0 ? den : 1.0);
      const bool split = cnt >= 2 && j < m, goleft = left[inv[j]];
      double& pos = level % 2 == 0 ? bx[j] : by[j];
      double& len = level % 2 == 0 ? bw[j] : bh[j];
      const double cut = mul(len, frac);
      if (split && !goleft) pos = add(pos, cut);
      if (split) len = goleft ? cut : sub(len, cut);
      g[j] = split ? g[j] * 2 + (goleft ? 0 : 1) : g[j] * 2;
    }
  }
  double width = -INFINITY, height = -INFINITY;
  for (int j = 0; j < C && j < m; ++j) {
    const double w = add(bx[j], bw[j]), h = add(by[j], bh[j]);
    if (w > width) width = w;
    if (h > height) height = h;
  }
  const double bbox = mul(width, height);

  // -- links: plane pairs (j1 < j2, in order), then chain bonds ----------
  int lid[CM][CM];                  // link id + 1 from slot a to slot b
  for (int s1 = 0; s1 < C; ++s1)
    for (int s2 = 0; s2 < C; ++s2) lid[s1][s2] = 0;
  double* link_bw = o.link_bw + p * L;
  double* link_e = o.link_e + p * L;
  const double r25 = mul(rate25, 1e9);
  for (int j1 = 0, k = 0; j1 < C; ++j1) {
    for (int j2 = j1 + 1; j2 < C; ++j2, ++k) {
      double edge = 0.0;
      if (plane_row && j2 < m) {
        const double x1 = bx[j1], y1 = by[j1], w1 = bw[j1], h1 = bh[j1];
        const double x2 = bx[j2], y2 = by[j2], w2 = bw[j2], h2 = bh[j2];
        const bool cond_v = fabs(sub(add(x1, w1), x2)) < kTol ||
                            fabs(sub(add(x2, w2), x1)) < kTol;
        const bool cond_h = fabs(sub(add(y1, h1), y2)) < kTol ||
                            fabs(sub(add(y2, h2), y1)) < kTol;
        if (cond_v) {
          const double lo = y1 > y2 ? y1 : y2;
          const double hi = tmin(add(y1, h1), add(y2, h2));
          edge = hi > lo ? sub(hi, lo) : 0.0;
        } else if (cond_h) {
          const double lo = x1 > x2 ? x1 : x2;
          const double hi = tmin(add(x1, w1), add(x2, w2));
          edge = hi > lo ? sub(hi, lo) : 0.0;
        }
      }
      if (edge > kTol) {
        double bwk = bumps_bw(edge, r25, pitch25, eta25);
        // Eq. 6: each endpoint's perimeter caps the bumps
        bwk = tmin(bwk, bumps_bw(mul(4.0, __dsqrt_rn(ar_p[j1])), r25,
                                 pitch25, eta25));
        bwk = tmin(bwk, bumps_bw(mul(4.0, __dsqrt_rn(ar_p[j2])), r25,
                                 pitch25, eta25));
        link_bw[k] = bwk;
        link_e[k] = ebit25;
        lid[porder[j1]][porder[j2]] += k + 1;
      } else {
        link_bw[k] = INFINITY;
        link_e[k] = 0.0;
      }
    }
  }
  for (int t = 0; t + 1 < C; ++t) {
    const int k = n_plane + t;
    const bool exists = t + 1 < chain_len && bonded;
    link_bw[k] = exists ? cbw[t] : INFINITY;
    link_e[k] = exists ? ebit3 : 0.0;
    if (exists) lid[chain[t]][chain[t + 1]] += k + 1;
  }
  // the id of the link between two slots, either way round, or -1
  for (int s1 = 0; s1 < C; ++s1) {
    for (int s2 = s1 + 1; s2 < C; ++s2) {
      const int both = lid[s1][s2] + lid[s2][s1] - 1;
      lid[s1][s2] = lid[s2][s1] = both;
    }
    lid[s1][s1] = 2 * lid[s1][s1] - 1;
  }

  // -- DRAM attach: planar shares, base-die-mediated chain (Eqs. 8-10) ---
  const double den_tot = tot > 0 ? tot : 1.0;
  const double base_bw0 =
      ishyb ? dvd(mul(memtot, ar_p[n_nonmem < C - 1 ? n_nonmem : C - 1]),
                  den_tot)
            : memtot;
  double chain_val[CM];
  chain_val[0] = chain_len > 0 && is3d ? memtot : 0.0;
  double cmin = INFINITY;
  for (int t = 0; t + 1 < C; ++t) {
    cmin = tmin(cmin, cbw[t]);            // inf where the bond is absent
    chain_val[t + 1] = t + 1 < chain_len && bonded ? tmin(base_bw0, cmin)
                                                   : 0.0;
  }
  for (int s = 0; s < C; ++s) {
    double plane = 0.0, chained = 0.0, dram = 0.0;
    for (int j = 0; j < C; ++j)
      if (porder[j] == s)
        plane = add(plane, j < m && plane_row
                               ? dvd(mul(memtot, ar_p[j]), den_tot) : 0.0);
    for (int t = 0; t < C; ++t) {
      if (chain[t] != s) continue;
      chained = add(chained, chain_val[t]);
      dram = add(dram, t >= 1 && t < chain_len && bonded
                           ? mul((double)t, ebit3) : 0.0);
    }
    o.eff_bw[p * C + s] = s == 0 && is2d ? memtot : add(plane, chained);
    o.dram_e[p * C + s] = dram;
  }

  // -- reduction routes: a BFS from each source, queue-order ties --------
  int dest = 0;
  double best = 0 < n ? area[0] : -1.0;
  for (int c = 1; c < C; ++c) {
    const double x = c < n ? area[c] : -1.0;
    if (x > best) {
      best = x;
      dest = c;
    }
  }
  for (int s = 0; s < C; ++s) {
    // ranks in discovery order; a node's parent is the node it was found
    // from, neighbours taken in ascending slot order
    int rank[CM], prev[CM];
    for (int c = 0; c < C; ++c) {
      rank[c] = kUnreached;
      prev[c] = -1;
    }
    rank[s] = 0;
    prev[s] = s;
    int counter = 1;
    for (int k = 0; k < levels; ++k) {
      int u = -1;
      for (int c = 0; c < C; ++c)
        if (rank[c] == k) {
          u = c;
          break;
        }
      if (u < 0) break;                   // no rank k, so none above it
      for (int c = 0; c < C; ++c)
        if (lid[u][c] >= 0 && rank[c] == kUnreached) {
          prev[c] = u;
          rank[c] = counter++;
        }
    }
    double* inc = o.inc + (p * C + s) * L;
    for (int l = 0; l < L; ++l) inc[l] = 0.0;
    int64_t hops = 0, hops3 = 0;
    const bool route_on = !is2d && s < n && s != dest;
    for (int node = dest, step = 0; step < C - 1; ++step) {
      const int pu = prev[node];
      if (!(route_on && node != s && pu >= 0)) break;
      const int lk = lid[pu][node];
      if (lk >= 0 && lk < L) inc[lk] = add(inc[lk], 1.0);
      ++hops;
      if (a.split_hops3 && lk >= n_plane) ++hops3;
      node = pu;
    }
    o.hops[p * C + s] = hops;
    o.hops3[p * C + s] = hops3;
  }

  // -- package terms and the bonding tail's inputs (Eqs. 15-16, 2) -------
  const double n_f = (double)n, m_f = (double)m, cl_f = (double)chain_len;
  const double acost = a.acost;
  o.assembly[p] =
      is2d ? acost
      : is25 ? mul(mul(n_f, acost), scale25)
      : is3d ? mul(mul(n_f, acost), scale3)
             : add(mul(mul(m_f, acost), scale25),
                   mul(mul(cl_f, acost), scale3));
  o.pkg_area[p] = is2d ? area[0] : (is3d ? a_chain[0] : bbox);
  o.interp[p] = plane_row && a.p25_interp[i25] != 0;
  o.p25_rate[p] = plane_row ? cfp25 : 0.0;
  o.is2d[p] = is2d;
  o.dest[p] = dest;
  for (int t = 0; t < C; ++t)
    o.a_bond[p * C + t] = t >= 1 && t < chain_len ? a_chain[t] : 0.0;
  double* rf = o.row_f + p * 6;
  rf[0] = n_f;
  rf[1] = m_f;
  rf[2] = cl_f;
  rf[3] = y25;
  rf[4] = y3;
  rf[5] = cfp3;
  uint8_t* rb = o.row_b + p * 3;
  rb[0] = is25;
  rb[1] = is3d;
  rb[2] = ishyb;
}

template <int CT>
void launch(const Args& a, cudaStream_t s) {
  const int blocks = (int)(((int64_t)a.P + kThreads - 1) / kThreads);
  topology_kernel<CT><<<blocks, kThreads, 0, s>>>(a);
}

}  // namespace

extern "C" int topology_launch(const void* v, int W, const void* areas,
                               int P, int C, const void* m_bw, int M,
                               const void* p25, const void* p25_interp,
                               int n25, const void* p3, int n3, double acost,
                               int split_hops3, const int* layout,
                               void* const* outs, void* stream) {
  if (P <= 0 || C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  Args a{};
  a.v = (const int64_t*)v;
  a.W = W;
  a.areas = (const double*)areas;
  a.P = P;
  a.C = C;
  a.m_bw = (const double*)m_bw;
  a.M = M;
  a.p25 = (const double*)p25;
  a.p25_interp = (const uint8_t*)p25_interp;
  a.n25 = n25;
  a.p3 = (const double*)p3;
  a.n3 = n3;
  a.acost = acost;
  a.split_hops3 = split_hops3;
  a.col = Layout{layout[0], layout[1], layout[2], layout[3], layout[4],
                 layout[5], layout[6], layout[7], layout[8], layout[9]};
  Out& o = a.out;
  o.eff_bw = (double*)outs[0];
  o.dram_e = (double*)outs[1];
  o.hops = (int64_t*)outs[2];
  o.hops3 = (int64_t*)outs[3];
  o.link_bw = (double*)outs[4];
  o.link_e = (double*)outs[5];
  o.inc = (double*)outs[6];
  o.pkg_area = (double*)outs[7];
  o.assembly = (double*)outs[8];
  o.p25_rate = (double*)outs[9];
  o.interp = (uint8_t*)outs[10];
  o.is2d = (uint8_t*)outs[11];
  o.dest = (int64_t*)outs[12];
  o.a_bond = (double*)outs[13];
  o.row_f = (double*)outs[14];
  o.row_b = (uint8_t*)outs[15];
  cudaStream_t s = (cudaStream_t)stream;
  static_assert(kMaxUnrolled == 8, "a case for every unrolled C");
  switch (C) {
    case 1: launch<1>(a, s); break;
    case 2: launch<2>(a, s); break;
    case 3: launch<3>(a, s); break;
    case 4: launch<4>(a, s); break;
    case 5: launch<5>(a, s); break;
    case 6: launch<6>(a, s); break;
    case 7: launch<7>(a, s); break;
    case 8: launch<8>(a, s); break;
    default: launch<kMaxC>(a, s); break;
  }
  return (int)cudaGetLastError();
}
