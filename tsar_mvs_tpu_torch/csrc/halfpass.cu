// Kernel B6: PatchMatch's checkerboard half-pass around the cost kernel.
//
// Replaces the XLA work the JAX package fuses around its cost kernel in
// one jitted PatchMatch step (tsar_mvs_tpu/models/patchmatch.py:258
// _propagation_pass, :347 _refinement_pass and its scale_body :397, :470
// make_patchmatch_step; tsar_mvs_tpu/ops/checkerboard.py:96
// select_candidates with parity_compress/parity_expand :164, :173), which
// the port ran eagerly as some 650 torch ops a propagation half-pass and
// 55 a refine scale. Four kernels, one thread a pixel of the updating
// grid: the packed (H, W/2) parity class, or the dense (H, W) grid with
// a parity mask when a side is odd.
//
//   halfpass_prop_select_kernel   each bank's stored-cost argmin sample
//                                 (first sample wins a tie, out of bounds
//                                 costs +inf and carries the zero plane),
//                                 the candidates' planes, valid flags and
//                                 plane scalars s0, sx, sy for the cost
//                                 kernel (B1 or B3);
//   halfpass_prop_accept_kernel   the depth range check and the
//                                 sequential accept over the banks, written
//                                 in place into the full state;
//   halfpass_refine_propose_kernel one refine scale's proposal from the
//                                 draws the wrapper made (torch.rand), with
//                                 its plane scalars;
//   halfpass_refine_accept_kernel cost < stored cost, in place.
//
// Bound: bytes. Each kernel reads the state at its pixels (and the bank
// samples' costs, mostly from L1/L2), writes candidates or proposals once
// and reads them once more; a few dozen float operations a pixel and
// bank. Every float step is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __frcp_rn, __fsqrt_rn) in the order of the plain version
// (ops/halfpass.py), so nvcc cannot contract it into FMAs and the kernel
// equals the plain version to the bit; range checks are explicit compares
// so that NaN depths (d = 0 padding) fail them as torch's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBanks = 8;
constexpr int kMaxSamples = 11;

// consts (device, 13 floats): f, baseline, cx, cy, alpha, depth_min,
// depth_max, k0 (3), k1 (3).
enum { kF = 0, kBase, kCx, kCy, kAlpha, kDmin, kDmax, kK0, kK1 = kK0 + 3 };

struct Banks {
  int n;
  int len[kMaxBanks];
  signed char dx[kMaxBanks][kMaxSamples];
  signed char dy[kMaxBanks][kMaxSamples];
};

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// Dense coordinates of grid position i (rows of Wc positions).
__device__ __forceinline__ void grid_xy(int i, int Wc, int parity,
                                        int packed, int* y, int* x) {
  *y = i / Wc;
  const int j = i - *y * Wc;
  *x = packed ? 2 * j + ((parity + *y) & 1) : j;
}

// geo.depth_from_plane: (-d * f) / ((n0 (x - cx) + n1 (y - cy) alpha) +
// n2 f).
__device__ __forceinline__ float depth_at(float n0, float n1, float n2,
                                          float d, float xm, float ym,
                                          float f, float alpha) {
  const float den = __fadd_rn(
      __fadd_rn(__fmul_rn(n0, xm), __fmul_rn(__fmul_rn(n1, ym), alpha)),
      __fmul_rn(n2, f));
  return __fdiv_rn(__fmul_rn(-d, f), den);
}

__global__ void __launch_bounds__(kThreads) halfpass_prop_select_kernel(
    const float* __restrict__ normal, const float* __restrict__ d,
    const float* __restrict__ cost, int H, int W, int Wc, int parity,
    int packed, const float* __restrict__ rays,
    const float* __restrict__ consts, Banks banks,
    float* __restrict__ cand_n, float* __restrict__ cand_d,
    unsigned char* __restrict__ valid, float* __restrict__ s0,
    float* __restrict__ sx, float* __restrict__ sy) {
  const int n = H * Wc;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int y, x;
  grid_xy(i, Wc, parity, packed, &y, &x);
  const float r0 = rays[3 * i], r1 = rays[3 * i + 1], r2 = rays[3 * i + 2];
  const float k00 = consts[kK0], k01 = consts[kK0 + 1],
              k02 = consts[kK0 + 2];
  const float k10 = consts[kK1], k11 = consts[kK1 + 1],
              k12 = consts[kK1 + 2];
  for (int b = 0; b < banks.n; ++b) {
    float best_c = INFINITY;
    int best = -1;
    for (int s = 0; s < banks.len[b]; ++s) {
      const int qx = x + banks.dx[b][s], qy = y + banks.dy[b][s];
      const bool in = qx >= 0 && qx < W && qy >= 0 && qy < H;
      const int q = qy * W + qx;
      const float c = in ? __ldg(cost + q) : INFINITY;
      // The first sample initialises the bank (even at NaN or +inf);
      // later ones replace it only when strictly cheaper.
      if (s == 0 || c < best_c) {
        best_c = c;
        best = in ? q : -1;
      }
    }
    float n0 = 0.f, n1 = 0.f, n2 = 0.f, dd = 0.f;
    if (best >= 0) {
      n0 = __ldg(normal + 3 * best);
      n1 = __ldg(normal + 3 * best + 1);
      n2 = __ldg(normal + 3 * best + 2);
      dd = __ldg(d + best);
    }
    const float inv_d = __frcp_rn(dd);
    const int o = b * n + i;
    cand_n[3 * o] = n0;
    cand_n[3 * o + 1] = n1;
    cand_n[3 * o + 2] = n2;
    cand_d[o] = dd;
    valid[o] = isfinite(best_c) ? 1 : 0;
    s0[o] = __fmul_rn(dot3(n0, n1, n2, r0, r1, r2), inv_d);
    sx[o] = __fmul_rn(dot3(n0, n1, n2, k00, k01, k02), inv_d);
    sy[o] = __fmul_rn(dot3(n0, n1, n2, k10, k11, k12), inv_d);
  }
}

__global__ void __launch_bounds__(kThreads) halfpass_prop_accept_kernel(
    float* __restrict__ normal, float* __restrict__ d,
    float* __restrict__ cost, float* __restrict__ ratio,
    int* __restrict__ best_view, int H, int W, int Wc, int parity,
    int packed, const float* __restrict__ cand_n,
    const float* __restrict__ cand_d,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ mv_cost, const float* __restrict__ mv_ratio,
    const int* __restrict__ mv_view, int n_banks,
    const float* __restrict__ consts) {
  const int n = H * Wc;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int y, x;
  grid_xy(i, Wc, parity, packed, &y, &x);
  if (!packed && ((x + y) & 1) != parity) return;
  const float f = consts[kF], alpha = consts[kAlpha];
  const float dmin = consts[kDmin], dmax = consts[kDmax];
  const float xm = __fsub_rn(static_cast<float>(x), consts[kCx]);
  const float ym = __fsub_rn(static_cast<float>(y), consts[kCy]);
  const int p = y * W + x;
  float best_c = cost[p];
  int take = -1;
  for (int b = 0; b < n_banks; ++b) {
    const int o = b * n + i;
    const float depth = depth_at(cand_n[3 * o], cand_n[3 * o + 1],
                                 cand_n[3 * o + 2], cand_d[o], xm, ym, f,
                                 alpha);
    const bool ok = valid[o] && depth >= dmin && depth <= dmax;
    const float c = ok ? mv_cost[o] : INFINITY;
    if (c < best_c) {
      best_c = c;
      take = o;
    }
  }
  if (take < 0) return;
  normal[3 * p] = cand_n[3 * take];
  normal[3 * p + 1] = cand_n[3 * take + 1];
  normal[3 * p + 2] = cand_n[3 * take + 2];
  d[p] = cand_d[take];
  cost[p] = best_c;
  ratio[p] = mv_ratio[take];
  best_view[p] = mv_view[take];
}

struct RefineScale {
  float min_disp, max_disp, delta_z, neg_delta_n, two_delta_n, eps;
};

__global__ void __launch_bounds__(kThreads) halfpass_refine_propose_kernel(
    const float* __restrict__ normal, const float* __restrict__ d, int H,
    int W, int Wc, int parity, int packed, const float* __restrict__ rays,
    const float* __restrict__ vv, const float* __restrict__ u,
    const float* __restrict__ r, const float* __restrict__ consts,
    RefineScale sc, float* __restrict__ n_new, float* __restrict__ d_new,
    float* __restrict__ s0, float* __restrict__ sx,
    float* __restrict__ sy) {
  const int n = H * Wc;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int y, x;
  grid_xy(i, Wc, parity, packed, &y, &x);
  const int p = y * W + x;
  const float f = consts[kF], alpha = consts[kAlpha];
  const float xm = __fsub_rn(static_cast<float>(x), consts[kCx]);
  const float ym = __fsub_rn(static_cast<float>(y), consts[kCy]);
  const float fb = __fmul_rn(f, consts[kBase]);
  const float c0 = normal[3 * p], c1 = normal[3 * p + 1],
              c2 = normal[3 * p + 2];
  const float depth_now = depth_at(c0, c1, c2, d[p], xm, ym, f, alpha);
  const float disp_now = __fdiv_rn(fb, depth_now);
  // torch.clamp(v, max=z) keeps a NaN v; so do these compares.
  float lo = __fadd_rn(disp_now, sc.min_disp);
  lo = -(lo > sc.delta_z ? sc.delta_z : lo);
  float hi = __fsub_rn(sc.max_disp, disp_now);
  hi = hi > sc.delta_z ? sc.delta_z : hi;
  const float dz = __fadd_rn(lo, __fmul_rn(u[i], __fsub_rn(hi, lo)));
  float disp = __fadd_rn(disp_now, dz);
  disp = disp < sc.min_disp ? sc.min_disp : disp;
  disp = disp > sc.max_disp ? sc.max_disp : disp;
  const float depth_new = __fdiv_rn(fb, disp);
  const float v0 = __fadd_rn(c0, __fadd_rn(__fmul_rn(sc.two_delta_n, r[3 * i]),
                                           sc.neg_delta_n));
  const float v1 = __fadd_rn(
      c1, __fadd_rn(__fmul_rn(sc.two_delta_n, r[3 * i + 1]), sc.neg_delta_n));
  const float v2 = __fadd_rn(
      c2, __fadd_rn(__fmul_rn(sc.two_delta_n, r[3 * i + 2]), sc.neg_delta_n));
  const float inv = __frcp_rn(
      __fsqrt_rn(__fadd_rn(dot3(v0, v1, v2, v0, v1, v2), sc.eps)));
  float m0 = __fmul_rn(v0, inv), m1 = __fmul_rn(v1, inv),
        m2 = __fmul_rn(v2, inv);
  if (dot3(m0, m1, m2, vv[3 * i], vv[3 * i + 1], vv[3 * i + 2]) > 0.f) {
    m0 = -m0;
    m1 = -m1;
    m2 = -m2;
  }
  const float nr = dot3(m0, m1, m2, rays[3 * i], rays[3 * i + 1],
                        rays[3 * i + 2]);
  const float dn = __fmul_rn(-depth_new, nr);
  const float inv_d = __frcp_rn(dn);
  n_new[3 * i] = m0;
  n_new[3 * i + 1] = m1;
  n_new[3 * i + 2] = m2;
  d_new[i] = dn;
  s0[i] = __fmul_rn(nr, inv_d);
  sx[i] = __fmul_rn(dot3(m0, m1, m2, consts[kK0], consts[kK0 + 1],
                         consts[kK0 + 2]), inv_d);
  sy[i] = __fmul_rn(dot3(m0, m1, m2, consts[kK1], consts[kK1 + 1],
                         consts[kK1 + 2]), inv_d);
}

__global__ void __launch_bounds__(kThreads) halfpass_refine_accept_kernel(
    float* __restrict__ normal, float* __restrict__ d,
    float* __restrict__ cost, float* __restrict__ ratio,
    int* __restrict__ best_view, int H, int W, int Wc, int parity,
    int packed, const float* __restrict__ n_new,
    const float* __restrict__ d_new, const float* __restrict__ mv_cost,
    const float* __restrict__ mv_ratio, const int* __restrict__ mv_view) {
  const int n = H * Wc;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int y, x;
  grid_xy(i, Wc, parity, packed, &y, &x);
  if (!packed && ((x + y) & 1) != parity) return;
  const int p = y * W + x;
  const float c = mv_cost[i];
  if (!(c < cost[p])) return;
  normal[3 * p] = n_new[3 * i];
  normal[3 * p + 1] = n_new[3 * i + 1];
  normal[3 * p + 2] = n_new[3 * i + 2];
  d[p] = d_new[i];
  cost[p] = c;
  ratio[p] = mv_ratio[i];
  best_view[p] = mv_view[i];
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// bank_dxdy: n_banks x kMaxSamples (dx, dy) pairs, bank_len[b] of them
// used. Returns the launch's error code.
int tsar_halfpass_prop_select(const void* normal, const void* d,
                              const void* cost, int H, int W, int Wc,
                              int parity, int packed, const void* rays,
                              const void* consts, const int* bank_dxdy,
                              const int* bank_len, int n_banks,
                              void* cand_n, void* cand_d, void* valid,
                              void* s0, void* sx, void* sy, void* stream) {
  if (n_banks < 1 || n_banks > kMaxBanks) return cudaErrorInvalidValue;
  Banks banks;
  banks.n = n_banks;
  for (int b = 0; b < n_banks; ++b) {
    if (bank_len[b] < 1 || bank_len[b] > kMaxSamples)
      return cudaErrorInvalidValue;
    banks.len[b] = bank_len[b];
    for (int s = 0; s < bank_len[b]; ++s) {
      banks.dx[b][s] = static_cast<signed char>(
          bank_dxdy[2 * (b * kMaxSamples + s)]);
      banks.dy[b][s] = static_cast<signed char>(
          bank_dxdy[2 * (b * kMaxSamples + s) + 1]);
    }
  }
  halfpass_prop_select_kernel<<<blocks_for(H * Wc), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(normal), static_cast<const float*>(d),
      static_cast<const float*>(cost), H, W, Wc, parity, packed,
      static_cast<const float*>(rays), static_cast<const float*>(consts),
      banks, static_cast<float*>(cand_n), static_cast<float*>(cand_d),
      static_cast<unsigned char*>(valid), static_cast<float*>(s0),
      static_cast<float*>(sx), static_cast<float*>(sy));
  return cudaGetLastError();
}

int tsar_halfpass_prop_accept(void* normal, void* d, void* cost, void* ratio,
                              void* best_view, int H, int W, int Wc,
                              int parity, int packed, const void* cand_n,
                              const void* cand_d, const void* valid,
                              const void* mv_cost, const void* mv_ratio,
                              const void* mv_view, int n_banks,
                              const void* consts, void* stream) {
  halfpass_prop_accept_kernel<<<blocks_for(H * Wc), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(normal), static_cast<float*>(d),
      static_cast<float*>(cost), static_cast<float*>(ratio),
      static_cast<int*>(best_view), H, W, Wc, parity, packed,
      static_cast<const float*>(cand_n), static_cast<const float*>(cand_d),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(mv_cost), static_cast<const float*>(mv_ratio),
      static_cast<const int*>(mv_view), n_banks,
      static_cast<const float*>(consts));
  return cudaGetLastError();
}

int tsar_halfpass_refine_propose(const void* normal, const void* d, int H,
                                 int W, int Wc, int parity, int packed,
                                 const void* rays, const void* vv,
                                 const void* u, const void* r,
                                 const void* consts, float min_disp,
                                 float max_disp, float delta_z,
                                 float neg_delta_n, float two_delta_n,
                                 float eps, void* n_new, void* d_new,
                                 void* s0, void* sx, void* sy, void* stream) {
  const RefineScale sc{min_disp, max_disp, delta_z, neg_delta_n, two_delta_n,
                       eps};
  halfpass_refine_propose_kernel<<<blocks_for(H * Wc), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(normal), static_cast<const float*>(d), H, W,
      Wc, parity, packed, static_cast<const float*>(rays),
      static_cast<const float*>(vv), static_cast<const float*>(u),
      static_cast<const float*>(r), static_cast<const float*>(consts), sc,
      static_cast<float*>(n_new), static_cast<float*>(d_new),
      static_cast<float*>(s0), static_cast<float*>(sx),
      static_cast<float*>(sy));
  return cudaGetLastError();
}

int tsar_halfpass_refine_accept(void* normal, void* d, void* cost,
                                void* ratio, void* best_view, int H, int W,
                                int Wc, int parity, int packed,
                                const void* n_new, const void* d_new,
                                const void* mv_cost, const void* mv_ratio,
                                const void* mv_view, void* stream) {
  halfpass_refine_accept_kernel<<<blocks_for(H * Wc), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(normal), static_cast<float*>(d),
      static_cast<float*>(cost), static_cast<float*>(ratio),
      static_cast<int*>(best_view), H, W, Wc, parity, packed,
      static_cast<const float*>(n_new), static_cast<const float*>(d_new),
      static_cast<const float*>(mv_cost), static_cast<const float*>(mv_ratio),
      static_cast<const int*>(mv_view));
  return cudaGetLastError();
}

}  // extern "C"
