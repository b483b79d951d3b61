// Bilaterally weighted NCC cost of candidate planes against the epipolar
// s-volumes of all source views, with the streaming top-2 aggregation
// over the views, in one launch (kernel B1).
//
// Replaces the TPU kernel `_svol_ncc_kernel`
// (tsar_mvs_tpu/ops/pallas_ncc.py, launched per view by
// `svolume_cost_pallas` from `multiview_cost_pallas`). Per view its
// semantics are those of the oracle
// `tsar_mvs_tpu/ops/svolume.py::svolume_cost_ab`: for window offset
// (i, j) (i, j in [-hrad, hrad] x [-vrad, vrad], stride inc)
//
//   t = clip((s0 + i*sx + j*sy - s_lo) * inv_ds, 0, S-1)
//   k = floor(min(t, S-2)),  f = t - k
//   sample = V[k](yc, xc) + (V[k+1](yc, xc) - V[k](yc, xc)) * f - centre
//
// at the clamped dense pixel (yc, xc) = (clamp(y+j), clamp(x+i)), then the
// weighted moments of the centred samples and the NCC epilogue: cost =
// clip(1 - cov * rsqrt(var_ref * var_src), 0, cost_max), and cost_max
// where either variance is below min_var. A candidate whose plane scalars
// give a non-finite t at any offset (the d = 0 padding of border banks)
// costs cost_max. Over the views it keeps the running best and second
// best cost as `ncc.aggregate_streaming` does (strict <, so the earlier
// view wins a tie; second = best with one view) and writes cost = best,
// ratio = best / second and the best view's id, or ratio 0 and id -1
// where no view is below MAXCOST.
//
// What bounds it on Hopper. The TPU kernel walked each tile's s-bracket
// with hat functions because a v5e cannot gather; Hopper can, so a thread
// owns one pixel of the (packed or dense) grid and reads the two
// bracketing planes of every window sample straight from the dense
// (S, H, W) bf16 volumes. Per pixel the function must move 288 bytes of
// weights and centred reference values, 16 bytes of statistics and 24
// bytes per candidate, and the volume bytes its planes touch: few for a
// smooth plane field, but every 2-byte read its own 32-byte sector for an
// incoherent one (random initialisation, the first iterations of the
// coarsest level, each iteration's widest refine scale). With 4 or 8
// candidates on a smooth field the about 21 float operations per sample,
// view and candidate (each rounded on its own, so no fused multiply-add)
// outweigh the bytes. On the main path the incoherent launches take most
// of the kernel's time.
//
// What the design does about it:
// - all source views in one launch: the view loop runs inside the thread,
//   so the 288 bytes per pixel come from device memory once per
//   evaluation (later views re-read them through L1) instead of once per
//   view, the per-view costs never reach device memory (the top-2 runs in
//   registers), and an evaluation is 1 launch instead of 7 launches and
//   about 40 small aggregation kernels;
// - the kernel is a template on the candidate count, so per-candidate
//   state is indexed statically and stays in registers, and the C = 1
//   launches (the refinement pass: five of every six) get a lean kernel;
// - a non-finite plane coordinate is handled without a branch and the
//   default window's inner loop is unrolled, so the 12 * C volume loads of
//   a window column are in flight together;
// - blocks are 2-D (32 columns x 16 rows of the grid for 1 or 2
//   candidates, 32 x 8 above: constants of the candidate count, chosen
//   by measurement), so the window rows a block reads are shared in L1
//   across y as well as x, and on an incoherent field the sectors one
//   thread fetched serve its neighbours in the views with few planes;
//   volume reads go through the read-only path.
// Parking each thread's 36 (weight, reference) pairs in shared memory was
// measured and left out: it is faster on a smooth full-resolution field
// but caps a multiprocessor at 24 warps, and the main path's B1 time as a
// whole was a third longer with it. Staging the s-bracket in shared memory
// was left out as well: the smooth field's time follows the sample count,
// not the volume bytes, and an incoherent field's bracket does not fit.
// An incoherent field sits on the card's sector rate instead: every 2-byte
// read is its own 32-byte sector, and the seven volumes of one launch
// share the L2 that a per-view launch had to itself.
// The arithmetic keeps the plain version's order and rounds every step, so
// kernel and plain version agree to the bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 8;
constexpr int MAX_V = 32;
constexpr float MAXCOST = 2.0f;

struct Views {
  const unsigned short* vol[MAX_V];  // (S_v, H, W) bf16 bits
  int planes[MAX_V];
  float inv_ds[MAX_V];
  int count;
};

struct Args {
  const float* s0;
  const float* sx;
  const float* sy;
  const float* weights;
  const float* ref_c;
  const float* mean_ref;
  const float* var_ref;
  const float* inv_wsum;
  const float* center;
  const int64_t* ids;
  float* cost;
  float* ratio;
  int* best_view;
  int Hc, Wc, H, W, parity, hrad, vrad, inc;
  float s_lo, cost_max, min_var;
};

// The register budget of the C-candidate kernel, as the most threads a
// block may have: the kernel is compiled to at most 65,536 /
// max_threads(C) registers a thread.
constexpr int max_threads(int C) { return C <= 2 ? 1024 : C <= 4 ? 512 : 256; }

// Threads of a block: BLOCK_X columns by block_rows(C) rows of the grid.
// Among the shapes tried on an H100, these took the least time over one
// view's launches of each candidate count.
constexpr int BLOCK_X = 32;
constexpr int block_rows(int C) { return C <= 2 ? 16 : 8; }

// C candidates; STD_WIN fixes the window to the default 11x11, stride 2
// (36 offsets), so that the loop down a window column unrolls and its
// 12 * C volume loads are in flight together.
template <int C, bool STD_WIN>
__global__ void __launch_bounds__(C <= 2 ? 1024 : (C <= 4 ? 512 : 256))
svol_ncc_multiview_kernel(const __grid_constant__ Args a,
                          const __grid_constant__ Views vw) {
  const int xp = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (xp >= a.Wc || y >= a.Hc) return;
  const int64_t plane = (int64_t)a.Hc * a.Wc;
  const int64_t pix = (int64_t)y * a.Wc + xp;
  // Dense column of this pixel: packed layouts hold x = 2*xp + (p+y)%2.
  const int x = a.parity < 0 ? xp : 2 * xp + ((a.parity + y) & 1);
  const int W = a.W, H = a.H;
  const int64_t vplane = (int64_t)H * W;
  const int hrad = STD_WIN ? 5 : a.hrad;
  const int vrad = STD_WIN ? 5 : a.vrad;
  const int inc = STD_WIN ? 2 : a.inc;

  const float cen = a.center[pix];
  const float invw = a.inv_wsum[pix];
  const float mr = a.mean_ref[pix];
  const float vr = a.var_ref[pix];

  float c_s0[C], c_sx[C], c_sy[C];
  float best[C], second[C];
  int bidx[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    c_s0[c] = a.s0[c * plane + pix];
    c_sx[c] = a.sx[c * plane + pix];
    c_sy[c] = a.sy[c * plane + pix];
    best[c] = second[c] = MAXCOST;
    bidx[c] = 0;
  }

  for (int v = 0; v < vw.count; ++v) {
    const unsigned short* __restrict__ vol = vw.vol[v];
    const float inv_ds = vw.inv_ds[v];
    const float s_max = (float)(vw.planes[v] - 1);
    const float k_max = (float)(vw.planes[v] - 2);
    float acc_s[C], acc_ss[C], acc_rs[C];
    unsigned bad = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) acc_s[c] = acc_ss[c] = acc_rs[c] = 0.0f;

    int o = 0;
#pragma unroll 1
    for (int i = -hrad; i <= hrad; i += inc) {
      const int xs = min(max(x + i, 0), W - 1);
#pragma unroll
      for (int j = -vrad; j <= vrad; j += inc, ++o) {
        const int ys = min(max(y + j, 0), H - 1);
        const float w = __ldg(a.weights + o * plane + pix);
        const float rc = __ldg(a.ref_c + o * plane + pix);
        const unsigned short* col = vol + (int64_t)ys * W + xs;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float s_o = __fadd_rn(
              __fadd_rn(c_s0[c], __fmul_rn((float)i, c_sx[c])),
              __fmul_rn((float)j, c_sy[c]));
          float t = __fmul_rn(__fsub_rn(s_o, a.s_lo), inv_ds);
          // A NaN or +-inf t marks the candidate and samples plane 0
          // (no branch, so the loads of a window row overlap); its cost
          // is replaced below.
          const bool finite = fabsf(t) <= 3.402823466e38f;
          bad |= finite ? 0u : 1u << c;
          t = fminf(fmaxf(finite ? t : 0.0f, 0.0f), s_max);
          const float k0 = floorf(fminf(t, k_max));
          const unsigned short* p = col + (int64_t)k0 * vplane;
          const float va = __uint_as_float((unsigned)__ldg(p) << 16);
          const float vb = __uint_as_float((unsigned)__ldg(p + vplane) << 16);
          const float src = __fsub_rn(
              __fadd_rn(va, __fmul_rn(__fsub_rn(vb, va), __fsub_rn(t, k0))),
              cen);
          const float ws = __fmul_rn(w, src);
          acc_s[c] = __fadd_rn(acc_s[c], ws);
          acc_ss[c] = __fadd_rn(acc_ss[c], __fmul_rn(ws, src));
          acc_rs[c] = __fadd_rn(acc_rs[c], __fmul_rn(ws, rc));
        }
      }
    }

    // Rounded step by step like the plain version: var_src cancels
    // catastrophically on flat windows, where a contracted multiply-add
    // would move it across min_var.
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float mean_src = __fmul_rn(acc_s[c], invw);
      const float var_src = __fsub_rn(__fmul_rn(acc_ss[c], invw),
                                      __fmul_rn(mean_src, mean_src));
      const float covar = __fsub_rn(__fmul_rn(acc_rs[c], invw),
                                    __fmul_rn(mr, mean_src));
      const float ncc = __fsub_rn(
          1.0f, __fmul_rn(covar, rsqrtf(fmaxf(__fmul_rn(vr, var_src),
                                              1e-30f))));
      float cost = fminf(fmaxf(ncc, 0.0f), a.cost_max);
      if (vr < a.min_var || var_src < a.min_var || ((bad >> c) & 1u))
        cost = a.cost_max;
      // Streaming top-2: the first view seeds best; a later view
      // replaces it only when strictly cheaper.
      if (v == 0) {
        best[c] = cost;
      } else if (cost < best[c]) {
        second[c] = best[c];
        best[c] = cost;
        bidx[c] = v;
      } else {
        second[c] = fminf(second[c], cost);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float snd = vw.count == 1 ? best[c] : second[c];
    const bool any_valid = best[c] < MAXCOST;
    a.cost[c * plane + pix] = best[c];
    a.ratio[c * plane + pix] = any_valid ? __fdiv_rn(best[c], snd) : 0.0f;
    a.best_view[c * plane + pix] = any_valid ? (int)a.ids[bidx[c]] : -1;
  }
}

template <int C, bool STD_WIN>
cudaError_t launch_window(const Args& a, const Views& vw,
                          cudaStream_t stream) {
  static_assert(BLOCK_X * block_rows(C) <= max_threads(C), "block too large");
  const dim3 block(BLOCK_X, block_rows(C));
  dim3 grid((a.Wc + block.x - 1) / block.x, (a.Hc + block.y - 1) / block.y);
  svol_ncc_multiview_kernel<C, STD_WIN><<<grid, block, 0, stream>>>(a, vw);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const Args& a, const Views& vw, cudaStream_t stream) {
  if (a.hrad == 5 && a.vrad == 5 && a.inc == 2)
    return launch_window<C, true>(a, vw, stream);
  return launch_window<C, false>(a, vw, stream);
}

}  // namespace

// s0, sx, sy: (C, Hc, Wc) f32 with 1 <= C <= 8; weights, ref_c:
// (offsets, Hc, Wc) f32; mean_ref, var_ref, inv_wsum, center: (Hc, Wc)
// f32; vols, planes, inv_ds: host arrays of V <= 32 device pointers to
// (S_v, H, W) bf16 volumes, their plane counts and 1 / ds_v; ids: (V,)
// int64 on the device; parity -1 for the dense grid (Hc, Wc) = (H, W),
// else 0/1 for the packed grid (H, W/2); cost, ratio: (C, Hc, Wc) f32;
// best_view: (C, Hc, Wc) int32. Returns cudaGetLastError().
extern "C" int tsar_svol_ncc_multiview(
    const void* s0, const void* sx, const void* sy, int C, int Hc, int Wc,
    const void* weights, const void* ref_c, const void* mean_ref,
    const void* var_ref, const void* inv_wsum, const void* center,
    const void* const* vols, const int* planes, const float* inv_ds, int V,
    const void* ids, int H, int W, float s_lo, int parity, int hrad,
    int vrad, int inc, float cost_max, float min_var, void* cost,
    void* ratio, void* best_view, void* stream) {
  if (C < 1 || C > MAX_C || V < 1 || V > MAX_V || inc < 1)
    return (int)cudaErrorInvalidValue;
  Views vw;
  vw.count = V;
  for (int v = 0; v < V; ++v) {
    if (planes[v] < 2) return (int)cudaErrorInvalidValue;
    vw.vol[v] = (const unsigned short*)vols[v];
    vw.planes[v] = planes[v];
    vw.inv_ds[v] = inv_ds[v];
  }
  Args a;
  a.s0 = (const float*)s0;
  a.sx = (const float*)sx;
  a.sy = (const float*)sy;
  a.weights = (const float*)weights;
  a.ref_c = (const float*)ref_c;
  a.mean_ref = (const float*)mean_ref;
  a.var_ref = (const float*)var_ref;
  a.inv_wsum = (const float*)inv_wsum;
  a.center = (const float*)center;
  a.ids = (const int64_t*)ids;
  a.cost = (float*)cost;
  a.ratio = (float*)ratio;
  a.best_view = (int*)best_view;
  a.Hc = Hc; a.Wc = Wc; a.H = H; a.W = W; a.parity = parity;
  a.hrad = hrad; a.vrad = vrad; a.inc = inc;
  a.s_lo = s_lo; a.cost_max = cost_max; a.min_var = min_var;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (C) {
    case 1: err = launch<1>(a, vw, st); break;
    case 2: err = launch<2>(a, vw, st); break;
    case 3: err = launch<3>(a, vw, st); break;
    case 4: err = launch<4>(a, vw, st); break;
    case 5: err = launch<5>(a, vw, st); break;
    case 6: err = launch<6>(a, vw, st); break;
    case 7: err = launch<7>(a, vw, st); break;
    default: err = launch<8>(a, vw, st); break;
  }
  return (int)err;
}
