// Bilaterally weighted NCC cost of candidate planes against one source
// view's epipolar s-volume (kernel B1).
//
// Replaces the TPU kernel `_svol_ncc_kernel`
// (tsar_mvs_tpu/ops/pallas_ncc.py, launched by `svolume_cost_pallas`).
// Its semantics are those of the oracle
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
// costs cost_max.
//
// The TPU kernel walked each tile's s-bracket with hat functions because a
// v5e cannot gather. Hopper can, so each thread owns one pixel of the
// (packed or dense) grid and reads its two bracketing planes directly from
// the dense (S, H, W) bf16 volume: no parity-split halo copies, no plane
// padding, no tiles, no candidate blocks.
//
// What bounds it on Hopper: per pixel, candidate and view it makes 72 bf16
// volume reads (two planes at 36 offsets) and reads the 36 f32 weights and
// 36 f32 centred reference values. The design reads each offset's weight
// and reference value once per pixel and reuses them across all
// candidates of the launch (up to MAX_C, held in registers), so those
// 288 bytes per pixel are paid once per view instead of once per
// candidate. The volume reads of neighbouring threads fall on neighbouring
// columns of the same plane rows, so they coalesce and mostly hit L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 8;

__global__ void svol_ncc_kernel(
    const float* __restrict__ s0, const float* __restrict__ sx,
    const float* __restrict__ sy, int C, int Hc, int Wc,
    const float* __restrict__ weights, const float* __restrict__ ref_c,
    const float* __restrict__ mean_ref, const float* __restrict__ var_ref,
    const float* __restrict__ inv_wsum, const float* __restrict__ center,
    const __nv_bfloat16* __restrict__ vol, int S, int H, int W,
    float s_lo, float inv_ds, int parity, int hrad, int vrad, int inc,
    float cost_max, float min_var, float* __restrict__ out) {
  const int xp = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (xp >= Wc) return;
  const int64_t plane = (int64_t)Hc * Wc;
  const int64_t pix = (int64_t)y * Wc + xp;
  // Dense column of this pixel: packed layouts hold x = 2*xp + (p+y)%2.
  const int x = parity < 0 ? xp : 2 * xp + ((parity + y) & 1);
  const float cen = center[pix];
  const float s_max = (float)(S - 1);
  const float k_max = (float)(S - 2);
  const int64_t vplane = (int64_t)H * W;

  float c_s0[MAX_C], c_sx[MAX_C], c_sy[MAX_C];
  float acc_s[MAX_C], acc_ss[MAX_C], acc_rs[MAX_C];
  bool bad[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) {
      c_s0[c] = s0[c * plane + pix];
      c_sx[c] = sx[c * plane + pix];
      c_sy[c] = sy[c * plane + pix];
    }
    acc_s[c] = acc_ss[c] = acc_rs[c] = 0.0f;
    bad[c] = false;
  }

  int o = 0;
  for (int i = -hrad; i <= hrad; i += inc) {
    const int xs = min(max(x + i, 0), W - 1);
    for (int j = -vrad; j <= vrad; j += inc, ++o) {
      const int ys = min(max(y + j, 0), H - 1);
      const float w = weights[o * plane + pix];
      const float rc = ref_c[o * plane + pix];
      const __nv_bfloat16* col = vol + (int64_t)ys * W + xs;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c >= C) break;
        const float s_o = __fadd_rn(__fadd_rn(c_s0[c],
                                              __fmul_rn((float)i, c_sx[c])),
                                    __fmul_rn((float)j, c_sy[c]));
        float t = __fmul_rn(__fsub_rn(s_o, s_lo), inv_ds);
        if (!(fabsf(t) <= 3.402823466e38f)) {  // NaN or +-inf
          bad[c] = true;
          continue;
        }
        t = fminf(fmaxf(t, 0.0f), s_max);
        const float k0 = floorf(fminf(t, k_max));
        const int64_t k = (int64_t)k0;
        const float a = __bfloat162float(col[k * vplane]);
        const float b = __bfloat162float(col[(k + 1) * vplane]);
        const float src = __fsub_rn(
            __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), __fsub_rn(t, k0))), cen);
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
  const float invw = inv_wsum[pix];
  const float mr = mean_ref[pix];
  const float vr = var_ref[pix];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c >= C) break;
    const float mean_src = __fmul_rn(acc_s[c], invw);
    const float var_src = __fsub_rn(__fmul_rn(acc_ss[c], invw),
                                    __fmul_rn(mean_src, mean_src));
    const float covar = __fsub_rn(__fmul_rn(acc_rs[c], invw),
                                  __fmul_rn(mr, mean_src));
    const float ncc = __fsub_rn(
        1.0f, __fmul_rn(covar, rsqrtf(fmaxf(__fmul_rn(vr, var_src),
                                            1e-30f))));
    float cost = fminf(fmaxf(ncc, 0.0f), cost_max);
    if (vr < min_var || var_src < min_var || bad[c]) cost = cost_max;
    out[c * plane + pix] = cost;
  }
}

}  // namespace

// s0, sx, sy: (C, Hc, Wc) f32 with C <= 8; weights, ref_c: (O, Hc, Wc)
// f32; mean_ref, var_ref, inv_wsum, center: (Hc, Wc) f32; vol: (S, H, W)
// bf16; parity -1 for the dense grid (Hc, Wc) = (H, W), else 0/1 for the
// packed grid (H, W/2); out: (C, Hc, Wc) f32. Returns cudaGetLastError().
extern "C" int tsar_svol_ncc(
    const void* s0, const void* sx, const void* sy, int C, int Hc, int Wc,
    const void* weights, const void* ref_c, const void* mean_ref,
    const void* var_ref, const void* inv_wsum, const void* center,
    const void* vol, int S, int H, int W, float s_lo, float inv_ds,
    int parity, int hrad, int vrad, int inc, float cost_max, float min_var,
    void* out, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  dim3 grid((Wc + threads - 1) / threads, Hc);
  svol_ncc_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)s0, (const float*)sx, (const float*)sy, C, Hc, Wc,
      (const float*)weights, (const float*)ref_c, (const float*)mean_ref,
      (const float*)var_ref, (const float*)inv_wsum, (const float*)center,
      (const __nv_bfloat16*)vol, S, H, W, s_lo, inv_ds, parity, hrad, vrad,
      inc, cost_max, min_var, (float*)out);
  return (int)cudaGetLastError();
}
