// Epipolar s-volume build for one source view (kernel B2).
//
// Replaces the TPU kernel `_warp_kernel` (tsar_mvs_tpu/ops/pallas_warp.py,
// launched by `build_volume_view_pallas`) and, unlike it, covers every
// view: it has the semantics of the gather build in
// `tsar_mvs_tpu/ops/svolume.py::build_svolume` (`one_view`), which the TPU
// ran whenever its warp plan was ineligible.
//
//   W(k, y, x) = bilinear(src, q),  q = (A p~ - b s) / (A p~ - b s)_z,
//   s = s_lo + k * ds,  p~ = (x, y, 1),
//
// with the source rounded to bf16 before interpolation (the caller passes
// it as bf16), interpolation in f32, coordinates clamped to
// [0, W-1] x [0, H-1], and the result rounded to bf16.
//
// What bounds it on Hopper: one thread per voxel writes 2 bytes and reads
// four bf16 corners. The corner reads are coherent (neighbouring x give
// neighbouring q), so they hit L1/L2 and the kernel is bound by the 2 bytes
// it writes per voxel: ~1.5 G voxels per view-set at the 2K point is
// ~3 GB, about a millisecond of HBM bandwidth. Hopper gathers in hardware,
// so the TPU kernel's hat-tap reconstruction over a DMA'd source window
// (needed there because a v5e cannot gather) has no counterpart here.
//
// The TPU kernel's eligibility gate existed only to bound that tap grid;
// this kernel has no gate. A NaN coordinate (w = 0) reads pixel 0 (fmaxf
// drops the NaN); an infinite one clamps to the border.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void warp_build_kernel(const __nv_bfloat16* __restrict__ src,
                                  int H, int W,
                                  const float* __restrict__ Ab,
                                  float s_lo, float ds, int S,
                                  __nv_bfloat16* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int k = blockIdx.z;
  if (x >= W) return;
  const float xf = (float)x, yf = (float)y;
  // u = A p~ and s, rounded step by step as the reference build does.
  const float u0 = __fadd_rn(__fadd_rn(__fmul_rn(Ab[0], xf),
                                       __fmul_rn(Ab[1], yf)), Ab[2]);
  const float u1 = __fadd_rn(__fadd_rn(__fmul_rn(Ab[3], xf),
                                       __fmul_rn(Ab[4], yf)), Ab[5]);
  const float u2 = __fadd_rn(__fadd_rn(__fmul_rn(Ab[6], xf),
                                       __fmul_rn(Ab[7], yf)), Ab[8]);
  const float s = __fadd_rn(s_lo, __fmul_rn((float)k, ds));
  const float w = __fsub_rn(u2, __fmul_rn(Ab[11], s));
  const float inv_w = __fdiv_rn(1.0f, w);
  float qx = __fmul_rn(__fsub_rn(u0, __fmul_rn(Ab[9], s)), inv_w);
  float qy = __fmul_rn(__fsub_rn(u1, __fmul_rn(Ab[10], s)), inv_w);
  qx = fminf(fmaxf(qx, 0.0f), (float)(W - 1));
  qy = fminf(fmaxf(qy, 0.0f), (float)(H - 1));
  const float x0 = floorf(qx), y0 = floorf(qy);
  const float fx = qx - x0, fy = qy - y0;
  const int xi = (int)x0, yi = (int)y0;
  const int xi1 = min(xi + 1, W - 1), yi1 = min(yi + 1, H - 1);
  const float v00 = __bfloat162float(src[(int64_t)yi * W + xi]);
  const float v01 = __bfloat162float(src[(int64_t)yi * W + xi1]);
  const float v10 = __bfloat162float(src[(int64_t)yi1 * W + xi]);
  const float v11 = __bfloat162float(src[(int64_t)yi1 * W + xi1]);
  const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), fx));
  const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), fx));
  const float val = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), fy));
  out[((int64_t)k * H + y) * W + x] = __float2bfloat16_rn(val);
}

}  // namespace

// src: (H, W) bf16; Ab: 12 f32 on the device, A row-major then b;
// out: (S, H, W) bf16. Returns cudaGetLastError() after the launch.
extern "C" int tsar_warp_build(const void* src, int H, int W,
                               const void* Ab, float s_lo, float ds, int S,
                               void* out, void* stream) {
  const int threads = 128;
  dim3 grid((W + threads - 1) / threads, H, S);
  warp_build_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)src, H, W, (const float*)Ab, s_lo, ds, S,
      (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}
