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
// What bounds it on Hopper: by bytes, the 2 bytes it writes per voxel
// (the source image, 5.5 MB as bf16 at 1344x2048, stays in L2). In fact
// the instruction rate bounds it: about 55 machine instructions a voxel
// for the plane-induced warp, the correctly rounded reciprocal, the
// clamps, four corner loads and the bilinear blend, each float step
// rounded on its own. Hopper gathers in hardware, so the TPU kernel's
// hat-tap reconstruction over a DMA'd source window (needed there because
// a v5e cannot gather) has no counterpart here.
//
// What the design does about it: a thread owns VX = 2 neighbouring x of
// one row and a run of KRUN = 32 planes. It computes u = A p~ for its
// pixels once (u does not depend on the plane), walks the planes in
// registers, takes the reciprocal with one intrinsic, indexes the source
// with 32-bit integers and stores each plane's two results as one 4-byte
// word, so a warp writes 128 contiguous bytes a plane. Wider threads (4
// or 8 x, 8- and 16-byte stores) were measured and are slower: the lanes
// of a warp then gather from corners 4 or 8 pixels apart, and the kernel
// was never bound by its stores. Every float step is rounded in the plain
// version's order, so kernel and plain version agree to the bit; the
// texture unit is not used (its 9-bit filter weights would break that).
//
// The TPU kernel's eligibility gate existed only to bound that tap grid;
// this kernel has no gate. A NaN coordinate (w = 0) reads pixel 0 (fmaxf
// drops the NaN); an infinite one clamps to the border.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VX = 2;     // neighbouring x per thread: one 4-byte store
constexpr int KRUN = 32;  // planes per thread

// Source pixel i as f32 (bf16 bits through the read-only path).
__device__ __forceinline__ float px(const unsigned short* __restrict__ src,
                                    int i) {
  return __uint_as_float((unsigned)__ldg(src + i) << 16);
}

__global__ void warp_build_kernel(const unsigned short* __restrict__ src,
                                  int H, int W,
                                  const float* __restrict__ Ab,
                                  float s_lo, float ds, int S,
                                  unsigned short* __restrict__ out) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * VX;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int k_begin = blockIdx.z * KRUN;
  if (x0 >= W || y >= H) return;
  float ab[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) ab[r] = __ldg(Ab + r);
  // u = A p~, rounded step by step as the reference build does.
  const float yf = (float)y;
  float u0[VX], u1[VX], u2[VX];
#pragma unroll
  for (int e = 0; e < VX; ++e) {
    const float xf = (float)(x0 + e);
    u0[e] = __fadd_rn(__fadd_rn(__fmul_rn(ab[0], xf), __fmul_rn(ab[1], yf)),
                      ab[2]);
    u1[e] = __fadd_rn(__fadd_rn(__fmul_rn(ab[3], xf), __fmul_rn(ab[4], yf)),
                      ab[5]);
    u2[e] = __fadd_rn(__fadd_rn(__fmul_rn(ab[6], xf), __fmul_rn(ab[7], yf)),
                      ab[8]);
  }
  // With an even W both pixels of every thread exist and its store is
  // 4-byte aligned.
  const bool vec = (W % VX) == 0;
  const float x_max = (float)(W - 1), y_max = (float)(H - 1);
  const int k_end = min(S, k_begin + KRUN);
  for (int k = k_begin; k < k_end; ++k) {
    const float s = __fadd_rn(s_lo, __fmul_rn((float)k, ds));
    const float bs0 = __fmul_rn(ab[9], s);
    const float bs1 = __fmul_rn(ab[10], s);
    const float bs2 = __fmul_rn(ab[11], s);
    unsigned short val[VX];
#pragma unroll
    for (int e = 0; e < VX; ++e) {
      if (!vec && x0 + e >= W) {
        val[e] = 0;
        continue;
      }
      // The correctly rounded reciprocal: the bits of 1.0f / w.
      const float inv_w = __frcp_rn(__fsub_rn(u2[e], bs2));
      float qx = __fmul_rn(__fsub_rn(u0[e], bs0), inv_w);
      float qy = __fmul_rn(__fsub_rn(u1[e], bs1), inv_w);
      qx = fminf(fmaxf(qx, 0.0f), x_max);
      qy = fminf(fmaxf(qy, 0.0f), y_max);
      const float xl = floorf(qx), yl = floorf(qy);
      const float fx = qx - xl, fy = qy - yl;
      const int xi = (int)xl, yi = (int)yl;
      const int xi1 = min(xi + 1, W - 1), yi1 = min(yi + 1, H - 1);
      const int r0 = yi * W, r1 = yi1 * W;
      const float v00 = px(src, r0 + xi), v01 = px(src, r0 + xi1);
      const float v10 = px(src, r1 + xi), v11 = px(src, r1 + xi1);
      const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), fx));
      const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), fx));
      val[e] = __bfloat16_as_ushort(__float2bfloat16_rn(
          __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), fy))));
    }
    unsigned short* dst = out + ((int64_t)k * H + y) * W + x0;
    if (vec) {
      *reinterpret_cast<unsigned*>(dst) = val[0] | ((unsigned)val[1] << 16);
    } else {
#pragma unroll
      for (int e = 0; e < VX; ++e)
        if (x0 + e < W) dst[e] = val[e];
    }
  }
}

}  // namespace

// src: (H, W) bf16; Ab: 12 f32 on the device, A row-major then b;
// out: (S, H, W) bf16. Returns cudaGetLastError() after the launch.
extern "C" int tsar_warp_build(const void* src, int H, int W,
                               const void* Ab, float s_lo, float ds, int S,
                               void* out, void* stream) {
  const dim3 block(64, 4);
  const int chunks = (W + VX - 1) / VX;
  dim3 grid((chunks + block.x - 1) / block.x, (H + block.y - 1) / block.y,
            (S + KRUN - 1) / KRUN);
  warp_build_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const unsigned short*)src, H, W, (const float*)Ab, s_lo, ds, S,
      (unsigned short*)out);
  return (int)cudaGetLastError();
}
