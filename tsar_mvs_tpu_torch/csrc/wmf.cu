// Weighted median plane of one WMF pass (kernel B4).
//
// Replaces the JAX package's XLA weighted median filter
// (tsar_mvs_tpu/ops/wmf.py: `_gather_samples`, `_weighted_median` and
// `_median_plane`, the rebuild of the reference's gipuma_WMF and
// gipuma_WMF_Final); the JAX package has no TPU kernel for it. Per pixel
// p and offset o of the pass's table (at most MAX_O):
//
//   w_o  = reliable(p+o) ? sf_o * exp(-|gray(p+o) - gray(p)| * inv_sc) : 0
//   key  = w_o > 0 ? value(p+o) : +inf   for disparity, nx, ny, nz
//
// (out-of-image samples are unreliable), then for each of the four keys
// the weighted median: the smallest key whose weight at or below it
// reaches half the total, found by a 32-step radix descent over the
// order-preserving uint32 image of the keys; for the disparity also the
// smallest sample index at the median key whose running weight reaches
// half (a descent over the index bits); and the count of valid samples.
// An all-invalid pixel has half = 0 and median key 0, the NaN whose bits
// are 0xFFFFFFFF, as the plain version gives.
//
// What bounds it on Hopper: operations. It reads about 21 bytes a pixel
// and writes 32 (146 MB a 1344x2048 pass, 0.04 ms at 3.35 TB/s; the
// 121-fold reuse of the fields comes from L1 and L2). The function needs
// about 5,000 float operations a pixel (kernel_times.b4_flops: a search
// over the sorted keys takes some 7 fixed-order sums a median), 0.2 ms
// at 67 TFLOP/s. This design's radix descents take 4 x 32 sums over 121
// samples, some 17,000 masked adds a pixel, before the compares, selects
// and shuffles that go with them.
//
// What the design does about it. A block owns TILE = 32 neighbouring
// pixels of one row. Phase 1: each warp takes every WARPS-th offset with
// one pixel a lane, so every load is one coalesced row read, computes the
// weight and the four keys and stages them in shared memory (one padded
// row of MAX_O samples a pixel). Phase 2: a pixel gets LANES = 8 lanes
// and each lane holds PER_LANE = 16 samples (offset o = s + LANES * j on
// lane s) in registers; the four descents run in lockstep, so each step
// adds four independent chains, and the lanes combine each sum in a
// three-level __shfl_xor_sync butterfly. Every weight sum therefore adds
// in one fixed order: a lane's samples in position order, then the lanes
// in a halving tree. `wmf.fixed_sum` in the plain version adds in the
// same order, and every float step here is rounded on its own
// (__fadd_rn, __fmul_rn; expf, as torch.exp runs on the card), so the
// kernel equals its plain version to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 8;        // lanes a pixel
constexpr int PER_LANE = 16;    // samples a lane
constexpr int MAX_O = LANES * PER_LANE;
constexpr int TILE = 32;        // pixels a block: one row segment
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PIX_PER_WARP = 32 / LANES;
// A pixel's shared row: odd, so phase 1's lanes (pixels) hit 32 banks;
// 9 mod 32, so phase 2's four pixels a warp share a bank at most 2-way.
constexpr int STRIDE = MAX_O + 9;
constexpr unsigned KEY_INF = 0xFF800000u;  // ordered key of +inf
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t SHARED_BYTES = sizeof(unsigned) * 5 * TILE * STRIDE;

static_assert(TILE == WARPS * PIX_PER_WARP, "phase 2 covers the tile");

struct Table {
  int dx[MAX_O];
  int dy[MAX_O];
  float sf[MAX_O];
};

// Monotone float -> uint32 (sign flip; -0.0 taken as +0.0).
__device__ __forceinline__ unsigned ordered_key(float x) {
  if (x == 0.0f) x = 0.0f;
  const unsigned b = __float_as_uint(x);
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned u) {
  return __uint_as_float((u >> 31) ? (u & 0x7FFFFFFFu) : ~u);
}

// The lanes' halving tree over a pixel's 8 lanes (lane s + lane s ^ n).
__device__ __forceinline__ float lane_tree(float p) {
  p = __fadd_rn(p, __shfl_xor_sync(FULL, p, 4));
  p = __fadd_rn(p, __shfl_xor_sync(FULL, p, 2));
  p = __fadd_rn(p, __shfl_xor_sync(FULL, p, 1));
  return p;
}

__global__ void __launch_bounds__(THREADS, 2)
wmf_median_kernel(const float* __restrict__ gray,
                  const float* __restrict__ disp,
                  const float* __restrict__ normal,
                  const unsigned char* __restrict__ reliable, int H, int W,
                  const Table tab, int O, int nbits, float inv_sc,
                  float* __restrict__ med_nx, float* __restrict__ med_ny,
                  float* __restrict__ med_nz,
                  long long* __restrict__ donor_idx,
                  float* __restrict__ donor_disp,
                  long long* __restrict__ num) {
  extern __shared__ unsigned smem[];
  float* s_w = reinterpret_cast<float*>(smem);  // [TILE][STRIDE]
  unsigned* s_k = smem + TILE * STRIDE;         // [4][TILE][STRIDE]
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Phase 1: lane = pixel, the warp's offsets; padding past O.
  {
    const int x = x0 + lane;
    const bool in_img = x < W;
    const float g0 = in_img ? gray[y * W + x] : 0.0f;
    for (int o = warp; o < MAX_O; o += WARPS) {
      float w = 0.0f;
      unsigned k0 = KEY_INF, k1 = KEY_INF, k2 = KEY_INF, k3 = KEY_INF;
      if (o < O && in_img) {
        const int sx = x + tab.dx[o];
        const int sy = y + tab.dy[o];
        if (sx >= 0 && sx < W && sy >= 0 && sy < H) {
          const int q = sy * W + sx;
          if (reliable[q]) {
            const float e = expf(
                __fmul_rn(-fabsf(__fsub_rn(gray[q], g0)), inv_sc));
            w = __fmul_rn(tab.sf[o], e);
            if (w > 0.0f) {
              k0 = ordered_key(disp[q]);
              k1 = ordered_key(normal[3 * q]);
              k2 = ordered_key(normal[3 * q + 1]);
              k3 = ordered_key(normal[3 * q + 2]);
            }
          }
        }
      }
      const int at = lane * STRIDE + o;
      s_w[at] = w;
      s_k[at] = k0;
      s_k[TILE * STRIDE + at] = k1;
      s_k[2 * TILE * STRIDE + at] = k2;
      s_k[3 * TILE * STRIDE + at] = k3;
    }
  }
  __syncthreads();

  // Phase 2: LANES lanes a pixel, sample o = s + LANES * j on lane s.
  const int s = lane & (LANES - 1);
  const int px = warp * PIX_PER_WARP + lane / LANES;
  float w[PER_LANE];
  unsigned k[4][PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int at = px * STRIDE + s + LANES * j;
    w[j] = s_w[at];
#pragma unroll
    for (int c = 0; c < 4; ++c) k[c][j] = s_k[c * TILE * STRIDE + at];
  }
  float total = 0.0f;
  int valid = 0;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    total = __fadd_rn(total, w[j]);
    valid += w[j] > 0.0f;
  }
  total = lane_tree(total);
  valid += __shfl_xor_sync(FULL, valid, 4);
  valid += __shfl_xor_sync(FULL, valid, 2);
  valid += __shfl_xor_sync(FULL, valid, 1);
  const float half = __fmul_rn(total, 0.5f);

  // The four radix descents in lockstep (disparity, nx, ny, nz).
  unsigned med[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 32; ++i) {
    const unsigned bit = 1u << (31 - i);
    float below[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned mid = med[c] | bit;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        acc = __fadd_rn(acc, k[c][j] < mid ? w[j] : 0.0f);
      below[c] = acc;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      below[c] = lane_tree(below[c]);
      if (below[c] < half) med[c] |= bit;
    }
  }

  // The donor: the smallest index at the disparity's median key whose
  // running weight (base: the weight below that key) reaches half.
  float base = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    base = __fadd_rn(base, k[0][j] < med[0] ? w[j] : 0.0f);
  base = lane_tree(base);
  unsigned mi = 0u;
  for (int i = 0; i < nbits; ++i) {
    const unsigned mid = mi | (1u << (nbits - 1 - i));
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const unsigned o = (unsigned)(s + LANES * j);
      acc = __fadd_rn(acc, (o < mid && k[0][j] == med[0]) ? w[j] : 0.0f);
    }
    acc = lane_tree(acc);
    if (__fadd_rn(base, acc) < half) mi = mid;
  }
  if (mi > (unsigned)(O - 1)) mi = (unsigned)(O - 1);

  const int x = x0 + px;
  if (s == 0 && x < W) {
    const int p = y * W + x;
    donor_disp[p] = key_float(med[0]);
    med_nx[p] = key_float(med[1]);
    med_ny[p] = key_float(med[2]);
    med_nz[p] = key_float(med[3]);
    donor_idx[p] = (long long)mi;
    num[p] = (long long)valid;
  }
}

}  // namespace

extern "C" int tsar_wmf_median(const void* gray, const void* disp,
                               const void* normal, const void* reliable,
                               int H, int W, const int* offsets,
                               const float* factors, int O, float inv_sc,
                               void* med_nx, void* med_ny, void* med_nz,
                               void* donor_idx, void* donor_disp, void* num,
                               void* stream) {
  if (O < 1 || O > MAX_O || H < 1 || W < 1 || H > 65535 ||
      3 * (int64_t)H * W >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      wmf_median_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SHARED_BYTES);
  if (err != cudaSuccess) return (int)err;
  Table tab;
  for (int o = 0; o < MAX_O; ++o) {
    tab.dx[o] = o < O ? offsets[2 * o] : 0;
    tab.dy[o] = o < O ? offsets[2 * o + 1] : 0;
    tab.sf[o] = o < O ? factors[o] : 0.0f;
  }
  int nbits = 1;
  while ((1 << nbits) < O) ++nbits;  // max(1, bit_length(O - 1))
  const dim3 grid((W + TILE - 1) / TILE, H);
  wmf_median_kernel<<<grid, THREADS, SHARED_BYTES, (cudaStream_t)stream>>>(
      (const float*)gray, (const float*)disp, (const float*)normal,
      (const unsigned char*)reliable, H, W, tab, O, nbits, inv_sc,
      (float*)med_nx, (float*)med_ny, (float*)med_nz, (long long*)donor_idx,
      (float*)donor_disp, (long long*)num);
  return (int)cudaGetLastError();
}
