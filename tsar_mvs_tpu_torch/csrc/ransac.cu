// Region RANSAC of one view (kernel B5).
//
// Replaces the JAX package's jitted `ransac_plane`
// (tsar_mvs_tpu/models/ransac.py: `_plane_from_triplet`, `_count_inliers`
// and its two `lax.scan`s, the rounds and the annealing) and the
// per-region loop of tsar_mvs_tpu/models/tsar.py `fit_region_planes`;
// the JAX package has no TPU kernel for it. Per region of N points, with
// the triplets and perturbations drawn before the launch:
//
//   plane = [0, 0, 1, -1], count = 0, thr = thr0
//   each round: the planes of its 1000 triplets (degenerate: n = 0,
//     d = inf), their inlier counts |((x a + y b) + z c) + d| < thr, the
//     first of the most; taken when count' >= count; then the adaptive
//     threshold: grow by thr_step when count / total < ratio and
//     thr < thr_max, or when the grown threshold's count exceeds
//     count + gain (and take that count);
//   each annealing step: cand = plane + delta, divided by
//     sqrt(((a a + b b) + c c) + eps); taken when its count >= count.
//
// as models/ransac.py::ransac_regions_plain computes it. Every float step
// is rounded on its own in that order (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn: nvcc would contract a*b+c into an FMA) and the
// counts are exact integers, so the kernel equals its plain version to
// the bit.
//
// What bounds it on Hopper: operations, and then the dependent chain. A
// region needs about (10 x 1001 + 4000) x N residuals of 8 operations
// (kernel_times.b5_flops): at two regions of 50,000 points 11 GFLOP,
// 0.17 ms at 67 TFLOP/s and 0.33 ms at the 33.5 T/s of single rounded
// adds and multiplies; the bytes (the points, the draws) are under 2 MB.
// The annealing's 4,000 steps each need the whole count of the step before
// (the accept), so any design that keeps the sequential accepts pays
// 4,000 block-wide reductions in a row.
//
// What the design does about it (right and simple first). One block of
// 1024 threads a region, all regions in one launch. A round gives each of
// 1000 threads one hypothesis: the thread builds its plane and counts it
// over every point, in tiles of TILE points staged in shared memory (every
// thread reads the same point: a broadcast); the count stays in a
// register. The block's argmax packs (count + 1, 1023 - thread) into one
// 32-bit key, so one max finds the most inliers and the first hypothesis
// among ties. An annealing step (and each round's threshold probe) splits
// the points over the threads, reads them from global memory (L1 and L2
// hold them) and sums the counts with __reduce_add_sync and one barrier:
// the warps' partial sums alternate between two shared buffers, so no
// second barrier is needed before the next step writes. Every thread
// forms the same candidate and takes the same decision. Spreading the
// rounds over many blocks and holding the points in a cluster's shared
// memory for the annealing are a later redesign's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HYPOTHESES = 1000;  // a round (models/ransac.py RANSAC_ROUND)
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 2048;        // points a shared tile of the rounds
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Consts {
  float thr_max, thr_step, ratio, eps, tiny;
};

__device__ __forceinline__ float residual(float x, float y, float z,
                                          const float p[4]) {
  return fabsf(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, p[0]),
                                             __fmul_rn(y, p[1])),
                                   __fmul_rn(z, p[2])),
                         p[3]));
}

// The plane through p1, p2, p3, as `_plane_from_triplet` computes it.
__device__ void plane_from_triplet(const float* p1, const float* p2,
                                   const float* p3, const Consts& k,
                                   float out[4]) {
  const float ex = __fsub_rn(p2[0], p1[0]), ey = __fsub_rn(p2[1], p1[1]),
              ez = __fsub_rn(p2[2], p1[2]);
  const float fx = __fsub_rn(p3[0], p1[0]), fy = __fsub_rn(p3[1], p1[1]),
              fz = __fsub_rn(p3[2], p1[2]);
  const float nx = __fsub_rn(__fmul_rn(ey, fz), __fmul_rn(ez, fy));
  const float ny = __fsub_rn(__fmul_rn(ez, fx), __fmul_rn(ex, fz));
  const float nz = __fsub_rn(__fmul_rn(ex, fy), __fmul_rn(ey, fx));
  const float norm = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)), __fmul_rn(nz, nz)));
  if (norm > k.tiny) {
    const float m = fmaxf(norm, k.eps);
    out[0] = __fdiv_rn(nx, m);
    out[1] = __fdiv_rn(ny, m);
    out[2] = __fdiv_rn(nz, m);
    out[3] = -__fadd_rn(__fadd_rn(__fmul_rn(out[0], p1[0]),
                                  __fmul_rn(out[1], p1[1])),
                        __fmul_rn(out[2], p1[2]));
  } else {
    out[0] = out[1] = out[2] = 0.0f;
    out[3] = INFINITY;
  }
}

// The block's count of points with residual < thr under `pl`, on every
// thread; `red` is this call's buffer of WARPS partial sums (the caller
// alternates two).
__device__ __forceinline__ int block_count(const float* __restrict__ P,
                                           int N, const float pl[4],
                                           float thr, unsigned* red) {
  int c = 0;
  for (int j = threadIdx.x; j < N; j += THREADS)
    c += residual(P[3 * j], P[3 * j + 1], P[3 * j + 2], pl) < thr;
  c = __reduce_add_sync(FULL, c);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = (unsigned)c;
  __syncthreads();
  return __reduce_add_sync(FULL, (int)red[threadIdx.x & 31]);
}

__global__ void __launch_bounds__(THREADS, 1) ransac_regions_kernel(
    const float* __restrict__ pts, const long long* __restrict__ offsets,
    const int* __restrict__ idx, const float* __restrict__ deltas,
    const float* __restrict__ thr0, const float* __restrict__ total,
    const float* __restrict__ gain, int rounds, int anneal, Consts k,
    float* __restrict__ plane_out, int* __restrict__ count_out,
    float* __restrict__ thr_out) {
  static_assert(WARPS == 32, "the block sums read one partial a lane");
  __shared__ float4 tile[TILE];
  __shared__ unsigned red[2][WARPS];
  __shared__ float best[4];
  const int r = blockIdx.x, t = threadIdx.x;
  const long long base = offsets[r];
  const int N = (int)(offsets[r + 1] - base);
  const float* P = pts + 3 * base;
  const float tot = total[r], gn = gain[r];
  float pl[4] = {0.0f, 0.0f, 1.0f, -1.0f};
  int count = 0;
  float thr = thr0[r];
  int buf = 0;

  for (int round = 0; round < rounds; ++round) {
    const bool mine = t < HYPOTHESES;
    float hp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (mine) {
      const int* ix =
          idx + (((long long)r * rounds + round) * HYPOTHESES + t) * 3;
      plane_from_triplet(P + 3 * ix[0], P + 3 * ix[1], P + 3 * ix[2], k, hp);
    }
    int c = 0;
    for (int s = 0; s < N; s += TILE) {
      const int len = min(TILE, N - s);
      __syncthreads();
      for (int j = t; j < len; j += THREADS) {
        const float* q = P + 3 * (long long)(s + j);
        tile[j] = make_float4(q[0], q[1], q[2], 0.0f);
      }
      __syncthreads();
      if (mine)
        for (int j = 0; j < len; ++j) {
          const float4 q = tile[j];
          c += residual(q.x, q.y, q.z, hp) < thr;
        }
    }
    // The most inliers, the first hypothesis among ties.
    unsigned key = mine ? ((unsigned)(c + 1) << 10) |
                              (unsigned)(THREADS - 1 - t)
                        : 0u;
    key = __reduce_max_sync(FULL, key);
    if ((t & 31) == 0) red[buf][t >> 5] = key;
    __syncthreads();
    key = __reduce_max_sync(FULL, red[buf][t & 31]);
    buf ^= 1;
    const int bi = THREADS - 1 - (int)(key & 1023u);
    const int bc = (int)(key >> 10) - 1;
    if (t == bi)
      for (int i = 0; i < 4; ++i) best[i] = hp[i];
    __syncthreads();
    if (bc >= count) {
      for (int i = 0; i < 4; ++i) pl[i] = best[i];
      count = bc;
    }
    // The adaptive threshold, once a round.
    const bool grow_small =
        (__fdiv_rn(__int2float_rn(count), tot) < k.ratio) &&
        (thr < k.thr_max);
    const float t2 = __fadd_rn(thr, k.thr_step);
    const int count2 = block_count(P, N, pl, t2, red[buf]);
    buf ^= 1;
    const bool grow_big =
        !grow_small &&
        (__int2float_rn(count2) > __fadd_rn(__int2float_rn(count), gn));
    if (grow_small || grow_big) thr = t2;
    if (grow_big) count = count2;
  }

  for (int a = 0; a < anneal; ++a)
    for (int s = 0; s < 4; ++s) {
      const float* dl = deltas + (((long long)r * anneal + a) * 4 + s) * 4;
      float cand[4];
      for (int i = 0; i < 4; ++i) cand[i] = __fadd_rn(pl[i], __ldg(dl + i));
      const float nrm = __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(cand[0], cand[0]),
                              __fmul_rn(cand[1], cand[1])),
                    __fmul_rn(cand[2], cand[2])),
          k.eps));
      for (int i = 0; i < 4; ++i) cand[i] = __fdiv_rn(cand[i], nrm);
      const int c = block_count(P, N, cand, thr, red[buf]);
      buf ^= 1;
      if (c >= count) {
        for (int i = 0; i < 4; ++i) pl[i] = cand[i];
        count = c;
      }
    }

  if (t == 0) {
    for (int i = 0; i < 4; ++i) plane_out[4 * r + i] = pl[i];
    count_out[r] = count;
    thr_out[r] = thr;
  }
}

}  // namespace

extern "C" int tsar_ransac_regions(
    const void* points, const void* offsets, const void* idx,
    const void* deltas, const void* thr0, const void* total,
    const void* gain, int R, int rounds, int anneal, float thr_max,
    float thr_step, float ratio, float eps, float tiny, void* plane,
    void* count, void* thr, void* stream) {
  if (R < 1 || rounds < 0 || anneal < 0) return (int)cudaErrorInvalidValue;
  const Consts k{thr_max, thr_step, ratio, eps, tiny};
  ransac_regions_kernel<<<R, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)points, (const long long*)offsets, (const int*)idx,
      (const float*)deltas, (const float*)thr0, (const float*)total,
      (const float*)gain, rounds, anneal, k, (float*)plane, (int*)count,
      (float*)thr);
  return (int)cudaGetLastError();
}
