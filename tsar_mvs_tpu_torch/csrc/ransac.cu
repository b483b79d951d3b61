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
// counts are exact integers, summed in any order, so the kernel equals its
// plain version to the bit.
//
// What bounds it on Hopper: operations, and then the dependent chain. A
// region needs about (10 x 1001 + 4000) x N residuals of 8 operations
// (kernel_times.b5_flops): at two regions of 50,000 points 11 GFLOP,
// 0.17 ms at 67 TFLOP/s and 0.33 ms at the 33.5 T/s of single rounded
// adds and multiplies; the bytes (the points, the draws) are under 2 MB.
// The annealing's 4,000 steps each need the whole count of the step
// before (the accept).
//
// What the design does about it. One call is a short sequence of
// launches on the stream:
//
// * The rounds, over the whole card. A round's hypotheses depend only on
//   their triplets and its threshold, so a round is one parallel pass:
//   `ransac_count_kernel` gives each block a chunk of points (a piece of
//   a large region, or a run of whole small regions; the host's work
//   plan, ops/cuda_ransac.py `round_chunks`, sizes them so that the view
//   fills every SM with about CHUNK_BLOCKS_PER_SM blocks) and each thread
//   PER_THREAD hypotheses' planes in registers, so a point staged in
//   shared memory serves PER_THREAD residuals; each block adds its
//   partial counts into an (R, 1000) buffer with atomicAdd (integers:
//   exact in any order). `ransac_decide_kernel`, one block a region,
//   then takes the argmax by the 32-bit key (count + 1) << 10 |
//   (1023 - h) (the most inliers, the first hypothesis among ties), the
//   >= accept, the threshold probe at thr + thr_step (a block-wide count)
//   and the threshold rule, and builds the next round's 1000 planes.
//   Count, decide, ten times.
// * The annealing (`ransac_anneal_kernel`, one launch in clusters of
//   CLUSTER blocks; the plan is `anneal_units`). A region of more than
//   CLUSTER_MIN_POINTS points takes a whole cluster: each block holds its
//   slice of the points in its own shared memory, loaded once (a region
//   above CLUSTER x SMEM_POINTS points reads its slices from global
//   memory in the same code); smaller regions take one block each. A
//   pass resolves LOOKAHEAD steps: before step s + j the plane is one of
//   2^j planes (one per set of accepts among the j steps before it), so
//   the pass builds the 2^L - 1 candidates of that tree (lane k of each
//   warp builds node k, level by level, from the perturbations loaded a
//   pass ahead), counts them all in one sweep over its points, adds the
//   warps' counts in shared memory and sends the block's counts to every
//   block of its cluster as 16-byte `st.async` stores that complete the
//   receiver's mbarrier: a block waits only for the counts it needs, with
//   no cluster barrier. Every block then resolves the L accepts in order
//   from the same totals. Each candidate is built by the sequential
//   loop's rounded operations from the plane that loop would hold, and
//   counts are integers, so the decisions and the bits are the loop's. A
//   pass at the end resolves fewer steps when 4 x anneal_rounds is not a
//   multiple of LOOKAHEAD. `kernel_times b5-design` chose CLUSTER,
//   LOOKAHEAD and ANNEAL_THREADS; `b5-parts` times the tree, the counts
//   and the exchange.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int HYPOTHESES = 1000;  // a round (models/ransac.py RANSAC_ROUND)
constexpr int THREADS = 1024;     // the decide kernel's block
constexpr int WARPS = THREADS / 32;
// The rounds' count kernel: threads a block, hypotheses a thread, points
// a shared tile; a chunk has at least CHUNK_MIN points, and the plan aims
// at CHUNK_BLOCKS_PER_SM blocks an SM.
constexpr int ROUND_THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = 2048;
constexpr int CHUNK_MIN = 256;
constexpr int CHUNK_BLOCKS_PER_SM = 3;
// The annealing: blocks a cluster, steps a pass, threads a block, the
// points a block holds in shared memory at most, and the smallest region
// that takes a whole cluster.
constexpr int CLUSTER = 16;
constexpr int LOOKAHEAD = 2;
constexpr int ANNEAL_THREADS = 256;
constexpr int SMEM_POINTS = 12288;
constexpr int CLUSTER_MIN_POINTS = 2048;
constexpr int NODES = (1 << LOOKAHEAD) - 1;
// A block's counts as the unit's blocks receive them: NODES rounded up to
// whole 16-byte stores.
constexpr int SLOT = (NODES + 3) / 4 * 4;
static_assert(SLOT / 4 * CLUSTER <= ANNEAL_THREADS, "a store a thread");
// Waits on an mbarrier longer than this many polls trap (a fault, not a
// hang): every wait of a pass completes within microseconds.
constexpr int WAIT_POLLS = 1 << 22;
constexpr unsigned FULL = 0xFFFFFFFFu;

static_assert(ROUND_THREADS * PER_THREAD >= HYPOTHESES, "a round's hypotheses");
static_assert(NODES <= 32, "a warp's lanes build the lookahead tree");
static_assert(CLUSTER <= 32, "a warp's lanes read the cluster's partials");
// The host's plans (ops/cuda_ransac.py) read the rest: a region that
// takes one block fits its shared memory, and a chunk is never empty.
static_assert(CLUSTER_MIN_POINTS <= SMEM_POINTS, "one-block regions");
static_assert(CHUNK_MIN > 0 && CHUNK_BLOCKS_PER_SM > 0, "chunks");

struct Consts {
  float thr_max, thr_step, ratio, eps, tiny;
};

// A region's running state between the launches (ops/cuda_ransac.py
// allocates it as (R, 8) int32).
struct State {
  float plane[4];
  int count;
  float thr;
  int pad[2];
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

// An annealing candidate: (base + delta) / sqrt(((a a + b b) + c c) + eps).
__device__ __forceinline__ void candidate(const float base[4],
                                          const float dl[4], float eps,
                                          float out[4]) {
  for (int i = 0; i < 4; ++i) out[i] = __fadd_rn(base[i], dl[i]);
  const float nrm = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(out[0], out[0]),
                          __fmul_rn(out[1], out[1])),
                __fmul_rn(out[2], out[2])),
      eps));
  for (int i = 0; i < 4; ++i) out[i] = __fdiv_rn(out[i], nrm);
}

// Distributed shared memory: the address of this block's shared `p` in
// block `rank` of the cluster; a 4-byte store there that completes that
// block's mbarrier `bar` (also mapped); an mbarrier's init, its expected
// bytes (with this thread's arrival) and a wait for its phase `parity`.
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void store_async(unsigned addr, int4 v,
                                            unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  for (int polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > WAIT_POLLS) __trap();
  }
}

// The decide block's count of points with residual < thr under `pl`, on
// every thread; `red` is this call's buffer of WARPS partial sums.
__device__ __forceinline__ int block_count(const float* __restrict__ P,
                                           int N, const float pl[4],
                                           float thr, unsigned* red) {
  int c = 0;
#pragma unroll 8
  for (int j = threadIdx.x; j < N; j += THREADS)
    c += residual(P[3 * j], P[3 * j + 1], P[3 * j + 2], pl) < thr;
  c = __reduce_add_sync(FULL, c);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = (unsigned)c;
  __syncthreads();
  return __reduce_add_sync(FULL, (int)red[threadIdx.x & 31]);
}

// One round's counts: block b takes the points chunks[b] = (first
// region, start, end) of the packed points, region by region, and adds
// each hypothesis's count over them to counts[region][h].
__global__ void __launch_bounds__(ROUND_THREADS) ransac_count_kernel(
    const float* __restrict__ pts, const long long* __restrict__ offsets,
    const long long* __restrict__ chunks, const float4* __restrict__ planes,
    const State* __restrict__ state, int* __restrict__ counts) {
  __shared__ float4 tile[TILE];
  const int t = threadIdx.x;
  const long long* ch = chunks + 3 * (long long)blockIdx.x;
  int r = (int)ch[0];
  long long s = ch[1];
  const long long e = ch[2];
  for (; s < e; ++r) {
    const long long re = min(e, offsets[r + 1]);
    const float thr = state[r].thr;
    float hp[PER_THREAD][4];
    for (int i = 0; i < PER_THREAD; ++i) {
      const int h = t + i * ROUND_THREADS;
      const float4 q = h < HYPOTHESES ? planes[(long long)r * HYPOTHESES + h]
                                      : make_float4(0.f, 0.f, 0.f, INFINITY);
      hp[i][0] = q.x;
      hp[i][1] = q.y;
      hp[i][2] = q.z;
      hp[i][3] = q.w;
    }
    int c[PER_THREAD] = {};
    for (long long a = s; a < re; a += TILE) {
      const int len = (int)min((long long)TILE, re - a);
      __syncthreads();
      for (int j = t; j < len; j += ROUND_THREADS) {
        const float* q = pts + 3 * (a + j);
        tile[j] = make_float4(q[0], q[1], q[2], 0.0f);
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const float4 q = tile[j];
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i)
          c[i] += residual(q.x, q.y, q.z, hp[i]) < thr;
      }
    }
    for (int i = 0; i < PER_THREAD; ++i) {
      const int h = t + i * ROUND_THREADS;
      if (h < HYPOTHESES && c[i] != 0)
        atomicAdd(counts + (long long)r * HYPOTHESES + h, c[i]);
    }
    s = re;
  }
}

// Round k's decision for region blockIdx.x (k = -1: the initial state),
// then round k + 1's planes. Leaves the counts zeroed for the next round.
__global__ void __launch_bounds__(THREADS, 1) ransac_decide_kernel(
    const float* __restrict__ pts, const long long* __restrict__ offsets,
    const int* __restrict__ idx, const float* __restrict__ thr0,
    const float* __restrict__ total, const float* __restrict__ gain,
    int rounds, int k, Consts kc, float4* __restrict__ planes,
    int* __restrict__ counts, State* __restrict__ state) {
  static_assert(WARPS == 32, "the block sums read one partial a lane");
  __shared__ unsigned red[2][WARPS];
  const int r = blockIdx.x, t = threadIdx.x;
  const long long base = offsets[r];
  const int N = (int)(offsets[r + 1] - base);
  const float* P = pts + 3 * base;
  int* cnt = counts + (long long)r * HYPOTHESES;
  float4* pln = planes + (long long)r * HYPOTHESES;
  float pl[4] = {0.0f, 0.0f, 1.0f, -1.0f};
  int count = 0;
  float thr = thr0[r];
  if (k >= 0) {
    const State st = state[r];
    for (int i = 0; i < 4; ++i) pl[i] = st.plane[i];
    count = st.count;
    thr = st.thr;
    // The most inliers, the first hypothesis among ties.
    unsigned key = t < HYPOTHESES ? ((unsigned)(cnt[t] + 1) << 10) |
                                        (unsigned)(THREADS - 1 - t)
                                  : 0u;
    key = __reduce_max_sync(FULL, key);
    if ((t & 31) == 0) red[0][t >> 5] = key;
    __syncthreads();
    key = __reduce_max_sync(FULL, red[0][t & 31]);
    const int bi = THREADS - 1 - (int)(key & 1023u);
    const int bc = (int)(key >> 10) - 1;
    if (bc >= count) {
      const float4 b = pln[bi];
      pl[0] = b.x;
      pl[1] = b.y;
      pl[2] = b.z;
      pl[3] = b.w;
      count = bc;
    }
    // The adaptive threshold, once a round.
    const bool grow_small =
        (__fdiv_rn(__int2float_rn(count), total[r]) < kc.ratio) &&
        (thr < kc.thr_max);
    const float t2 = __fadd_rn(thr, kc.thr_step);
    const int count2 = block_count(P, N, pl, t2, red[1]);
    const bool grow_big =
        !grow_small &&
        (__int2float_rn(count2) > __fadd_rn(__int2float_rn(count), gain[r]));
    if (grow_small || grow_big) thr = t2;
    if (grow_big) count = count2;
  }
  if (t < HYPOTHESES) cnt[t] = 0;
  __syncthreads();  // every thread has read pln[bi]
  if (k + 1 < rounds && t < HYPOTHESES) {
    const int* ix =
        idx + (((long long)r * rounds + k + 1) * HYPOTHESES + t) * 3;
    float hp[4];
    plane_from_triplet(P + 3 * ix[0], P + 3 * ix[1], P + 3 * ix[2], kc, hp);
    pln[t] = make_float4(hp[0], hp[1], hp[2], hp[3]);
  }
  if (t == 0) {
    State st;
    for (int i = 0; i < 4; ++i) st.plane[i] = pl[i];
    st.count = count;
    st.thr = thr;
    st.pad[0] = st.pad[1] = 0;
    state[r] = st;
  }
}

// The annealing. Block b takes region units[b].x; units[b].y is 1 (the
// block alone) or CLUSTER (the whole cluster, block rank q holding points
// [q S, (q + 1) S) of the region, S = ceil(N / CLUSTER)). A slice of at
// most smem_points points is held in shared memory.
__global__ void __launch_bounds__(ANNEAL_THREADS, 1) ransac_anneal_kernel(
    const float* __restrict__ pts, const long long* __restrict__ offsets,
    const int2* __restrict__ units, const float* __restrict__ deltas,
    int anneal, float eps, int smem_points, const State* __restrict__ state,
    float* __restrict__ plane_out, int* __restrict__ count_out,
    float* __restrict__ thr_out) {
  extern __shared__ float4 spts[];
  // This block's counts by node (three buffers in turn: a pass adds into
  // one and zeroes the next), the unit's blocks' counts (two buffers, a
  // pass's parity; SLOT a block) and the mbarriers their stores complete.
  __shared__ int bsum[3][NODES];
  __shared__ __align__(16) int slot[2][CLUSTER][SLOT];
  __shared__ unsigned long long mbar[2];
  const int2 u = units[blockIdx.x];
  const int r = u.x, nb = u.y;
  if (r < 0) return;  // an idle block of a cluster of small regions
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, lane = t & 31;
  const unsigned crank = cluster.block_rank();
  const int rank = nb > 1 ? (int)crank : 0;
  const long long base = offsets[r];
  const int N = (int)(offsets[r + 1] - base);
  const int S = (N + nb - 1) / nb;
  const int lo = min(N, rank * S);
  const int mine = min(N, lo + S) - lo;
  const float* P = pts + 3 * (base + lo);
  const bool in_smem = S <= smem_points;
  if (in_smem)
    for (int j = t; j < mine; j += ANNEAL_THREADS)
      spts[j] = make_float4(P[3 * j], P[3 * j + 1], P[3 * j + 2], 0.0f);
  if (t < 3 * NODES) bsum[t / NODES][t % NODES] = 0;
  if (t == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every block of the unit has started (its shared memory and mbarriers
  // exist) and this block's slice is in place.
  if (nb > 1)
    cluster.sync();
  else
    __syncthreads();

  const State st = state[r];
  float pl[4] = {st.plane[0], st.plane[1], st.plane[2], st.plane[3]};
  int count = st.count;
  const float thr = st.thr;
  const int steps = 4 * anneal;
  const float* dl_r = deltas + (long long)r * steps * 4;
  // This lane's node of the lookahead tree: level lev (step s + lev of a
  // pass), accept mask msk of the steps before it; its base is the pass's
  // plane (msk = 0) or the candidate of the last accepted step.
  const int lev = 31 - __clz(lane + 1);
  const int msk = lane + 1 - (1 << lev);
  const int hi = msk ? 31 - __clz(msk) : 0;
  const int bnode = msk ? (1 << hi) - 1 + (msk & ((1 << hi) - 1)) : 0;
  // The perturbations of this lane's node, a pass ahead.
  float dl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (lev < LOOKAHEAD && steps > 0)
    for (int i = 0; i < 4; ++i)
      dl[i] = __ldg(dl_r + 4 * (long long)min(lev, steps - 1) + i);

  for (int s = 0, pass = 0; s < steps; s += LOOKAHEAD, ++pass) {
    float dn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (lev < LOOKAHEAD)
      for (int i = 0; i < 4; ++i)
        dn[i] = __ldg(dl_r + 4 * (long long)min(s + LOOKAHEAD + lev,
                                                steps - 1) + i);
    float cd[4] = {pl[0], pl[1], pl[2], pl[3]};
#pragma unroll
    for (int j = 0; j < LOOKAHEAD; ++j) {
      float base[4];
      for (int i = 0; i < 4; ++i) {
        const float from = __shfl_sync(FULL, cd[i], bnode);
        base[i] = msk ? from : pl[i];
      }
      if (lev == j) candidate(base, dl, eps, cd);
    }
    float cp[NODES][4];
#pragma unroll
    for (int q = 0; q < NODES; ++q)
      for (int i = 0; i < 4; ++i) cp[q][i] = __shfl_sync(FULL, cd[i], q);

    int c[NODES] = {};
    if (in_smem) {
      for (int j = t; j < mine; j += ANNEAL_THREADS) {
        const float4 q = spts[j];
#pragma unroll
        for (int n = 0; n < NODES; ++n)
          c[n] += residual(q.x, q.y, q.z, cp[n]) < thr;
      }
    } else {
      for (int j = t; j < mine; j += ANNEAL_THREADS) {
        const float x = P[3 * j], y = P[3 * j + 1], z = P[3 * j + 2];
#pragma unroll
        for (int n = 0; n < NODES; ++n) c[n] += residual(x, y, z, cp[n]) < thr;
      }
    }
    // The warps' counts into this block's buffer; the next buffer zeroed
    // (its last reads were two passes ago, before the last barrier).
    const int b3 = pass % 3, pb = pass & 1;
    int mc = 0;
#pragma unroll
    for (int n = 0; n < NODES; ++n) {
      const int v = __reduce_add_sync(FULL, c[n]);
      if (lane == n) mc = v;
    }
    if (lane < NODES) atomicAdd(&bsum[b3][lane], mc);
    if (t < NODES) bsum[(b3 + 1) % 3][t] = 0;
    __syncthreads();
    int tot[NODES];
    if (nb == 1) {
#pragma unroll
      for (int n = 0; n < NODES; ++n) tot[n] = bsum[b3][n];
    } else {
      // This block's counts to every block of the unit, 16-byte stores
      // into their slot of this pass's parity that complete their
      // mbarrier; then this block waits for all of the unit's. A slot is
      // stored into again two passes on, which no block reaches before
      // every block has read it (it needs their next pass's counts).
      constexpr int STORES = SLOT / 4;
      if (t == 0) mbar_expect(&mbar[pb], nb * SLOT * 4);
      if (t < STORES * nb) {
        const int h = 4 * (t % STORES);
        const unsigned dst = t / STORES;
        int q[4];
        for (int i = 0; i < 4; ++i) q[i] = h + i < NODES ? bsum[b3][h + i] : 0;
        store_async(cluster_addr(&slot[pb][rank][h], dst),
                    make_int4(q[0], q[1], q[2], q[3]),
                    cluster_addr(&mbar[pb], dst));
      }
      mbar_wait(&mbar[pb], (pass >> 1) & 1);
#pragma unroll
      for (int n = 0; n < NODES; ++n)
        tot[n] = __reduce_add_sync(FULL, lane < nb ? slot[pb][lane][n] : 0);
    }
    for (int i = 0; i < 4; ++i) dl[i] = dn[i];

    // The pass's accepts in order: step s + j counts node (j, mask).
    int mask = 0, sel = -1;
#pragma unroll
    for (int j = 0; j < LOOKAHEAD; ++j) {
      if (s + j < steps) {
        const int nd = (1 << j) - 1 + mask;
        int cj = 0;
#pragma unroll
        for (int n = (1 << j) - 1; n < (2 << j) - 1; ++n)
          if (n == nd) cj = tot[n];
        if (cj >= count) {
          count = cj;
          sel = nd;
          mask |= 1 << j;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NODES; ++n)
      if (n == sel)
        for (int i = 0; i < 4; ++i) pl[i] = cp[n][i];
  }

  if (rank == 0 && t == 0) {
    for (int i = 0; i < 4; ++i) plane_out[4 * r + i] = pl[i];
    count_out[r] = count;
    thr_out[r] = thr;
  }
}

}  // namespace

// The annealing's blocks a cluster, for the host's work plan.
extern "C" int tsar_ransac_cluster() { return CLUSTER; }

extern "C" int tsar_ransac_regions(
    const void* points, const void* offsets, const void* idx,
    const void* deltas, const void* thr0, const void* total,
    const void* gain, int R, int rounds, int anneal, float thr_max,
    float thr_step, float ratio, float eps, float tiny, const void* chunks,
    int n_chunks, const void* units, int n_units, int smem_points,
    void* planes, void* counts, void* state, void* plane, void* count,
    void* thr, void* stream) {
  if (R < 1 || rounds < 0 || anneal < 0 || n_chunks < 1 || n_units < 1 ||
      n_units % CLUSTER != 0 || smem_points < 0 || smem_points > SMEM_POINTS)
    return (int)cudaErrorInvalidValue;
  // The annealing's attributes, once a device and process.
  static unsigned attributes_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(attributes_set >> dev & 1u)) {
    err = cudaFuncSetAttribute(ransac_anneal_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_POINTS * (int)sizeof(float4));
    if (err == cudaSuccess && CLUSTER > 8)
      err = cudaFuncSetAttribute(ransac_anneal_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) attributes_set |= 1u << dev;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const Consts k{thr_max, thr_step, ratio, eps, tiny};
  const float* P = (const float*)points;
  const long long* off = (const long long*)offsets;
  float4* pl4 = (float4*)planes;
  int* cnt = (int*)counts;
  State* sta = (State*)state;
  for (int round = -1; round < rounds; ++round) {
    if (round >= 0) {
      ransac_count_kernel<<<n_chunks, ROUND_THREADS, 0, st>>>(
          P, off, (const long long*)chunks, pl4, sta, cnt);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    ransac_decide_kernel<<<R, THREADS, 0, st>>>(
        P, off, (const int*)idx, (const float*)thr0, (const float*)total,
        (const float*)gain, rounds, round, k, pl4, cnt, sta);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_units);
  cfg.blockDim = dim3(ANNEAL_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem_points * sizeof(float4);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ransac_anneal_kernel, P, off,
                           (const int2*)units, (const float*)deltas, anneal,
                           eps, smem_points, (const State*)sta,
                           (float*)plane, (int*)count, (float*)thr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
