// Weighted median plane of one WMF pass (kernel B4).
//
// Replaces the JAX package's XLA weighted median filter
// (tsar_mvs_tpu/ops/wmf.py: `_gather_samples`, `_weighted_median` and
// `_median_plane`, the rebuild of the reference's gipuma_WMF and
// gipuma_WMF_Final); the JAX package has no TPU kernel for it. Per pixel
// p and offset o of the pass's table (at most MAX_O):
//
//   w_o  = reliable(p+o) ? sf_o * exp(-|gray(p+o) - gray(p)| * inv_sc) : 0
//   key  = value(p+o)   for disparity, nx, ny, nz
//
// (out-of-image samples are unreliable; the plain version gives samples
// of weight 0 the key +inf, and no weight sum adds them, so the kernel
// leaves theirs as it reads them), then for each of the four keys
// the weighted median: the smallest key whose weight at or below it,
// A(key), reaches half the total, keys taken in their order-preserving
// uint32 image; for the disparity also the smallest sample index at the
// median key whose running weight reaches half; and the count of valid
// samples. An all-invalid pixel has half = 0 and median key 0, the NaN
// whose bits are 0xFFFFFFFF, as the plain version gives.
//
// The plain version (ops/wmf.py::_median_plane_plain) finds each median
// by a 32-step radix descent whose every step is one weight sum in a
// fixed order. A is non-decreasing in the key (every partial sum is a
// rounded add of non-negative terms, and rounding is monotone), so the
// descent returns the smallest sample key k with A(k) >= half, and any
// search that evaluates A in the same order returns the same bits.
//
// What bounds it on Hopper: operations. It reads about 21 bytes a pixel
// and writes 32 (146 MB a 1344x2048 pass, 0.04 ms at 3.35 TB/s; the
// 121-fold reuse of the fields comes from L1 and L2). The function needs
// about 5,000 float operations a pixel (kernel_times.b4_flops), 0.2 ms at
// 67 TFLOP/s and 0.4 ms at the 33.5 T/s of single rounded adds. Every
// masked add needs a compare, which runs on the integer pipe at half the
// rate of the adds; the compares, the sort and the merges below, and the
// latency of the gathers and of each sum's shuffle tree bound it.
//
// What the design does about it. A block owns TILE = 32 neighbouring
// pixels of one row; a pixel gets LANES = 8 lanes and each lane holds
// PER_LANE = 16 samples (offset o = s + LANES * j on lane s): their
// weights in registers, their indices in the lane's own row of shared
// memory. Lanes share nothing across pixels, so after the offset table
// is staged no barrier holds a warp back. A weight sum is a lane's
// samples in position order (a compare and a predicated add each; a
// skipped add leaves the same bits as adding +0) and then the lanes in a
// three-level __shfl_xor_sync halving tree: `wmf.fixed_sum`'s order. The
// medians run one after another, each a search by rank in 10 such sums
// instead of 32: every lane gathers its 16 keys and sorts a copy (a
// 63-comparator network); the 8 lanes' quartiles (positions 3, 7, 11,
// 15) are merged across the lanes into 32 sorted splitters, and a binary
// search over them finds the smallest splitter hi with A(hi) >= half (5
// sums; the largest splitter is the largest key, whose A is the total).
// No splitter lies strictly between hi and the splitter below it, lo, so
// each lane's keys in (lo, hi] lie in one block of 4 between two of its
// quartiles, apart from copies of hi, and the block holds hi where hi is
// the lane's; those 8 blocks are merged into 32 sorted candidates that
// hold every key in (lo, hi] (the others lie at or below lo, where A is
// below half, or above hi), and a second binary search (5 sums) finds
// the median among them. Every float step is rounded on its own
// (__fadd_rn, __fmul_rn; expf, as torch.exp runs on the card), so the
// kernel equals its plain version to the bit. A block needs 54 KB of
// shared memory and 64 registers a thread, so an SM holds 4 blocks (32 of
// 64 warps).

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
constexpr int BLOCKS_PER_SM = 4;
// Splitters (and then candidates) a pixel: 4 quartiles of 8 lanes.
constexpr int SPLIT = 4 * LANES;
constexpr unsigned FULL = 0xFFFFFFFFu;
// Shared memory: three lane-private rows a lane, a pixel's splitters
// or candidates, the offset table.
constexpr size_t SHARED_BYTES =
    sizeof(unsigned) * TILE * (3 * MAX_O + SPLIT) + sizeof(int4) * MAX_O;

static_assert(TILE == WARPS * PIX_PER_WARP, "the warps cover the tile");
static_assert(PER_LANE == 16 && LANES == 8,
              "the sorting network and the merge are sized for 16 keys a "
              "lane and 8 lanes");

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

// acc += w where k <= p (k < p with `strict`): a compare and a predicated
// rounded add; acc >= +0 and w >= 0, so skipping equals adding +0.
template <bool strict>
__device__ __forceinline__ void add_if(float& acc, unsigned k, unsigned p,
                                       float w) {
  if (strict)
    asm("{\n\t.reg .pred q;\n\tsetp.lt.u32 q, %1, %2;\n\t"
        "@q add.rn.f32 %0, %0, %3;\n\t}"
        : "+f"(acc) : "r"(k), "r"(p), "f"(w));
  else
    asm("{\n\t.reg .pred q;\n\tsetp.le.u32 q, %1, %2;\n\t"
        "@q add.rn.f32 %0, %0, %3;\n\t}"
        : "+f"(acc) : "r"(k), "r"(p), "f"(w));
}

// A(p): the pixel's weight at or below key p (below it with `strict`).
template <bool strict>
__device__ __forceinline__ float weight_upto(const float (&w)[PER_LANE],
                                             const unsigned (&k)[PER_LANE],
                                             unsigned p) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) add_if<strict>(acc, k[j], p, w[j]);
  return lane_tree(acc);
}

__device__ __forceinline__ void cmp_swap(unsigned& a, unsigned& b) {
  const unsigned lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// Batcher's odd-even merge sort of a lane's 16 keys, ascending.
__device__ __forceinline__ void sort16(unsigned (&r)[PER_LANE]) {
#define CE(a, b) cmp_swap(r[a], r[b]);
  CE(0, 1) CE(2, 3) CE(0, 2) CE(1, 3) CE(1, 2) CE(4, 5) CE(6, 7) CE(4, 6)
  CE(5, 7) CE(5, 6) CE(0, 4) CE(2, 6) CE(2, 4) CE(1, 5) CE(3, 7) CE(3, 5)
  CE(1, 2) CE(3, 4) CE(5, 6) CE(8, 9) CE(10, 11) CE(8, 10) CE(9, 11)
  CE(9, 10) CE(12, 13) CE(14, 15) CE(12, 14) CE(13, 15) CE(13, 14)
  CE(8, 12) CE(10, 14) CE(10, 12) CE(9, 13) CE(11, 15) CE(11, 13)
  CE(9, 10) CE(11, 12) CE(13, 14) CE(0, 8) CE(4, 12) CE(4, 8) CE(2, 10)
  CE(6, 14) CE(6, 10) CE(2, 4) CE(6, 8) CE(10, 12) CE(1, 9) CE(5, 13)
  CE(5, 9) CE(3, 11) CE(7, 15) CE(7, 11) CE(3, 5) CE(7, 9) CE(11, 13)
  CE(1, 2) CE(3, 4) CE(5, 6) CE(7, 8) CE(9, 10) CE(11, 12) CE(13, 14)
#undef CE
}

// Lane s keeps min(v, partner's) if `low`, else the max.
__device__ __forceinline__ unsigned keep(unsigned v, unsigned other,
                                         bool low) {
  return low ? min(v, other) : max(v, other);
}

// Bitonic merge of the 8 lanes' ascending runs of 4 (element s * 4 + i
// in lane s, register i) into one ascending sequence of 32. Level L
// merges pairs of runs of 4 << L: each element meets its mirror in the
// partner run (lane s ^ (2 << L) - 1, register 3 - i), then half-
// cleaners at lane distances 2^(L-1) .. 1 and in-lane distances 2, 1.
__device__ __forceinline__ void merge_lanes(unsigned (&v)[4], int s) {
#pragma unroll
  for (int L = 0; L < 3; ++L) {
    unsigned o[4];
    const int mirror = (2 << L) - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __shfl_xor_sync(FULL, v[3 - i], mirror);
    const bool low = !(s & (1 << L));
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = keep(v[i], o[i], low);
#pragma unroll
    for (int d = L - 1; d >= 0; --d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = __shfl_xor_sync(FULL, v[i], 1 << d);
      const bool lo_half = !(s & (1 << d));
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = keep(v[i], o[i], lo_half);
    }
    cmp_swap(v[0], v[2]);
    cmp_swap(v[1], v[3]);
    cmp_swap(v[0], v[1]);
    cmp_swap(v[2], v[3]);
  }
}

// The smallest index of the pixel's sorted SPLIT values `arr` whose A
// reaches half (A(arr[SPLIT - 1]) must): 5 sums, at indices 15, then 7
// or 23, and so on.
__device__ __forceinline__ int search(const unsigned* arr,
                                      const float (&w)[PER_LANE],
                                      const unsigned (&k)[PER_LANE],
                                      float half) {
  int at = 0;
#pragma unroll
  for (int step = SPLIT / 2; step > 0; step >>= 1)
    if (weight_upto<false>(w, k, arr[at + step - 1]) < half) at += step;
  return at;
}

// A lane's row of PER_LANE words in shared memory, in chunks of 4; chunk
// i of lane s sits at chunk i ^ ((s >> 1) & 3), so the 8 lanes of a
// pixel reach 32 distinct banks with each 16-byte access.
__device__ __forceinline__ int chunk_at(int s, int i) {
  return 4 * (i ^ ((s >> 1) & 3));
}

__device__ __forceinline__ void store_row(unsigned* row, int s,
                                          const unsigned (&v)[PER_LANE]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<uint4*>(row + chunk_at(s, i)) =
        make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void load_row(const unsigned* row, int s,
                                         unsigned (&v)[PER_LANE]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 c = *reinterpret_cast<const uint4*>(row + chunk_at(s, i));
    v[4 * i] = c.x;
    v[4 * i + 1] = c.y;
    v[4 * i + 2] = c.z;
    v[4 * i + 3] = c.w;
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
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
  extern __shared__ __align__(16) unsigned smem[];
  // Lane-private rows [TILE][LANES][PER_LANE]: sample indices, the
  // median's keys in sample order, the same sorted; a pixel's splitters
  // [TILE][SPLIT]; the offset table [MAX_O] (dx, dy, sf).
  unsigned* s_q = smem;
  unsigned* s_key = s_q + TILE * MAX_O;
  unsigned* s_run = s_key + TILE * MAX_O;
  unsigned* s_split = s_run + TILE * MAX_O;
  int4* s_tab = reinterpret_cast<int4*>(s_split + TILE * SPLIT);
  for (int o = threadIdx.x; o < MAX_O; o += THREADS)
    s_tab[o] = make_int4(tab.dx[o], tab.dy[o], __float_as_int(tab.sf[o]), 0);
  __syncthreads();

  // LANES lanes a pixel, sample o = s + LANES * j on lane s. Samples
  // outside the image or past O read the pixel itself and get weight 0;
  // the key of a weightless sample is never added, so any key will do.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = lane & (LANES - 1);
  const int px = warp * PIX_PER_WARP + lane / LANES;
  const int y = blockIdx.y;
  const int x = blockIdx.x * TILE + px;
  const int p = y * W + min(x, W - 1);
  const int row = (px * LANES + s) * PER_LANE;
  unsigned* const run = s_run + row;
  unsigned* const split = s_split + px * SPLIT;
  float w[PER_LANE];
  {
    const float g0 = gray[p];
    unsigned q[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int o = s + LANES * j;
      const int4 t = s_tab[o];
      const int sx = x + t.x;
      const int sy = y + t.y;
      const bool inside = o < O && x < W && sx >= 0 && sx < W && sy >= 0 &&
                          sy < H;
      q[j] = inside ? sy * W + sx : p;
      const float gq = gray[q[j]];
      const bool rq = reliable[q[j]];
      w[j] = inside && rq
                 ? __fmul_rn(__int_as_float(t.z),
                             expf(__fmul_rn(-fabsf(__fsub_rn(gq, g0)),
                                            inv_sc)))
                 : 0.0f;
    }
    store_row(s_q + row, s, q);
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

  unsigned mi = 0u;
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    // This median's keys, gathered by the lane; a copy sorted, its
    // quartiles merged across the lanes into the splitters.
    unsigned k[PER_LANE];
    unsigned q[4];
    {
      const float* field = c == 0 ? disp : normal + (c - 1);
      const int step = c == 0 ? 1 : 3;
      load_row(s_q + row, s, k);
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        k[j] = ordered_key(field[step * (int)k[j]]);
      store_row(s_key + row, s, k);
      sort16(k);
      store_row(run, s, k);
#pragma unroll
      for (int b = 0; b < 4; ++b) q[b] = k[4 * b + 3];
    }
    unsigned v[4] = {q[0], q[1], q[2], q[3]};
    merge_lanes(v, s);
    *reinterpret_cast<uint4*>(split + 4 * s) = make_uint4(v[0], v[1], v[2],
                                                          v[3]);
    load_row(s_key + row, s, k);
    __syncwarp();

    // Level 1: K lies in (lo, hi] for consecutive splitters lo < hi.
    const int h = search(split, w, k, half);
    const unsigned lov = h > 0 ? split[h - 1] : 0u;
    // Level 2: the lane's block of 4 holding its keys in (lo, hi].
    const int blk = h > 0 ? (q[0] <= lov) + (q[1] <= lov) + (q[2] <= lov)
                          : 0;
    const uint4 b4 = *reinterpret_cast<const uint4*>(run + chunk_at(s, blk));
    v[0] = b4.x;
    v[1] = b4.y;
    v[2] = b4.z;
    v[3] = b4.w;
    merge_lanes(v, s);
    __syncwarp();
    *reinterpret_cast<uint4*>(split + 4 * s) = make_uint4(v[0], v[1], v[2],
                                                          v[3]);
    __syncwarp();
    const int at = search(split, w, k, half);  // every lane: shuffles
    const unsigned mc = half > 0.0f ? split[at] : 0u;
    if (s == 0 && x < W)
      (c == 0 ? donor_disp : c == 1 ? med_nx : c == 2 ? med_ny : med_nz)
          [y * W + x] = key_float(mc);

    if (c == 0) {
      // The donor: the smallest index at the median key whose running
      // weight (base: the weight below that key) reaches half. Index o
      // < mid holds j < ceil((mid - s) / LANES) of the lane's samples, so
      // the lane's part of each sum is a running sum of its weights at
      // the median key, kept in the lane's row of `run`.
      const float base = weight_upto<true>(w, k, mc);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        if (k[j] == mc) acc = __fadd_rn(acc, w[j]);
        k[j] = __float_as_uint(acc);
      }
      store_row(run, s, k);
      for (int i = 0; i < nbits; ++i) {
        const unsigned mid = mi | (1u << (nbits - 1 - i));
        const int upto = min(((int)mid - s + LANES - 1) / LANES, PER_LANE);
        const float part =
            upto > 0 ? __uint_as_float(run[chunk_at(s, (upto - 1) >> 2) +
                                           ((upto - 1) & 3)])
                     : 0.0f;
        if (__fadd_rn(base, lane_tree(part)) < half) mi = mid;
      }
      if (mi > (unsigned)(O - 1)) mi = (unsigned)(O - 1);
    }
    __syncwarp();
  }

  if (s == 0 && x < W) {
    donor_idx[y * W + x] = (long long)mi;
    num[y * W + x] = (long long)valid;
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
