// Weak-texture detection of one view (kernel B7).
//
// Replaces no TPU kernel: the JAX package, like the reference's
// texture() (main.cpp:365-596), runs this stage on the host in numpy and
// scipy (tsar_mvs_tpu/models/weak_texture.py). The port's plain version
// is models/weak_texture.py's numpy code, which runs for a CPU device;
// this kernel runs for a CUDA device and equals it to the bit:
//
//   edges   pyr_levels x pyrDown (scipy correlate1d, mirror border, float64),
//           Roberts cross (float32 from uint8 where the image is
//           integer-valued, native/tsar_native.cpp's branch; float64 rint
//           otherwise), edge = magnitude > rob_thr;
//   label   4-connected components of the non-edge pixels, numbered in
//           raster first-encounter order (tsar_cc_label);
//   hough   per pass-1 region of more than weak_text_num pixels: its
//           boundary (the edge pixels 4-adjacent to it), the
//           (rho, theta) votes, the greedy peak loop of hough_segments
//           and the segments drawn as draw_segment draws them; then the
//           border cleanup;
//   label   pass 2 with counts, coordinate sums and bounding boxes;
//   regions the trueweak rule, the centroids and the upsampled labels.
//
// Every float step is rounded on its own in numpy's order (__dmul_rn,
// __dadd_rn, ...: nvcc would contract a*b+c into an FMA); everything else
// is integer work, exact in any order.
//
// What bounds it on Hopper: not bytes (the 2K view's 11 MB of gray read and
// 11 MB of labels written take 7 us at 3.35 TB/s) but the Hough split's
// dependent chain: at most max_lines (64) peak steps a region, each an
// argmax over the (2 diag + 1) x 180 accumulator (221,000 cells at 2K), a
// compaction, a sort and the used points' votes taken back.
//
// What the design does about it. All launches go on the stream with no
// host round trip until the region table is read back:
//
// * pyramid: one launch a level, each computing only the decimated
//   outputs, the 5 x 5 taps in scipy's summation order (centre, then the
//   pair at distance 2, then the pair at distance 1; mirror indices from
//   the host's table);
// * labels: union-find over the card. A pixel's first parent is the start
//   of its horizontal run inside its warp (ballots), so only vertical
//   unions remain, one per pair of overlapping runs; hooking is a
//   compare-and-swap on a root towards the smaller index, finds halve
//   their paths, so every root is its component's smallest raster index
//   and the raster first-encounter number is an exclusive prefix sum over
//   the root flags (block counts, one scan block, block ranks). Counts,
//   sums and boxes are warp-aggregated atomics;
// * Hough: the regions' list is made on the card (a slot a root by
//   atomics), the boundary points counted, offset and filled per slot,
//   then one cluster of CLUSTER blocks a region runs the peak loop. Each
//   block holds THETAS / CLUSTER angles of the region's accumulator in
//   its shared memory (16-bit cells; 29 KB at 2K), casts their votes and
//   takes their votes back with shared-memory atomics, so the argmax a
//   step reads a block's 15,000 cells and one key from each of the
//   cluster's blocks (distributed shared memory) instead of the whole
//   accumulator from L2. Every block gathers the alive points on the
//   peak's line into its shared memory (GATHER loads a thread in flight),
//   sorts them by (proj, raster index) in a bucket sort and splits the
//   runs by a block scan, all identically; two cluster barriers a step.
//   On an H100 a 2K view takes 1.25 ms of B7's kernels, 1.13 of them this
//   loop (58 steps), where one block a region reading the accumulator
//   from L2 with a bitonic sort took 2.42. Regions are independent
//   (their boundaries come from the pass-1 labels and drawing 255 is
//   idempotent), so clusters take them side by side;
// * regions: one launch writes the upsampled labels and the table rows
//   into one buffer that the host reads back once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int PX = 256;           // threads of a pixel kernel
constexpr int PEAK_THREADS = 1024;
constexpr int SCAN_THREADS = 1024;
constexpr int THETAS = 180;
constexpr int MAX_LEVELS = 6;
// A region's peak loop: a cluster of CLUSTER blocks, each holding
// THETAS / CLUSTER angles of the accumulator; at most PEAK_CLUSTERS
// clusters, which loop over the regions.
constexpr int CLUSTER = 16;
constexpr int NTH_MAX = (THETAS + CLUSTER - 1) / CLUSTER;
constexpr int PEAK_CLUSTERS = 8;
// Points a thread of a peak block loads at once while gathering a line.
constexpr int GATHER = 8;
constexpr int BIAS = 32768;
// pyrDown's taps: [1, 4, 6, 4, 1] / 16, each exact in binary.
constexpr double W0 = 0.0625, W1 = 0.25, W2 = 0.375;

// The scalars' slots (ops/cuda_weak_texture.py SCALARS).
enum { SC_NONINT, SC_R, SC_SEGMENTS, SC_M, SC_OVERFLOW, SC_COUNT = 8 };

struct Stat {       // a pass-2 label's counters
  int cnt, minx, maxx, miny, maxy, pad;
  unsigned long long sx, sy;
};
struct Row {        // a row of the region table, as read back
  double cenx, ceny;
  long long count;
  int size;
  signed char text;
  char pad[3];
};

}  // namespace

// Mirrored by ops/cuda_weak_texture.py `Args` (ctypes), field by field.
struct WeakArgs {
  const void* gray;        // (H, W) float32 or float64
  const double* trig;      // cos[180] then sin[180], numpy's
  const int* taps;         // per level: rows (dh x 5) then columns (dw x 5)
  double* pyr;             // the levels' outputs, one after another
  int* scal;               // SC_COUNT scalars (zeroed)
  int* cnt1;               // pass-1 count by root pixel (zeroed)
  int* bcount;             // boundary points by slot (zeroed)
  int* bfill;              // fill cursors by slot (zeroed)
  unsigned char* edges;    // (h, w) 0 / 255
  int* parent1;            // pass-1 union-find
  int* parent2;            // pass-2 union-find
  int* slot_of;            // slot of a pass-1 root
  int* boff;               // r_max + 1 offsets
  int* pidx;               // boundary points (raster index), by slot
  int* alive;              // their alive flags
  int* blockcnt;           // roots by pixel block
  int* blockoff;           // their exclusive scan
  void* stats;             // Stat[h w + 1]
  int* out_full;           // (H, W) labels
  int* out_small;          // (h, w) labels
  void* table;             // Row[h w + 1]
  double rob_thr, weak_text_num, hough_thr, min_line_length, max_line_gap,
      size_rat;
  int gray_double, H, W, levels, h, w, max_lines;
  int r_max, clusters, diag, rows, cap;
  int level_h[MAX_LEVELS + 1], level_w[MAX_LEVELS + 1];
  long long taps_off[MAX_LEVELS], pyr_off[MAX_LEVELS];
};

namespace {

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Bytes of a peak block's accumulator cells (NTH_MAX angles x rows rho
// bins, 16 bits a cell), on a 16-byte boundary.
__host__ __device__ inline int acc_bytes(int rows) {
  return ((NTH_MAX * rows + 1) / 2 * 4 + 15) / 16 * 16;
}

// Warp-aggregated append: each lane with key >= 0 adds 1 to ctr[key];
// returns the lane's old value plus its rank among the lanes of its key
// (-1 for key < 0). All 32 lanes call it.
__device__ int warp_append(int* ctr, int key) {
  const int lane = lane_id();
  int res = -1;
  unsigned todo = __ballot_sync(FULL, key >= 0);
  while (todo) {
    const int leader = __ffs(todo) - 1;
    const int k = __shfl_sync(FULL, key, leader);
    const unsigned grp = __ballot_sync(FULL, key == k);
    int base = 0;
    if (lane == leader) base = atomicAdd(ctr + k, __popc(grp));
    base = __shfl_sync(FULL, base, leader);
    if (grp >> lane & 1u) res = base + __popc(grp & ((1u << lane) - 1u));
    todo &= ~grp;
  }
  return res;
}

// ---------------------------------------------------------------- edges

template <typename T>
__device__ __forceinline__ double at(const T* p, long long i) {
  return (double)p[i];
}

// scipy's symmetric correlate1d at one point: x0..x4 the taps at offsets
// -2..2 (NI_Correlate1D: centre first, then the pairs outwards-in).
__device__ __forceinline__ double taps5(double x0, double x1, double x2,
                                        double x3, double x4) {
  double s = __dmul_rn(x2, W2);
  s = __dadd_rn(s, __dmul_rn(__dadd_rn(x0, x4), W0));
  return __dadd_rn(s, __dmul_rn(__dadd_rn(x1, x3), W1));
}

// One pyrDown level: the vertical then the horizontal pass of the full
// blur, evaluated only at the kept (even, even) positions; `nonint` (when
// given) gets 1 if any output is not integer-valued.
template <typename T>
__global__ void __launch_bounds__(PX) weak_pyr_kernel(
    const T* __restrict__ src, int sw, double* __restrict__ dst, int dh,
    int dw, const int* __restrict__ rt, const int* __restrict__ ct,
    int* nonint) {
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  bool frac = false;
  if (i < (long long)dh * dw) {
    const int r = (int)(i / dw), c = (int)(i % dw);
    const int* ry = rt + r * 5;
    const int* cx = ct + c * 5;
    const long long r0 = (long long)ry[0] * sw, r1 = (long long)ry[1] * sw,
                    r2 = (long long)ry[2] * sw, r3 = (long long)ry[3] * sw,
                    r4 = (long long)ry[4] * sw;
    double v[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int col = cx[k];
      v[k] = taps5(at(src, r0 + col), at(src, r1 + col), at(src, r2 + col),
                   at(src, r3 + col), at(src, r4 + col));
    }
    const double o = taps5(v[0], v[1], v[2], v[3], v[4]);
    dst[i] = o;
    frac = !(o == rint(o));
  }
  if (nonint != nullptr && __any_sync(FULL, frac) && lane_id() == 0)
    atomicOr(nonint, 1);
}

// The same flag over an image that no pyramid level makes (pyr_levels 0).
__global__ void __launch_bounds__(PX) weak_intflag_kernel(
    const double* __restrict__ img, long long n, int* nonint) {
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  const bool frac = i < n && !(img[i] == rint(img[i]));
  if (__any_sync(FULL, frac) && lane_id() == 0) atomicOr(nonint, 1);
}

// numpy's clip to [0, 255] and cast to uint8 of an integer value.
__device__ __forceinline__ float as_u8(double v) {
  return (float)(unsigned char)(int)fmin(fmax(v, 0.0), 255.0);
}

// Whether pixel i is an edge: roberts(), then magnitude > rob_thr.
__device__ bool roberts_edge(const double* __restrict__ img, int h, int w,
                             long long i, bool integer, double rob_thr) {
  const int y = (int)(i / w), x = (int)(i % w);
  double mag;
  if (y == 0 || y == h - 1 || x == 0 || x == w - 1) {
    mag = 100.0;
  } else if (integer) {
    // tsar_roberts: float differences of the uint8 image,
    // sqrtf(d1 d1 + d2 d2) + 0.5f, saturated at 255, truncated.
    const float d1 = __fsub_rn(as_u8(img[i]), as_u8(img[i + w + 1]));
    const float d2 = __fsub_rn(as_u8(img[i + w]), as_u8(img[i + 1]));
    float m = __fadd_rn(
        __fsqrt_rn(__fadd_rn(__fmul_rn(d1, d1), __fmul_rn(d2, d2))), 0.5f);
    if (m > 255.0f) m = 255.0f;
    mag = (double)(unsigned char)(int)m;
  } else {
    const double d1 = __dsub_rn(img[i], img[i + w + 1]);
    const double d2 = __dsub_rn(img[i + w], img[i + 1]);
    mag = fmin(fmax(rint(__dsqrt_rn(__dadd_rn(__dmul_rn(d1, d1),
                                              __dmul_rn(d2, d2)))),
                    0.0),
               255.0);
    mag = (double)(unsigned char)(int)mag;
  }
  return mag > rob_thr;
}

// A pixel's first parent: the start of its horizontal run of non-edge
// pixels inside its warp's 32 pixels, or, where the run comes from before
// the warp, the warp's first pixel (lane 0: the pixel before it). -1 for
// an edge pixel. All 32 lanes call it.
__device__ int run_parent(long long i, long long n, int w, bool edge,
                          bool left_edge) {
  const int lane = lane_id();
  const bool valid = i < n && !edge;
  const bool start = valid && ((int)(i % w) == 0 || left_edge);
  const unsigned starts = __ballot_sync(FULL, start);
  if (!valid) return -1;
  const unsigned below = starts & (lane == 31 ? FULL : ((2u << lane) - 1u));
  if (below) return (int)(i - lane + (31 - __clz(below)));
  return lane == 0 ? (int)(i - 1) : (int)(i - lane);
}

// Roberts and the threshold, and (when parent is given) pass 1's first
// parents.
__global__ void __launch_bounds__(PX) weak_roberts_kernel(
    const double* __restrict__ img, int h, int w, const int* nonint,
    double rob_thr, unsigned char* __restrict__ edges, int* parent) {
  const long long n = (long long)h * w;
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  const bool integer = *nonint == 0;
  bool edge = true, left_edge = true;
  if (i < n) {
    edge = roberts_edge(img, h, w, i, integer, rob_thr);
    edges[i] = edge ? 255 : 0;
    if (i % w != 0) left_edge = roberts_edge(img, h, w, i - 1, integer,
                                             rob_thr);
  }
  if (parent != nullptr) {
    const int p = run_parent(i, n, w, edge, left_edge);
    if (i < n) parent[i] = p;
  }
}

// ---------------------------------------------------------------- labels

// The root of x, halving the path (ECL-CC's representative()): only
// non-roots are rewritten here and only roots by hooks, so any ancestor
// written is still one.
__device__ __forceinline__ int uf_find(int* p, int x) {
  int cur = __ldcg(p + x);
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = __ldcg(p + cur))) {
      __stcg(p + prev, next);
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// The root of x without writing: once the unions are done each thread
// writes its own pixel's root, and a halving write racing with that
// store could leave a non-root there.
__device__ __forceinline__ int uf_root(const int* p, int x) {
  int cur = p[x];
  while (cur != x) {
    x = cur;
    cur = p[x];
  }
  return cur;
}

// Hook the larger root under the smaller one.
__device__ void uf_unite(int* p, int a, int b) {
  while (true) {
    a = uf_find(p, a);
    b = uf_find(p, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(p + b, b, a) == b) return;
  }
}

// The vertical unions: pixel i with its upper neighbour, unless its left
// neighbour joins the same two runs.
__global__ void __launch_bounds__(PX) weak_merge_kernel(int* parent, int h,
                                                        int w) {
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  if (i < w || i >= (long long)h * w) return;
  if (__ldcg(parent + i) < 0 || __ldcg(parent + i - w) < 0) return;
  if (i % w != 0 && __ldcg(parent + i - 1) >= 0 &&
      __ldcg(parent + i - w - 1) >= 0)
    return;
  uf_unite(parent, (int)i, (int)(i - w));
}

// Every non-edge pixel's root, written back; pass 1's counts by root.
__global__ void __launch_bounds__(PX) weak_count_kernel(int* parent,
                                                        long long n,
                                                        int* cnt) {
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  int root = -1;
  if (i < n && parent[i] >= 0) {
    root = uf_root(parent, (int)i);
    parent[i] = root;
  }
  warp_append(cnt, root);
}

// Pass 2's roots, written back, and the number of roots a block.
__global__ void __launch_bounds__(PX) weak_roots_kernel(int* parent,
                                                        long long n,
                                                        int* blockcnt) {
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  bool root = false;
  if (i < n && parent[i] >= 0) {
    const int r = uf_root(parent, (int)i);
    parent[i] = r;
    root = r == (int)i;
  }
  const int c = __syncthreads_count(root);
  if (threadIdx.x == 0) blockcnt[blockIdx.x] = c;
}

// Exclusive scan of in[0, n) into out[0, n], out[n] the total; one block.
__device__ int block_scan_global(const int* in, int* out, int n) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  __shared__ int carry;
  const int lane = lane_id(), wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += SCAN_THREADS) {
    const int j = base + threadIdx.x;
    const int v = j < n ? in[j] : 0;
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += u;
    }
    if (lane == 31) warp_sum[wid] = s;
    __syncthreads();
    if (wid == 0) {
      int t = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, t, o);
        if (lane >= o) t += u;
      }
      warp_sum[lane] = t;
    }
    __syncthreads();
    const int incl = s + (wid ? warp_sum[wid - 1] : 0) + carry;
    if (j < n) out[j] = incl - v;
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[n] = carry;
  return carry;
}

// The blocks' root offsets; M, the number of labels with label 0.
__global__ void __launch_bounds__(SCAN_THREADS) weak_scan_kernel(
    const int* blockcnt, int* blockoff, int nb, int* scal) {
  const int total = block_scan_global(blockcnt, blockoff, nb);
  if (threadIdx.x == 0) scal[SC_M] = total + 1;
}

// A root's label: its block's offset, plus its rank among the block's
// roots, plus 1; its counters reset. Edge pixels take label 0.
__global__ void __launch_bounds__(PX) weak_rootlabel_kernel(
    const int* parent, long long n, const int* blockoff, int* labels,
    Stat* stats) {
  __shared__ int warp_cnt[PX / 32];
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  const int lane = lane_id(), wid = threadIdx.x >> 5;
  const int p = i < n ? parent[i] : -1;
  const bool root = i < n && p == (int)i;
  const unsigned b = __ballot_sync(FULL, root);
  if (lane == 0) warp_cnt[wid] = __popc(b);
  __syncthreads();
  int before = 0;
  for (int k = 0; k < wid; ++k) before += warp_cnt[k];
  if (root) {
    const int label = blockoff[blockIdx.x] + before +
                      __popc(b & ((1u << lane) - 1u)) + 1;
    labels[i] = label;
    stats[label] = Stat{0, 0x7fffffff, -1, 0x7fffffff, -1, 0, 0ull, 0ull};
  } else if (i < n && p < 0) {
    labels[i] = 0;
  }
  if (i == 0) stats[0] = Stat{0, 0x7fffffff, -1, 0x7fffffff, -1, 0, 0ull, 0ull};
}

// Every pixel's label from its root's; counts, coordinate sums and boxes
// by label, one atomic per label a warp.
__global__ void __launch_bounds__(PX) weak_stats_kernel(
    const int* parent, int h, int w, int* labels, Stat* stats) {
  const long long n = (long long)h * w;
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  const int lane = lane_id();
  int label = -1;
  unsigned x = 0, y = 0;
  if (i < n) {
    const int p = parent[i];
    if (p < 0) {
      label = 0;
    } else if (p == (int)i) {
      label = labels[i];
    } else {
      label = labels[p];
      labels[i] = label;
    }
    x = (unsigned)(i % w);
    y = (unsigned)(i / w);
  }
  unsigned todo = __ballot_sync(FULL, label >= 0);
  while (todo) {
    const int leader = __ffs(todo) - 1;
    const int k = __shfl_sync(FULL, label, leader);
    const bool mine = label == k;
    const unsigned grp = __ballot_sync(FULL, mine);
    const unsigned sx = __reduce_add_sync(FULL, mine ? x : 0u);
    const unsigned sy = __reduce_add_sync(FULL, mine ? y : 0u);
    const unsigned mnx = __reduce_min_sync(FULL, mine ? x : 0xffffffffu);
    const unsigned mxx = __reduce_max_sync(FULL, mine ? x : 0u);
    const unsigned mny = __reduce_min_sync(FULL, mine ? y : 0xffffffffu);
    const unsigned mxy = __reduce_max_sync(FULL, mine ? y : 0u);
    if (lane == leader) {
      Stat* s = stats + k;
      atomicAdd(&s->cnt, __popc(grp));
      atomicAdd(&s->sx, (unsigned long long)sx);
      atomicAdd(&s->sy, (unsigned long long)sy);
      atomicMin(&s->minx, (int)mnx);
      atomicMax(&s->maxx, (int)mxx);
      atomicMin(&s->miny, (int)mny);
      atomicMax(&s->maxy, (int)mxy);
    }
    todo &= ~grp;
  }
}

// ---------------------------------------------------------------- hough

// A slot for every pass-1 root of more than weak_text_num pixels.
__global__ void __launch_bounds__(PX) weak_select_kernel(WeakArgs a) {
  const long long n = (long long)a.h * a.w;
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  if (i >= n || a.parent1[i] != (int)i) return;
  if (!((double)a.cnt1[i] > a.weak_text_num)) return;
  const int s = atomicAdd(a.scal + SC_R, 1);
  if (s < a.r_max) a.slot_of[i] = s;
  else atomicOr(a.scal + SC_OVERFLOW, 1);
}

// The slot of the k-th distinct large region 4-adjacent to edge pixel i,
// or -1.
__device__ void boundary_slots(const WeakArgs& a, long long i, int out[4]) {
  out[0] = out[1] = out[2] = out[3] = -1;
  const long long n = (long long)a.h * a.w;
  if (i >= n || a.parent1[i] >= 0) return;
  const int w = a.w, x = (int)(i % w);
  const long long nb[4] = {i - w, i + w, x > 0 ? i - 1 : -1,
                           x < w - 1 ? i + 1 : -1};
  int roots[4], m = 0;
  for (int k = 0; k < 4; ++k) {
    const long long q = nb[k];
    if (q < 0 || q >= n) continue;
    const int r = a.parent1[q];
    if (r < 0 || !((double)a.cnt1[r] > a.weak_text_num)) continue;
    bool seen = false;
    for (int j = 0; j < m; ++j) seen |= roots[j] == r;
    if (!seen) roots[m++] = r;
  }
  for (int j = 0; j < m; ++j) {
    const int s = a.slot_of[roots[j]];
    out[j] = s < a.r_max ? s : -1;
  }
}

__global__ void __launch_bounds__(PX) weak_bcount_kernel(WeakArgs a) {
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  int s[4];
  boundary_slots(a, i, s);
  for (int k = 0; k < 4; ++k) warp_append(a.bcount, s[k]);
}

__global__ void __launch_bounds__(SCAN_THREADS) weak_boffsets_kernel(
    WeakArgs a) {
  block_scan_global(a.bcount, a.boff, min(a.scal[SC_R], a.r_max));
}

__global__ void __launch_bounds__(PX) weak_bfill_kernel(WeakArgs a) {
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  int s[4];
  boundary_slots(a, i, s);
  for (int k = 0; k < 4; ++k) {
    const int pos = warp_append(a.bfill, s[k]);
    if (s[k] >= 0) {
      const int at_ = a.boff[s[k]] + pos;
      a.pidx[at_] = (int)i;
      a.alive[at_] = 1;
    }
  }
}

// hough_segments' rho bin of point (x, y) at angle t, offset by diag:
// rint(x cos + y sin), each product rounded, as numpy computes it.
__device__ __forceinline__ int rho_bin(double x, double y, const double* cs,
                                       const double* sn, int t, int diag) {
  return (int)rint(__dadd_rn(__dmul_rn(x, cs[t]), __dmul_rn(y, sn[t]))) +
         diag;
}

// Inclusive scan of a[0, n) in shared memory, in place, by the whole block
// (PEAK_THREADS); returns the total.
__device__ int block_scan_shared(int* a, int n) {
  __shared__ int warp_sum[PEAK_THREADS / 32];
  __shared__ int total;
  const int lane = lane_id(), wid = threadIdx.x >> 5;
  const int per = (n + PEAK_THREADS - 1) / PEAK_THREADS;
  const int b = min((int)threadIdx.x * per, n), e = min(b + per, n);
  int local = 0;
  for (int k = b; k < e; ++k) local += a[k];
  int s = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, s, o);
    if (lane >= o) s += u;
  }
  if (lane == 31) warp_sum[wid] = s;
  __syncthreads();
  if (wid == 0) {
    int t = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += u;
    }
    warp_sum[lane] = t;
    if (lane == 31) total = t;
  }
  __syncthreads();
  int run = s - local + (wid ? warp_sum[wid - 1] : 0);
  for (int k = b; k < e; ++k) {
    run += a[k];
    a[k] = run;
  }
  __syncthreads();
  return total;
}

// A gathered point's bucket: floor(proj - the least proj), a monotone
// map of proj, kept below cap.
__device__ __forceinline__ int bucket_of(double key, double least,
                                         int cap) {
  return (int)fmin(floor(__dsub_rn(key, least)), (double)(cap - 1));
}

// linspace(a, b, n)[k] rounded to int, in numpy's arithmetic: k times
// (b - a) / (n - 1), plus a; the last point b.
__device__ __forceinline__ int lin_at(int a, int b, int n, int k) {
  if (n == 1) return a;
  if (k == n - 1) return b;
  const double step = __ddiv_rn((double)(b - a), (double)(n - 1));
  return (int)rint(__dadd_rn(__dmul_rn((double)k, step), (double)a));
}

// A peak block's accumulator cells: 16 bits each, two a 32-bit word,
// biased by BIAS so that a cell never carries into its neighbour (a cell
// lies within +-cap, far inside +-BIAS: a bin holds at most cap points).
__device__ __forceinline__ int cell_get(const unsigned* acc, int c) {
  return (int)((acc[c >> 1] >> ((c & 1) * 16)) & 0xffffu) - BIAS;
}
__device__ __forceinline__ void cell_add(unsigned* acc, int c, int d) {
  atomicAdd(acc + (c >> 1), (unsigned)d << ((c & 1) * 16));
}
__device__ __forceinline__ int theta0(int rank) {
  return THETAS * rank / CLUSTER;
}

// The greedy peak loop of hough_segments, one cluster of CLUSTER blocks a
// region (clusters loop over the slots). Rank b holds the accumulator's
// angles [theta0(b), theta0(b + 1)) for every rho in its shared memory,
// votes them and takes its points' votes back there; a step's argmax is
// each block's first maximum (the key value << 32 | ~(rho 180 + t), the
// value's sign flipped: a cell zeroed at a peak goes negative when its
// points are used by a later line) and the largest of the cluster's
// CLUSTER keys. Every block then gathers, sorts and splits the same
// points, so every block takes the same decisions; rank 0 draws the
// segments and marks the used points dead after the step's last cluster
// barrier, which every block's gathering of the step has passed.
//
// The sort is a bucket sort on floor(proj - min proj), a monotone map of
// proj, then (proj, raster index) order inside each bucket (insertion):
// the points of one rho bin lie in a strip one pixel wide, so a bucket one
// unit long holds at most two of them, and the sort takes a few barriers
// where a bitonic network would take up to 66.
__global__ void __launch_bounds__(PEAK_THREADS) weak_peaks_kernel(WeakArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem[];
  const int cap = a.cap, rows = a.rows;
  const int t0 = theta0(rank), nth = theta0(rank + 1) - t0;
  unsigned* acc = (unsigned*)smem;
  // The gathered points; once sorted, their bytes hold the runs.
  double* key = (double*)(smem + acc_bytes(rows));
  int* rid = (int*)(key + cap);
  int* loc = rid + cap;
  // The sorted points, and the buckets.
  double* skey = (double*)(loc + cap);
  int* srid = (int*)(skey + cap);
  int* sloc = srid + cap;
  int* bk = sloc + cap;
  int* run = (int*)key;
  int* rs = run + cap;
  int* re = rid;
  unsigned char* qual = (unsigned char*)loc;
  __shared__ double cs[THETAS], sn[THETAS];
  __shared__ unsigned long long wbest[PEAK_THREADS / 32];
  __shared__ double wmin[PEAK_THREADS / 32];
  __shared__ unsigned long long cand, gbest;
  __shared__ int s_cnt, s_nseg;

  const int w = a.w, tid = threadIdx.x, lane = lane_id(), wid = tid >> 5;
  for (int t = tid; t < THETAS; t += PEAK_THREADS) {
    cs[t] = a.trig[t];
    sn[t] = a.trig[THETAS + t];
  }
  const int R = min(a.scal[SC_R], a.r_max);
  const int nwords = (nth * rows + 1) / 2;
  for (int slot = (int)(blockIdx.x / CLUSTER); slot < R;
       slot += (int)(gridDim.x / CLUSTER)) {
    const int p0 = a.boff[slot], n = a.boff[slot + 1] - p0;
    if (n == 0) continue;
    // Votes of this rank's angles.
    for (int v = tid; v < nwords; v += PEAK_THREADS)
      acc[v] = (unsigned)BIAS << 16 | (unsigned)BIAS;
    __syncthreads();
    for (int j = tid; j < n * nth; j += PEAK_THREADS) {
      const int pix = a.pidx[p0 + j / nth], jj = j % nth;
      cell_add(acc,
               jj * rows + rho_bin((double)(pix % w), (double)(pix / w), cs,
                                   sn, t0 + jj, a.diag),
               1);
    }
    __syncthreads();
    for (int step = 0; step < a.max_lines; ++step) {
      // This rank's first maximum, then the cluster's.
      unsigned long long best = 0;
      for (int jj = 0; jj < nth; ++jj)
        for (int r = tid; r < rows; r += PEAK_THREADS) {
          const unsigned long long kk =
              (unsigned long long)((unsigned)cell_get(acc, jj * rows + r) ^
                                   0x80000000u)
                  << 32 |
              (0xffffffffu - (unsigned)(r * THETAS + t0 + jj));
          best = kk > best ? kk : best;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long u = __shfl_xor_sync(FULL, best, o);
        best = u > best ? u : best;
      }
      if (lane == 0) wbest[wid] = best;
      __syncthreads();
      if (tid == 0) {
        for (int k = 1; k < PEAK_THREADS / 32; ++k)
          best = wbest[k] > best ? wbest[k] : best;
        cand = best;
      }
      cluster.sync();
      if (wid == 0) {
        best = lane < CLUSTER ? *cluster.map_shared_rank(&cand, lane) : 0ull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const unsigned long long u = __shfl_xor_sync(FULL, best, o);
          best = u > best ? u : best;
        }
        if (lane == 0) {
          gbest = best;
          s_cnt = 0;
          s_nseg = 0;
        }
      }
      __syncthreads();
      best = gbest;
      const int value = (int)((unsigned)(best >> 32) ^ 0x80000000u);
      const int peak = (int)(0xffffffffu - (unsigned)(best & 0xffffffffu));
      if ((double)value < a.hough_thr) break;
      const int r = peak / THETAS, t = peak % THETAS;
      const bool owner = t >= t0 && t < t0 + nth;
      // The alive points on the line, GATHER points a thread in flight.
      for (int base = tid; base < n; base += PEAK_THREADS * GATHER) {
        int alive[GATHER], pix[GATHER];
#pragma unroll
        for (int u = 0; u < GATHER; ++u) {
          const int i = base + u * PEAK_THREADS;
          alive[u] = i < n ? __ldcg(a.alive + p0 + i) : 0;
          pix[u] = i < n ? __ldg(a.pidx + p0 + i) : 0;
        }
#pragma unroll
        for (int u = 0; u < GATHER; ++u) {
          if (!alive[u]) continue;
          const double x = (double)(pix[u] % w), y = (double)(pix[u] / w);
          if (rho_bin(x, y, cs, sn, t, a.diag) != r) continue;
          const int k = atomicAdd(&s_cnt, 1);
          if (k < cap) {
            key[k] = __dadd_rn(-__dmul_rn(x, sn[t]), __dmul_rn(y, cs[t]));
            rid[k] = pix[u];
            loc[k] = base + u * PEAK_THREADS;
          }
        }
      }
      __syncthreads();
      const int K = s_cnt;
      if (K > cap) {
        if (tid == 0 && rank == 0) atomicOr(a.scal + SC_OVERFLOW, 2);
        break;
      }
      int nruns = 0, nseg = 0;
      if (K > 0) {
        // The bucket sort: the least proj, the buckets' counts, their
        // ends by a scan, the points scattered, each bucket in order.
        double m = INFINITY;
        for (int i = tid; i < K; i += PEAK_THREADS) m = fmin(m, key[i]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmin(m, __shfl_xor_sync(FULL, m, o));
        if (lane == 0) wmin[wid] = m;
        for (int b = tid; b < cap; b += PEAK_THREADS) bk[b] = 0;
        __syncthreads();
        m = wmin[0];
        for (int k = 1; k < PEAK_THREADS / 32; ++k) m = fmin(m, wmin[k]);
        for (int i = tid; i < K; i += PEAK_THREADS)
          atomicAdd(bk + bucket_of(key[i], m, cap), 1);
        __syncthreads();
        block_scan_shared(bk, cap);
        for (int i = tid; i < K; i += PEAK_THREADS) {
          const int at_ = atomicSub(bk + bucket_of(key[i], m, cap), 1) - 1;
          skey[at_] = key[i];
          srid[at_] = rid[i];
          sloc[at_] = loc[i];
        }
        __syncthreads();
        for (int b = tid; b < cap; b += PEAK_THREADS) {
          const int lo = bk[b], hi = b + 1 < cap ? bk[b + 1] : K;
          for (int i = lo + 1; i < hi; ++i) {
            const double kk = skey[i];
            const int rr = srid[i], ll = sloc[i];
            int j = i - 1;
            while (j >= lo && (skey[j] > kk || (skey[j] == kk && srid[j] > rr))) {
              skey[j + 1] = skey[j];
              srid[j + 1] = srid[j];
              sloc[j + 1] = sloc[j];
              --j;
            }
            skey[j + 1] = kk;
            srid[j + 1] = rr;
            sloc[j + 1] = ll;
          }
        }
        __syncthreads();
        // Runs split at gaps > max_line_gap; run ids by a scan of the
        // starts; a run is a segment when it spans min_line_length.
        for (int i = tid; i < K; i += PEAK_THREADS)
          run[i] = (i == 0 || __dsub_rn(skey[i], skey[i - 1]) > a.max_line_gap);
        __syncthreads();
        nruns = block_scan_shared(run, K);
        for (int i = tid; i < K; i += PEAK_THREADS) {
          const int q = run[i] - 1;
          if (i == 0 || __dsub_rn(skey[i], skey[i - 1]) > a.max_line_gap)
            rs[q] = i;
          if (i == K - 1 || __dsub_rn(skey[i + 1], skey[i]) > a.max_line_gap)
            re[q] = i;
        }
        __syncthreads();
        for (int q = tid; q < nruns; q += PEAK_THREADS) {
          qual[q] = __dsub_rn(skey[re[q]], skey[rs[q]]) >= a.min_line_length;
          if (qual[q]) atomicAdd(&s_nseg, 1);
        }
        __syncthreads();
        nseg = s_nseg;
      }
      if (nseg == 0) {
        // No point used: the peak's cell is zeroed.
        if (owner && tid == 0) {
          const int c = (t - t0) * rows + r;
          cell_add(acc, c, -cell_get(acc, c));
        }
      } else {
        // The used points' votes of this rank's angles taken back.
        for (int j = tid; j < K * nth; j += PEAK_THREADS) {
          const int i = j / nth, jj = j % nth;
          if (!qual[run[i] - 1]) continue;
          const int pix = srid[i];
          cell_add(acc,
                   jj * rows + rho_bin((double)(pix % w), (double)(pix / w),
                                       cs, sn, t0 + jj, a.diag),
                   -1);
        }
        if (rank == 0) {
          // The segments, drawn (draw_segment).
          for (int q = 0; q < nruns; ++q) {
            if (!qual[q]) continue;
            const int pa = srid[rs[q]], pb = srid[re[q]];
            const int x1 = pa % w, y1 = pa / w, x2 = pb % w, y2 = pb / w;
            const int np = max(abs(x2 - x1), abs(y2 - y1)) + 1;
            for (int k = tid; k < np; k += PEAK_THREADS) {
              const int xx = lin_at(x1, x2, np, k), yy = lin_at(y1, y2, np, k);
              if (xx >= 0 && xx < w && yy >= 0 && yy < a.h)
                a.edges[(long long)yy * w + xx] = 255;
            }
          }
          if (tid == 0) atomicAdd(a.scal + SC_SEGMENTS, nseg);
        }
      }
      cluster.sync();
      // Every block has gathered this step's points: rank 0 marks the
      // used ones dead before it reaches the next step's barrier.
      if (rank == 0 && nseg > 0)
        for (int i = tid; i < K; i += PEAK_THREADS)
          if (qual[run[i] - 1]) __stcg(a.alive + p0 + sloc[i], 0);
      __syncthreads();
    }
    // No block leaves (or starts the next slot) while another may still
    // read its key.
    cluster.sync();
  }
}

// The border cleanup (weak_texture.py, main.cpp:444-456) as a function of
// the drawn edges: column 0 from column 1, column w-1 from column w-2,
// then row 0 from row 1, then row h-1 from row h-2, each after the one
// before.
__device__ __forceinline__ unsigned char e0(const unsigned char* e, int w,
                                            int y, int x) {
  return e[(long long)y * w + x];
}
__device__ unsigned char c1(const unsigned char* e, int w, int y, int x) {
  return (x == 0 && e0(e, w, y, 1) == 0) ? 0 : e0(e, w, y, x);
}
__device__ unsigned char c2(const unsigned char* e, int w, int y, int x) {
  return (x == w - 1 && c1(e, w, y, w - 2) == 0) ? 0 : c1(e, w, y, x);
}
__device__ unsigned char c3(const unsigned char* e, int w, int y, int x) {
  return (y == 0 && c2(e, w, 1, x) == 0) ? 0 : c2(e, w, y, x);
}
__device__ unsigned char c4(const unsigned char* e, int h, int w, int y,
                            int x) {
  return (y == h - 1 && c3(e, w, h - 2, x) == 0) ? 0 : c3(e, w, y, x);
}

// Pass 2's first parents on the cleaned edges.
__global__ void __launch_bounds__(PX) weak_init2_kernel(
    const unsigned char* __restrict__ edges, int h, int w, int* parent) {
  const long long n = (long long)h * w;
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  bool edge = true, left_edge = true;
  if (i < n) {
    const int y = (int)(i / w), x = (int)(i % w);
    edge = c4(edges, h, w, y, x) != 0;
    if (x > 0) left_edge = c4(edges, h, w, y, x - 1) != 0;
  }
  const int p = run_parent(i, n, w, edge, left_edge);
  if (i < n) parent[i] = p;
}

// ---------------------------------------------------------------- regions

// The labels upsampled with index clamping, and the region table's rows.
__global__ void __launch_bounds__(PX) weak_finish_kernel(WeakArgs a) {
  const long long i = (long long)blockIdx.x * PX + threadIdx.x;
  const int scale = 1 << a.levels;
  if (i < (long long)a.H * a.W) {
    const int y = (int)(i / a.W), x = (int)(i % a.W);
    const int iy = min(y / scale, a.h - 1), ix = min(x / scale, a.w - 1);
    a.out_full[i] = a.out_small[(long long)iy * a.w + ix];
  }
  if (i < a.scal[SC_M]) {
    const Stat s = ((const Stat*)a.stats)[i];
    const double cnt = (double)(s.cnt > 1 ? s.cnt : 1);
    Row row;
    row.cenx = __ddiv_rn(__dmul_rn((double)s.sx, (double)scale), cnt);
    row.ceny = __ddiv_rn(__dmul_rn((double)s.sy, (double)scale), cnt);
    row.count = s.cnt;
    row.size = 0;
    row.text = 1;
    row.pad[0] = row.pad[1] = row.pad[2] = 0;
    if (i > 0 && (double)s.cnt > a.weak_text_num) {
      const int xs = s.maxx - s.minx, ys = s.maxy - s.miny;
      const long long xy = (long long)xs * ys;
      if ((double)xy < __dmul_rn(a.size_rat, (double)s.cnt) ||
          s.cnt > 100000) {
        row.text = -1;
        row.size = xs > ys ? xs : ys;
      }
    }
    ((Row*)a.table)[i] = row;
  }
}

unsigned grid_of(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// The dynamic shared memory of a peak block: its angles' cells at `rows`
// rho bins and the gathered points, `cap` at most (ops/cuda_weak_texture.py
// Plan.peak_smem).
int peak_smem(int cap, int rows) { return acc_bytes(rows) + cap * 36; }

}  // namespace

// Each entry point queues its launches on `stream` and returns
// cudaGetLastError(); ops/cuda_weak_texture.py's `plan` lists them.

extern "C" int tsar_weak_edges(const WeakArgs* a, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (a->levels < 0 || a->levels > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  const double* img = (const double*)a->gray;
  for (int l = 0; l < a->levels; ++l) {
    const int dh = a->level_h[l + 1], dw = a->level_w[l + 1];
    const int* rt = a->taps + a->taps_off[l];
    const int* ct = rt + (long long)dh * 5;
    double* dst = a->pyr + a->pyr_off[l];
    int* flag = l == a->levels - 1 ? a->scal + SC_NONINT : nullptr;
    const unsigned g = grid_of((long long)dh * dw, PX);
    if (l == 0 && !a->gray_double)
      weak_pyr_kernel<float><<<g, PX, 0, st>>>(
          (const float*)a->gray, a->level_w[0], dst, dh, dw, rt, ct, flag);
    else
      weak_pyr_kernel<double><<<g, PX, 0, st>>>(
          img, a->level_w[l], dst, dh, dw, rt, ct, flag);
    img = dst;
  }
  const long long n = (long long)a->h * a->w;
  if (a->levels == 0)
    weak_intflag_kernel<<<grid_of(n, PX), PX, 0, st>>>(img, n,
                                                      a->scal + SC_NONINT);
  weak_roberts_kernel<<<grid_of(n, PX), PX, 0, st>>>(
      img, a->h, a->w, a->scal + SC_NONINT, a->rob_thr, a->edges,
      a->r_max > 0 ? a->parent1 : nullptr);
  return (int)cudaGetLastError();
}

extern "C" int tsar_weak_label(const WeakArgs* a, int pass, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)a->h * a->w;
  const unsigned g = grid_of(n, PX);
  int* parent = pass == 1 ? a->parent1 : a->parent2;
  weak_merge_kernel<<<g, PX, 0, st>>>(parent, a->h, a->w);
  if (pass == 1) {
    weak_count_kernel<<<g, PX, 0, st>>>(parent, n, a->cnt1);
  } else {
    weak_roots_kernel<<<g, PX, 0, st>>>(parent, n, a->blockcnt);
    weak_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(a->blockcnt, a->blockoff,
                                                 (int)g, a->scal);
    weak_rootlabel_kernel<<<g, PX, 0, st>>>(parent, n, a->blockoff,
                                            a->out_small, (Stat*)a->stats);
    weak_stats_kernel<<<g, PX, 0, st>>>(parent, a->h, a->w, a->out_small,
                                        (Stat*)a->stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int tsar_weak_hough(const WeakArgs* a, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)a->h * a->w;
  const unsigned g = grid_of(n, PX);
  if (a->r_max > 0) {
    const int smem = peak_smem(a->cap, a->rows);
    cudaError_t err = cudaFuncSetAttribute(
        weak_peaks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(weak_peaks_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return (int)err;
    weak_select_kernel<<<g, PX, 0, st>>>(*a);
    weak_bcount_kernel<<<g, PX, 0, st>>>(*a);
    weak_boffsets_kernel<<<1, SCAN_THREADS, 0, st>>>(*a);
    weak_bfill_kernel<<<g, PX, 0, st>>>(*a);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a->clusters * CLUSTER);
    cfg.blockDim = dim3(PEAK_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, weak_peaks_kernel, *a);
    if (err != cudaSuccess) return (int)err;
  }
  weak_init2_kernel<<<g, PX, 0, st>>>(a->edges, a->h, a->w, a->parent2);
  return (int)cudaGetLastError();
}

extern "C" int tsar_weak_regions(const WeakArgs* a, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long full = (long long)a->H * a->W;
  const long long rows = (long long)a->h * a->w + 1;
  weak_finish_kernel<<<grid_of(full > rows ? full : rows, PX), PX, 0, st>>>(
      *a);
  return (int)cudaGetLastError();
}
