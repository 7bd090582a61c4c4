// Backward of the fan-out-regular masked neighbour mean for Hopper
// (sm_90a): dh[s] = sum over unmasked edges e with src_e = s of
// g[e / fanout] / max(cnt[e / fanout], 1), dh of shape (m, d), each row
// summed in ascending edge order from +0, rows no edge reads written 0.
//
// Replaces the custom VJP of repro/kernels/gather_agg/ops.py
// (`_kernel_bwd`, one segment_sum of the scaled messages over edge_src).
// A scatter-add with float atomics would sum each row in whatever order
// the atomics land, so two runs could differ in the last bit. Here the
// sum is a gather: each row's edges are listed, put in edge order, and
// added in that order, so the result is the sequential scatter-add in
// edge order, bit for bit. Edges are dst-major, so edge order is
// ascending dst row, and two edges of one row with the same dst row add
// the same term: a row's edges sorted by dst row are in edge order.
//
// Bound: bytes. The (m, d) float32 output written once is nearly all of
// them (21.6 MB at the training path's layer 1, 6.5 us at 3.35 TB/s);
// g (1 MB) and the edge lists are small. What held the first design back
// was everything before the output: twelve launches (a sentinel key
// array, a six-launch multi-block radix sort, a count pass, a pass of
// m + 1 binary searches) and then one block per (row, 128 columns), more
// than half of them writing only zeros. On this card each dependent trip
// to memory costs microseconds while the output streams out, so the
// design counts trips. Two launches, for up to 16,384 edges and 32,768
// rows:
//
//   1. order_kernel, one block a multiprocessor. Block 0 is a counting
//      sort by source in shared memory: it reads edge_src and edge_mask
//      directly, counts each source's and each dst row's unmasked edges,
//      scans the source counts into each row's first slot, places each
//      edge in its source's run at a slot an integer atomic hands out (so
//      in no fixed order), and writes the runs out once, coalesced: each
//      edge's dst row, count and source. Meanwhile the other blocks sum
//      the hub rows (more than kWarpRun edges), whose sums are long
//      chains of dependent adds: each block counts the sources itself
//      and, for its share of (hub row, kHubCols columns; kWideCols for a
//      row of at most kWideRun edges, whose chain is short), counts the
//      row's dst rows from the edge list (a histogram over dst rows, so
//      they come out in order), loads and divides all the row's values
//      into shared memory at once, and adds them one thread a column.
//   2. row_sum_kernel. Some warps take windows of kWindow placed edges:
//      a warp loads the 32 edges from its window's start at once, keeps
//      the runs that begin in the window (at most kWarpRun edges each, so
//      they end among the 32), sorts their edges by (run, dst row) across
//      its lanes (a bitonic network) and sums them in that order, kBatch
//      edges' rows in flight and float4 columns a lane, storing each row
//      as it completes. The other warps write the rows no edge reads, 32
//      rows at a time, as float4 stores of zero.
//
// Larger edge lists (layer 0's 115,550) take the multi-block seg_sort
// route: the wrapper sorts (src or INT32_MAX, e) with it, runs_kernel
// lays out the same runs (in edge order) and lists the hub rows,
// hub_kernel sums those, and the same row_sum_kernel the rest. Threads
// share only integer counters (counts, slots); no float is ever added
// atomically.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kOrderThreads = 1024;
constexpr int kMaxRounds = 16;  // edges a thread takes in the order kernel
constexpr int kOrderMaxEdges = kOrderThreads * kMaxRounds;
constexpr int kOrderMaxRows = 32768;
// a placed edge is (source << kEdgeBits) | edge: 15 + 14 bits
constexpr int kEdgeBits = 14;
static_assert(kOrderMaxEdges <= (1 << kEdgeBits), "edge index bits");
constexpr int kWarpRun = 16;    // longer runs are hub rows

// hub rows: a block item is kHubCols columns of a row with more than
// kWideRun edges, or kWideCols columns of a shorter one; one column a
// thread; dst rows counted kHubChunk at a time; a row's list of edges
// taken kHubList at a time and staged in shared memory (kHubList x
// kHubCols floats)
constexpr int kHubCols = 64;
constexpr int kWideRun = 32;
constexpr int kWideCols = 256;
constexpr int kHubChunk = 4096;
constexpr int kHubList = 512;
constexpr int kHubUnroll = 8;  // loads a thread has in flight there
constexpr size_t kStageBytes = sizeof(float) * kHubList * kHubCols;
constexpr size_t kListBytes = (sizeof(int) + sizeof(float)) * kHubList;

// block 0: slot counters (m + 1), the placed edges (n_edges) and the dst
// counts (nd <= n_edges, 16 bits each), at the most
constexpr size_t kOrderBytes = sizeof(uint32_t) * (kOrderMaxRows + 1) +
                               sizeof(int32_t) * kOrderMaxEdges +
                               sizeof(uint16_t) * kOrderMaxEdges;
// the hub blocks: source counts, later the stage; dst row counts; the
// list; dst counts; the hub rows
constexpr size_t kCountBytes = sizeof(uint32_t) * (kOrderMaxRows + 1);
constexpr size_t kRegionA = kCountBytes > kStageBytes ? kCountBytes
                                                      : kStageBytes;
constexpr size_t kHubBytes = kRegionA + sizeof(uint32_t) * kHubChunk +
                             kListBytes + sizeof(uint16_t) * kOrderMaxEdges +
                             sizeof(int32_t) * (kOrderMaxEdges / 17 + 1);
constexpr size_t kOrderSmem = kOrderBytes > kHubBytes ? kOrderBytes
                                                      : kHubBytes;

constexpr int kHubThreads = 1024;   // hub_kernel, the seg_sort route's
constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kWindow = 16;    // placed edges a warp starts runs in
constexpr int kBatch = 8;      // edges' rows a lane has in flight
constexpr int kChunks = 2;     // vectors a lane owns in one column pass
constexpr int kThreads = 256;

// exclusive scan of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the sum. Two barriers.
__device__ __forceinline__ uint32_t block_scan(uint32_t v,
                                               uint32_t* __restrict__ tot,
                                               uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t t = lane < warps ? tot[lane] : 0u;
    uint32_t ti = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, ti, o);
      if (lane >= o) ti += y;
    }
    tot[lane] = ti - t;
    if (lane == 31) tot[32] = ti;
  }
  __syncthreads();
  *total = tot[32];
  return tot[warp] + inc - v;
}

// Each dst row's unmasked edges, a thread a row, its mask bytes loaded at
// once (an atomic an edge would meet fanout lanes on one address).
__device__ __forceinline__ void dst_counts(const uint8_t* __restrict__ mask,
                                           int nd, int fanout,
                                           uint16_t* __restrict__ dcnt) {
  for (int i = threadIdx.x; i < nd; i += blockDim.x) {
    const uint8_t* mk = mask + static_cast<size_t>(i) * fanout;
    uint32_t c = 0;
    if (fanout <= 32) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j < fanout) c += mk[j] ? 1u : 0u;
    } else {
      for (int j = 0; j < fanout; ++j) c += mk[j] ? 1u : 0u;
    }
    dcnt[i] = static_cast<uint16_t>(c);
  }
}

// The sources of a thread's edges tid + r * kOrderThreads, loaded at
// once: -1 for a masked, absent or out-of-range one.
__device__ __forceinline__ void load_edges(const int32_t* __restrict__ src,
                                           const uint8_t* __restrict__ mask,
                                           int n_edges, int m,
                                           int (&src_r)[kMaxRounds]) {
  uint32_t on = 0;
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    const int e = threadIdx.x + r * kOrderThreads;
    src_r[r] = e < n_edges ? __ldg(src + e) : -1;
    on |= (e < n_edges && mask[e] ? 1u : 0u) << r;
  }
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r)
    if (src_r[r] >= m || !((on >> r) & 1u)) src_r[r] = -1;
}

// acc += g[list_i[e], c0 + tid] / list_c[e] for e in [0, n), in order,
// for the first `cols` threads (n * cols <= kHubList * kHubCols): all
// the block's threads load and divide the values into stage, kHubUnroll
// loads each in flight, then one thread a column adds them.
__device__ __forceinline__ void stage_sum(const float* __restrict__ g, int d,
                                          const int* __restrict__ list_i,
                                          const float* __restrict__ list_c,
                                          int n, int c0, int cols,
                                          float* __restrict__ stage,
                                          float& acc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cells = n * cols;
  for (int f0 = tid; f0 < cells; f0 += nt * kHubUnroll) {
    float q[kHubUnroll];
#pragma unroll
    for (int u = 0; u < kHubUnroll; ++u) {
      const int f = f0 + u * nt;
      const int e = f / cols, col = c0 + f % cols;
      q[u] = f < cells && col < d
                 ? __ldg(g + static_cast<size_t>(list_i[e]) * d + col)
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kHubUnroll; ++u) {
      const int f = f0 + u * nt;
      if (f < cells) stage[f] = q[u] / list_c[f / cols];
    }
  }
  __syncthreads();
  if (tid < cols)
    for (int e = 0; e < n; ++e) acc += stage[e * cols + tid];
  __syncthreads();
}

// Block 0 of order_kernel: the counting sort.
__device__ __forceinline__ void order_block(
    const int32_t* __restrict__ edge_src,
    const uint8_t* __restrict__ edge_mask, int n_edges, int nd, int fanout,
    int m, int32_t* __restrict__ ord_i, float* __restrict__ ord_c,
    int32_t* __restrict__ ord_s, int32_t* __restrict__ begin,
    uint32_t* __restrict__ smem, uint32_t* __restrict__ tot) {
  uint32_t* hist = smem;                                       // [m + 1]
  int32_t* placed = reinterpret_cast<int32_t*>(hist + m + 1);  // [n_edges]
  uint16_t* dcnt = reinterpret_cast<uint16_t*>(placed + n_edges);  // [nd]
  const int tid = threadIdx.x;
  for (int s = tid; s <= m; s += kOrderThreads) hist[s] = 0;
  dst_counts(edge_mask, nd, fanout, dcnt);
  int src_r[kMaxRounds];
  load_edges(edge_src, edge_mask, n_edges, m, src_r);
  __syncthreads();
  // 1. each source's edges (integer atomics: a count is order-free)
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r)
    if (src_r[r] >= 0) atomicAdd(hist + src_r[r], 1u);
  __syncthreads();
  // 2. exclusive scan of hist[0..m], `per` entries a thread
  {
    const int per = (m + 1 + kOrderThreads - 1) / kOrderThreads;
    const int f0 = min(tid * per, m + 1);
    const int f1 = min(f0 + per, m + 1);
    uint32_t sum = 0;
    for (int f = f0; f < f1; ++f) sum += hist[f];
    uint32_t total;
    uint32_t run = block_scan(sum, tot, &total);
    for (int f = f0; f < f1; ++f) {
      const uint32_t c = hist[f];
      hist[f] = run;
      run += c;
    }
  }
  __syncthreads();
  // 3. each row's first slot (row m's is the total)
  for (int s = tid; s <= m; s += kOrderThreads)
    begin[s] = static_cast<int32_t>(hist[s]);
  __syncthreads();
  // 4. each edge into its source's run (slot order is free), as
  //    (source << kEdgeBits) | edge
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r)
    if (src_r[r] >= 0)
      placed[atomicAdd(hist + src_r[r], 1u)] =
          (src_r[r] << kEdgeBits) | (tid + r * kOrderThreads);
  __syncthreads();
  // 5. the runs out, coalesced: each edge's dst row, count and source
  const int n_placed = static_cast<int>(hist[m]);
  for (int k = tid; k < n_placed; k += kOrderThreads) {
    const int p = placed[k];
    const int i = (p & ((1 << kEdgeBits) - 1)) / fanout;
    ord_i[k] = i;
    ord_c[k] = fmaxf(static_cast<float>(dcnt[i]), 1.0f);
    ord_s[k] = p >> kEdgeBits;
  }
}

// Blocks 1.. of order_kernel: the hub rows, straight from the edge list.
__device__ __forceinline__ void hub_block(
    const int32_t* __restrict__ edge_src,
    const uint8_t* __restrict__ edge_mask, int n_edges, int nd, int fanout,
    int m, const float* __restrict__ g, int d, float* __restrict__ dh,
    uint32_t* __restrict__ smem, uint32_t* __restrict__ tot) {
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  uint32_t* hist = smem;                            // region A: counts,
  float* stage = reinterpret_cast<float*>(smem);    // later the stage
  uint32_t* mult = reinterpret_cast<uint32_t*>(base + kRegionA);
  int* list_i = reinterpret_cast<int*>(mult + kHubChunk);
  float* list_c = reinterpret_cast<float*>(list_i + kHubList);
  uint16_t* dcnt = reinterpret_cast<uint16_t*>(list_c + kHubList);
  int* hubs = reinterpret_cast<int*>(dcnt + kOrderMaxEdges);
  const int tid = threadIdx.x;
  for (int s = tid; s < m; s += kOrderThreads) hist[s] = 0;
  dst_counts(edge_mask, nd, fanout, dcnt);
  // the thread's edges, kept for counting each hub row's dst rows
  int src_r[kMaxRounds];
  load_edges(edge_src, edge_mask, n_edges, m, src_r);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r)
    if (src_r[r] >= 0) atomicAdd(hist + src_r[r], 1u);
  __syncthreads();
  // the hub rows, ascending: those with more than kWideRun edges first,
  // kHubCols columns an item, then the others, kWideCols columns an item
  uint32_t n_long, n_hubs;
  {
    const int per = (m + kOrderThreads - 1) / kOrderThreads;
    const int f0 = min(tid * per, m);
    const int f1 = min(f0 + per, m);
    uint32_t c_long = 0, c_mid = 0;
    for (int f = f0; f < f1; ++f) {
      c_long += hist[f] > static_cast<uint32_t>(kWideRun) ? 1u : 0u;
      c_mid += hist[f] > static_cast<uint32_t>(kWarpRun) &&
               hist[f] <= static_cast<uint32_t>(kWideRun) ? 1u : 0u;
    }
    uint32_t p = block_scan(c_long, tot, &n_long);
    __syncthreads();  // tot is read by every thread before it is reused
    uint32_t n_mid;
    uint32_t q = n_long + block_scan(c_mid, tot, &n_mid);
    n_hubs = n_long + n_mid;
    for (int f = f0; f < f1; ++f) {
      if (hist[f] > static_cast<uint32_t>(kWideRun)) hubs[p++] = f;
      else if (hist[f] > static_cast<uint32_t>(kWarpRun)) hubs[q++] = f;
    }
  }
  __syncthreads();
  const int n_cc = (d + kHubCols - 1) / kHubCols;
  const int n_wide = (d + kWideCols - 1) / kWideCols;
  const int long_items = static_cast<int>(n_long) * n_cc;
  const int items = long_items + static_cast<int>(n_hubs - n_long) * n_wide;
  for (int it = blockIdx.x - 1; it < items; it += gridDim.x - 1) {
    const bool wide = it >= long_items;
    const int cols = wide ? kWideCols : kHubCols;
    const int s = wide ? hubs[n_long + (it - long_items) / n_wide]
                       : hubs[it / n_cc];
    const int c0 = (wide ? (it - long_items) % n_wide : it % n_cc) * cols;
    float acc = 0.f;
    for (int a = 0; a < nd; a += kHubChunk) {
      const int width = min(kHubChunk, nd - a);
      __syncthreads();
      for (int j = tid; j < kHubChunk; j += kOrderThreads) mult[j] = 0;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kMaxRounds; ++r) {
        if (src_r[r] == s) {
          const int i = (tid + r * kOrderThreads) / fanout - a;
          if (i >= 0 && i < width) atomicAdd(mult + i, 1u);
        }
      }
      __syncthreads();
      constexpr int kPer = kHubChunk / kOrderThreads;
      uint32_t mine[kPer];
      uint32_t sum = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        mine[j] = mult[tid * kPer + j];
        sum += mine[j];
      }
      uint32_t total;
      const uint32_t pos = block_scan(sum, tot, &total);
      for (uint32_t lb = 0; lb < total; lb += kHubList) {
        __syncthreads();
        uint32_t p = pos;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = a + tid * kPer + j;
          for (uint32_t r = 0; r < mine[j]; ++r, ++p) {
            if (p >= lb && p < lb + kHubList) {
              list_i[p - lb] = i;
              list_c[p - lb] = fmaxf(static_cast<float>(dcnt[i]), 1.0f);
            }
          }
        }
        __syncthreads();
        stage_sum(g, d, list_i, list_c,
                  static_cast<int>(min(total - lb,
                                       static_cast<uint32_t>(kHubList))),
                  c0, cols, stage, acc);
      }
    }
    if (tid < cols && c0 + tid < d)
      dh[static_cast<size_t>(s) * d + c0 + tid] = acc;
  }
}

__global__ void __launch_bounds__(kOrderThreads)
order_kernel(const int32_t* __restrict__ edge_src,
             const uint8_t* __restrict__ edge_mask, int n_edges, int nd,
             int fanout, int m, int32_t* __restrict__ ord_i,
             float* __restrict__ ord_c, int32_t* __restrict__ ord_s,
             int32_t* __restrict__ begin, const float* __restrict__ g, int d,
             float* __restrict__ dh) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t tot[33];
  if (blockIdx.x == 0)
    order_block(edge_src, edge_mask, n_edges, nd, fanout, m, ord_i, ord_c,
                ord_s, begin, smem, tot);
  else
    hub_block(edge_src, edge_mask, n_edges, nd, fanout, m, g, d, dh, smem,
              tot);
}

// The seg_sort route's runs, from keys sorted by source (sentinels, >= m,
// last): every row's first slot by a binary search, each edge's dst row,
// count and source, and the hub rows (n_hubs cleared before).
__global__ void runs_kernel(const int32_t* __restrict__ sorted_src,
                            const int32_t* __restrict__ sorted_edge,
                            const uint8_t* __restrict__ edge_mask,
                            int n_edges, int fanout, int m,
                            int32_t* __restrict__ ord_i,
                            float* __restrict__ ord_c,
                            int32_t* __restrict__ ord_s,
                            int32_t* __restrict__ begin,
                            int32_t* __restrict__ n_hubs,
                            int32_t* __restrict__ hubs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t <= m) {
    int lo = 0, hi = n_edges;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (__ldg(sorted_src + mid) < t) lo = mid + 1; else hi = mid;
    }
    begin[t] = lo;
    if (t < m && lo + kWarpRun < n_edges &&
        __ldg(sorted_src + lo + kWarpRun) == t)
      hubs[atomicAdd(n_hubs, 1)] = t;
  }
  if (t < n_edges) {
    const int s = __ldg(sorted_src + t);
    if (s >= 0 && s < m) {
      const int i = __ldg(sorted_edge + t) / fanout;
      const uint8_t* mk = edge_mask + static_cast<size_t>(i) * fanout;
      int c = 0;
      for (int j = 0; j < fanout; ++j) c += mk[j] ? 1 : 0;
      ord_i[t] = i;
      ord_c[t] = fmaxf(static_cast<float>(c), 1.0f);
      ord_s[t] = s;
    }
  }
}

// The seg_sort route's hub rows, a block per (hub row, kHubCols columns):
// their runs are already in edge order.
__global__ void __launch_bounds__(kHubThreads)
hub_kernel(const float* __restrict__ g, int d,
           const int32_t* __restrict__ ord_i,
           const float* __restrict__ ord_c,
           const int32_t* __restrict__ begin,
           const int32_t* __restrict__ n_hubs,
           const int32_t* __restrict__ hubs, float* __restrict__ dh) {
  extern __shared__ __align__(16) uint32_t smem[];
  float* stage = reinterpret_cast<float*>(smem);
  int* list_i = reinterpret_cast<int*>(stage + kHubList * kHubCols);
  float* list_c = reinterpret_cast<float*>(list_i + kHubList);
  const int n_cc = (d + kHubCols - 1) / kHubCols;
  const int items = __ldg(n_hubs) * n_cc;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int s = __ldg(hubs + it / n_cc), c0 = (it % n_cc) * kHubCols;
    const int rb = __ldg(begin + s), re = __ldg(begin + s + 1);
    float acc = 0.f;
    for (int lb = rb; lb < re; lb += kHubList) {
      const int n = min(kHubList, re - lb);
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        list_i[j] = __ldg(ord_i + lb + j);
        list_c[j] = __ldg(ord_c + lb + j);
      }
      __syncthreads();
      stage_sum(g, d, list_i, list_c, n, c0, kHubCols, stage, acc);
    }
    if (threadIdx.x < kHubCols && c0 + threadIdx.x < d)
      dh[static_cast<size_t>(s) * d + c0 + threadIdx.x] = acc;
  }
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add_div(float* a, const T& v, float c) {
    a[0] += v.x / c; a[1] += v.y / c; a[2] += v.z / c; a[3] += v.w / c;
  }
  __device__ static T pack(const float* a) {
    return make_float4(a[0], a[1], a[2], a[3]);
  }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static void add_div(float* a, const T& v, float c) {
    a[0] += v.x / c; a[1] += v.y / c;
  }
  __device__ static T pack(const float* a) { return make_float2(a[0], a[1]); }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add_div(float* a, const T& v, float c) {
    a[0] += v / c;
  }
  __device__ static T pack(const float* a) { return a[0]; }
};

// Sort (key, cv, row) ascending by key across the warp's 32 lanes
// (bitonic).
__device__ __forceinline__ void warp_sort(int& key, float& cv, int& row,
                                          int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int ok = __shfl_xor_sync(kFull, key, j);
      const float oc = __shfl_xor_sync(kFull, cv, j);
      const int orow = __shfl_xor_sync(kFull, row, j);
      const bool up = (lane & k) == 0, low = (lane & j) == 0;
      if (low == up ? ok < key : ok > key) {
        key = ok;
        cv = oc;
        row = orow;
      }
    }
  }
}

// Sums the n <= 32 edges held by lanes 0..n-1 in order, (dst row i in the
// key's low 24 bits, count cv, output row), storing a row after its last
// edge: kBatch edges' rows in flight, float4 columns a lane.
template <int VEC>
__device__ __forceinline__ void warp_sweep(const float* __restrict__ g,
                                           int d, int key, float cv, int row,
                                           int n, int lane,
                                           float* __restrict__ dh) {
  using V = typename Vec<VEC>::T;
  const int nvec = d / VEC;
  for (int c0 = 0; c0 < nvec; c0 += 32 * kChunks) {
    float acc[kChunks][VEC];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[ch][q] = 0.f;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      V v[kBatch][kChunks];
      float cj[kBatch];
      int rj[kBatch], next[kBatch];
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int src_lane = (j0 + jj) & 31;
        const int ij = __shfl_sync(kFull, key, src_lane) & 0xffffff;
        cj[jj] = __shfl_sync(kFull, cv, src_lane);
        rj[jj] = __shfl_sync(kFull, row, src_lane);
        next[jj] = __shfl_sync(kFull, row, (j0 + jj + 1) & 31);
        const V* gr = reinterpret_cast<const V*>(g + static_cast<size_t>(ij) *
                                                 d);
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const int col = c0 + ch * 32 + lane;
          v[jj][ch] = (j0 + jj < n && col < nvec) ? __ldg(gr + col)
                                                  : Vec<VEC>::zero();
        }
      }
      // added in order, after all kBatch loads were issued; a row is
      // stored after its last edge
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int j = j0 + jj;
        if (j < n) {
#pragma unroll
          for (int ch = 0; ch < kChunks; ++ch)
            Vec<VEC>::add_div(acc[ch], v[jj][ch], cj[jj]);
          if (j + 1 == n || next[jj] != rj[jj]) {
            V* out = reinterpret_cast<V*>(dh + static_cast<size_t>(rj[jj]) *
                                          d);
#pragma unroll
            for (int ch = 0; ch < kChunks; ++ch) {
              const int col = c0 + ch * 32 + lane;
              if (col < nvec) out[col] = Vec<VEC>::pack(acc[ch]);
#pragma unroll
              for (int q = 0; q < VEC; ++q) acc[ch][q] = 0.f;
            }
          }
        }
      }
    }
  }
}

// The runs that begin in placed edges [w0, w0 + kWindow) and are not hub
// rows: the 32 edges from w0, loaded one a lane, hold them whole (a run
// of at most kWarpRun edges beginning in the window ends by lane 31);
// they are sorted by (run, dst row) and summed in that order.
template <int VEC>
__device__ __forceinline__ void warp_window(
    const float* __restrict__ g, int d, const int32_t* __restrict__ ord_i,
    const float* __restrict__ ord_c, const int32_t* __restrict__ ord_s,
    int n_placed, int w0, int lane, float* __restrict__ dh) {
  static_assert(kWindow + kWarpRun <= 32, "a window's runs fit the warp");
  const int k = w0 + lane;
  const bool valid = k < n_placed;
  const int s = valid ? __ldg(ord_s + k) : -1;
  const int prev = valid && k > 0 ? __ldg(ord_s + k - 1) : -2;
  const int i = valid ? __ldg(ord_i + k) : 0;
  const float c = valid ? __ldg(ord_c + k) : 1.f;
  // a run begins where the source changes, and ends where the next begins
  const unsigned starts = __ballot_sync(kFull, !valid || s != prev);
  const unsigned upto = starts & (0xffffffffu >> (31 - lane));
  const int st = upto ? 31 - __clz(upto) : -1;          // my run's start
  const unsigned after = st >= 0 ? starts & ~(0xffffffffu >> (31 - st)) : 0;
  const int en = after ? __ffs(after) - 1 : 32;         // the next start
  const bool mine = valid && st >= 0 && st < kWindow && en - st <= kWarpRun;
  int key = mine ? (st << 24) | i : INT_MAX;
  float cv = c;
  int row = s;
  warp_sort(key, cv, row, lane);
  warp_sweep<VEC>(g, d, key, cv, row, __popc(__ballot_sync(kFull, mine)),
                  lane, dh);
}

// Rows t0 .. t0 + 31 that no edge reads: zeros.
template <int VEC>
__device__ __forceinline__ void warp_zeros(const int32_t* __restrict__ begin,
                                           int m, int d, int t0, int lane,
                                           float* __restrict__ dh) {
  using V = typename Vec<VEC>::T;
  const int s = t0 + lane;
  const bool empty = s < m && __ldg(begin + s) == __ldg(begin + s + 1);
  unsigned rows = __ballot_sync(kFull, empty);
  const int nvec = d / VEC;
  while (rows) {
    const int j = __ffs(rows) - 1;
    rows &= rows - 1;
    V* out = reinterpret_cast<V*>(dh + static_cast<size_t>(t0 + j) * d);
    for (int col = lane; col < nvec; col += 32) out[col] = Vec<VEC>::zero();
  }
}

// Warps [0, window_warps) take the windows of placed edges; the others
// the empty rows, 32 at a time.
template <int VEC>
__global__ void __launch_bounds__(kSumThreads)
row_sum_kernel(const float* __restrict__ g, int d,
               const int32_t* __restrict__ ord_i,
               const float* __restrict__ ord_c,
               const int32_t* __restrict__ ord_s,
               const int32_t* __restrict__ begin, int m, int window_warps,
               float* __restrict__ dh) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  const int n_placed = __ldg(begin + m);
  if (warp < window_warps) {
    for (int w0 = warp * kWindow; w0 < n_placed; w0 += window_warps * kWindow)
      warp_window<VEC>(g, d, ord_i, ord_c, ord_s, n_placed, w0, lane, dh);
  } else {
    const int zw = warp - window_warps;
    const int n_zero = gridDim.x * kSumWarps - window_warps;
    for (int t0 = zw * 32; t0 < m; t0 += n_zero * 32)
      warp_zeros<VEC>(begin, m, d, t0, lane, dh);
  }
}

cudaError_t run_row_sum(const float* g, int d, const int32_t* ord_i,
                        const float* ord_c, const int32_t* ord_s,
                        const int32_t* begin, int m, int n_edges, float* dh,
                        int vec, int sms, cudaStream_t st) {
  const int window_warps = max(1, min((n_edges + kWindow - 1) / kWindow,
                                      sms * kSumWarps * 2));
  const int zero_warps = max(1, min((m + 31) / 32, sms * kSumWarps));
  const int grid = (window_warps + zero_warps + kSumWarps - 1) / kSumWarps;
  if (vec == 4)
    row_sum_kernel<4><<<grid, kSumThreads, 0, st>>>(
        g, d, ord_i, ord_c, ord_s, begin, m, window_warps, dh);
  else if (vec == 2)
    row_sum_kernel<2><<<grid, kSumThreads, 0, st>>>(
        g, d, ord_i, ord_c, ord_s, begin, m, window_warps, dh);
  else
    row_sum_kernel<1><<<grid, kSumThreads, 0, st>>>(
        g, d, ord_i, ord_c, ord_s, begin, m, window_warps, dh);
  return cudaGetLastError();
}

// the dynamic shared-memory limits, raised once so that a CUDA-graph
// capture never calls cudaFuncSetAttribute
cudaError_t set_limits() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kOrderSmem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(hub_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kStageBytes + kListBytes));
  if (err != cudaSuccess) return err;
  done = true;
  return cudaSuccess;
}

}  // namespace

// The one-block route (n_edges <= 16,384, m <= 32,768, fanout < 65,536;
// checked by the wrapper). g (nd, d) float32; edge_src (n_edges,) int32;
// edge_mask (n_edges,) bool; scratch ord_i, ord_s (n_edges,) int32, ord_c
// (n_edges,) float32, begin (m + 1,) int32; dh (m, d) float32, every row
// written; vec (4, 2 or 1) the float vector width d and the pointers
// allow; sms the card's multiprocessor count.
extern "C" int repro_gather_agg_bwd(const void* g, int d, const void* edge_src,
                                    const void* edge_mask, int nd, int fanout,
                                    int m, void* ord_i, void* ord_c,
                                    void* ord_s, void* begin, void* dh,
                                    int vec, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_edges = nd * fanout;
  if (n_edges > kOrderMaxEdges || m > kOrderMaxRows || fanout > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // one block a multiprocessor: block 0 orders, the others sum hub rows
  order_kernel<<<sms > 1 ? sms : 2, kOrderThreads, kOrderSmem, st>>>(
      static_cast<const int32_t*>(edge_src),
      static_cast<const uint8_t*>(edge_mask), n_edges, nd, fanout, m,
      static_cast<int32_t*>(ord_i), static_cast<float*>(ord_c),
      static_cast<int32_t*>(ord_s), static_cast<int32_t*>(begin),
      static_cast<const float*>(g), d, static_cast<float*>(dh));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_row_sum(
      static_cast<const float*>(g), d, static_cast<const int32_t*>(ord_i),
      static_cast<const float*>(ord_c), static_cast<const int32_t*>(ord_s),
      static_cast<const int32_t*>(begin), m, n_edges,
      static_cast<float*>(dh), vec, sms, st));
}

// The seg_sort route: sorted_src/sorted_edge (n_edges,) int32 from the
// by-source sort (key src, INT32_MAX for masked edges; payload the edge
// index); n_hubs (1,) and hubs (n_edges / 17 + 1,) int32 scratch; the
// rest as above.
extern "C" int repro_gather_agg_bwd_sorted(
    const void* g, int d, const void* sorted_src, const void* sorted_edge,
    const void* edge_mask, int nd, int fanout, int m, void* ord_i,
    void* ord_c, void* ord_s, void* begin, void* n_hubs, void* hubs,
    void* dh, int vec, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_edges = nd * fanout;
  err = cudaMemsetAsync(n_hubs, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = (n_edges > m + 1 ? n_edges : m + 1);
  runs_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const int32_t*>(sorted_src),
      static_cast<const int32_t*>(sorted_edge),
      static_cast<const uint8_t*>(edge_mask), n_edges, fanout, m,
      static_cast<int32_t*>(ord_i), static_cast<float*>(ord_c),
      static_cast<int32_t*>(ord_s), static_cast<int32_t*>(begin),
      static_cast<int32_t*>(n_hubs), static_cast<int32_t*>(hubs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hub_kernel<<<2 * sms, kHubThreads, kStageBytes + kListBytes, st>>>(
      static_cast<const float*>(g), d, static_cast<const int32_t*>(ord_i),
      static_cast<const float*>(ord_c), static_cast<const int32_t*>(begin),
      static_cast<const int32_t*>(n_hubs),
      static_cast<const int32_t*>(hubs), static_cast<float*>(dh));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_row_sum(
      static_cast<const float*>(g), d, static_cast<const int32_t*>(ord_i),
      static_cast<const float*>(ord_c), static_cast<const int32_t*>(ord_s),
      static_cast<const int32_t*>(begin), m, n_edges,
      static_cast<float*>(dh), vec, sms, st));
}
