// Backward of the fan-out-regular masked neighbour mean for Hopper
// (sm_90a): dh[s] = sum over unmasked edges e with src_e = s of
// g[e / fanout] / max(cnt[e / fanout], 1), dh of shape (m, d), each row
// summed in ascending edge order from +0, rows no edge reads written 0.
//
// Replaces the custom VJP of repro/kernels/gather_agg/ops.py
// (`_kernel_bwd`, one segment_sum of the scaled messages over edge_src).
// A scatter-add with float atomics would sum each row in whatever order
// the atomics land, so two runs could differ in the last bit. Here the
// sum is a gather: each row's edges are listed in edge order and added in
// that order, so the result is the sequential scatter-add in edge order,
// bit for bit. No float is ever added atomically; threads share only
// integer counts and slots.
//
// Bound: bytes. The (m, d) float32 output written once is nearly all of
// them at the training path's layer 1 (21.6 MB, 6.5 us at 3.35 TB/s), and
// most of it is the zeros of rows no edge reads. At layer 0 (115,550 edges
// of 602 floats) the quotient rows the sums gather are 278 MB, read
// through L2, and one row is read by 3,847 edges: its sum is a chain of
// 3,847 dependent adds a column, which no order but edge order may
// shorten. Two launches, one route at every size:
//
//   1. order_kernel: the by-source order, a counting sort spread over a
//      thread block cluster (launched with cudaLaunchKernelEx, `cluster`
//      blocks). Each cluster owns a tile of `tile_rows` sources (as many
//      tiles as fill the card in one wave, each at most kMaxTileRows
//      sources, one block's histogram); block b of the cluster reads the
//      b-th slice of the dst rows (whole rows, in edge order) and counts
//      its edges whose source lies in the tile into its own shared
//      histogram, besides the valid edges below the tile and in all, and
//      the unmasked edges of its own share of the dst rows. While the
//      cluster meets (a split barrier), each block writes the quotients
//      q = g / max(cnt, 1) of that share, once a (dst row, column), the
//      plain version's g / cnt, in rows padded to 16 bytes for the TMA.
//      Each block then owns a 1/cluster share of the tile's sources: it
//      reads their counts from every block's histogram through distributed
//      shared memory, scans them, and writes back into each block's
//      histogram the first slot of each (source, block) pair; the blocks'
//      per-owner counts, exchanged the same way, place the share, and the
//      blocks' counts below the tile place the tile. The owners write each
//      row's first slot (`begin`), for each sum block the row (and its
//      first slot) where its share of the work starts, and, by TMA bulk
//      stores from a zeroed shared tile, the zeros of the rows no edge
//      reads, which stream out while the block places its edges: a round
//      of 4,096 edges is compacted into shared memory by owner warp
//      (source % 16) and, within an owner, in edge order (four ballots of
//      the owner's bits), and warp w places its sources' edges 32 at a
//      time, ranked by __match_any_sync from each source's cursor. One warp
//      places all of a source's edges of a slice, in edge order, and the
//      slices are in edge order, so each source's run comes out in edge
//      order: no re-sort, no second count. A placed edge is its dst row.
//   2. sum_kernel: the placed edges are cut into equal shares, one a block
//      over the whole card, so that a tile of many edges costs no more
//      than one of few; a row that straddles two shares is cut by columns
//      in proportion. A block lays out a window of its rows (their first
//      slots and placed edges in shared memory, one round trip) and sums
//      them in chunks of (placed edges x columns) quotients: warp 0 loads
//      each slot's q row by a TMA bulk copy into a ring of three 64 KB
//      buffers (full and empty mbarriers), the other 15 warps add, a row
//      to a group of threads (a thread a column, or two), in edge order,
//      and store it after its last edge. A run longer than a chunk is cut
//      into pieces whose sums carry from piece to piece, so that each
//      column's chain of adds runs as fast as the loads feed it. A long row
//      cut to a narrow column range (a hub row's share of a few columns),
//      where a TMA request a slot would fetch a few columns, is taken by
//      the whole block after the ring, every thread copying 16-byte cells
//      with cp.async into two buffers while all add.
//
// Every row and every scratch entry is written before it is read: no
// memset. A refused launch (too much shared memory, a cluster size the
// card refuses) is returned to the wrapper, which raises.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// --- order_kernel -----------------------------------------------------------
constexpr int kMaxTileRows = 16384;  // a tile's sources: one histogram
constexpr int kMinCluster = 8;
constexpr int kMaxCluster = 16;
constexpr int kMaxOwn = kMaxTileRows / kMinCluster + 1;  // a block's share
constexpr int kPer = 8;                  // edges a thread places at once
constexpr int kRound = kThreads * kPer;  // edges a placement round takes
constexpr int kOwners = 16;  // a tile source's placing warp: source % 16
static_assert(kOwners == kWarps, "one placing warp a bucket");
constexpr int kBuckets = kOwners * kPer * kWarps;  // (owner, u, warp) counts
constexpr int kQBatch = 16;  // quotients a thread has in flight
constexpr int kQRows = 1024;  // quotient rows whose counts 1. takes
constexpr int kZeroBytes = 16 * 1024;  // a zeroed tile TMA stores from
constexpr size_t kOrderSmem =
    kZeroBytes +
    sizeof(uint32_t) * (kMaxTileRows + kMaxOwn + 1 + 2 * kRound + kBuckets);

// --- sum_kernel -------------------------------------------------------------
constexpr int kWin = 1024;   // rows a sum block lays out at once
constexpr int kSeg = 4096;   // placed edges whose dst rows it holds
constexpr int kConsumers = kThreads - 32;  // all warps but the loader
constexpr int kMaxCols = 2 * kConsumers;   // vector columns a pass takes
constexpr int kStages = 3;                 // chunks the loader keeps ahead
constexpr int kStageBytes = 64 * 1024;     // each stage buffer
constexpr int kBarBytes = 128;  // the ring's barriers, then the buffers
constexpr int kBulkMin = 1024;  // a slot's stage row bytes worth a TMA copy
constexpr int kBlockRun = 64;   // a narrow cut row's edges for the block
constexpr size_t kSumSmem = kBarBytes +
                            kStages * static_cast<size_t>(kStageBytes) +
                            sizeof(int32_t) * ((kWin + 1) + kSeg);

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// n / d for 32-bit n and 1 <= d < 2^31 by a multiply and shifts
// (Granlund and Montgomery), set up once a kernel: a hardware division
// costs tens of instructions.
struct FastDiv {
  uint32_t mul;
  int s1, s2;
  __device__ explicit FastDiv(uint32_t d) {
    const int l = d > 1 ? 32 - __clz(d - 1) : 0;
    mul = static_cast<uint32_t>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
    s1 = min(l, 1);
    s2 = max(l - 1, 0);
  }
  __device__ uint32_t operator()(uint32_t n) const {
    const uint32_t t = __umulhi(mul, n);
    return (t + ((n - t) >> s1)) >> s2;
  }
};

// Exclusive scan of v over the block; *total gets the sum. Two barriers.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* tot,
                                               uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t t = lane < kWarps ? tot[lane] : 0u;
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

// The two halves of a cluster barrier, for work between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The sources and mask bits of edges e0 + u * kThreads + tid, u < N.
template <int N>
__device__ __forceinline__ void load_round(
    const int32_t* __restrict__ edge_src,
    const uint8_t* __restrict__ edge_mask, long long e0, long long e1,
    int (&src)[N], bool (&on)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long e = e0 + static_cast<long long>(u) * kThreads +
                        threadIdx.x;
    const bool in = e < e1;
    src[u] = in ? __ldg(edge_src + e) : -1;
    on[u] = in && __ldg(edge_mask + e) != 0;
  }
}

// Rows [ra, rb) of dh (m, d) set to zeros: the 16-byte aligned bytes by
// TMA bulk stores from the zeroed shared tile, the ends by plain stores.
__device__ __forceinline__ void zero_rows(float* __restrict__ dh, int d,
                                          int ra, int rb,
                                          const uint8_t* zeros) {
  uint8_t* out = reinterpret_cast<uint8_t*>(dh);
  const long long a = static_cast<long long>(ra) * d * 4;
  const long long e = static_cast<long long>(rb) * d * 4;
  const long long a16 = min((a + 15) & ~15ll, e), e16 = max(e & ~15ll, a16);
  for (long long x = a; x < a16; x += 4)
    *reinterpret_cast<float*>(out + x) = 0.f;
  for (long long x = a16; x < e16; x += kZeroBytes) {
    const uint32_t n = static_cast<uint32_t>(
        min(static_cast<long long>(kZeroBytes), e16 - x));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            out + x),
        "r"(smem_addr(zeros)), "r"(n)
        : "memory");
  }
  for (long long x = e16; x < e; x += 4)
    *reinterpret_cast<float*>(out + x) = 0.f;
}

__global__ void __launch_bounds__(kThreads, 1)
order_kernel(const int32_t* __restrict__ edge_src,
             const uint8_t* __restrict__ edge_mask, int nd, int fanout,
             int m, int tile_rows, int sum_blocks,
             const float* __restrict__ g, int d, float* __restrict__ q,
             int32_t* __restrict__ ord, int32_t* __restrict__ begin,
             int32_t* __restrict__ bounds, float* __restrict__ dh) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint8_t* zeros = reinterpret_cast<uint8_t*>(smem);  // kZeroBytes
  uint32_t* hist = smem + kZeroBytes / 4;  // [tile_rows]: counts, then
                                           // each source's cursor
  uint32_t* own = hist + kMaxTileRows;  // [kMaxOwn + 1]
  uint32_t* bufs = own + kMaxOwn + 1;   // [kRound]: compacted sources
  int32_t* bufi = reinterpret_cast<int32_t*>(bufs + kRound);  // dst rows
  uint32_t* bcnt = reinterpret_cast<uint32_t*>(bufi + kRound);  // [kBuckets]
  __shared__ uint32_t tot[33];
  __shared__ uint32_t ocnt[kMaxCluster];  // the slice's edges by owner
  __shared__ uint32_t s_below, s_valid;
  __shared__ uint32_t s_off, s_base, s_nvalid;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int b = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = static_cast<int>(blockIdx.x / C) * tile_rows;
  const int s1 = min(m, s0 + tile_rows);
  const int rt = s1 - s0;
  // this block's slice: dst rows [i_lo, i_hi), whole rows in edge order
  const long long i_lo = static_cast<long long>(nd) * b / C;
  const long long i_hi = static_cast<long long>(nd) * (b + 1) / C;
  const long long e_lo = i_lo * fanout, e_hi = i_hi * fanout;
  // block r of the cluster owns the tile's sources [oa(r), oa(r + 1))
  auto oa = [&](int r) { return rt * r / C; };
  // this block's quotients: dst rows [qa, qb), its tile's share of the
  // slice; their first cells' values of g loaded now, in flight through 1.
  const int T = static_cast<int>(gridDim.x) / C;
  const int tile = static_cast<int>(blockIdx.x) / C;
  const long long qa = i_lo + (i_hi - i_lo) * tile / T;
  const long long qb = i_lo + (i_hi - i_lo) * (tile + 1) / T;
  const bool q_fast = qb - qa <= kQRows;  // counts taken in 1.
  const long long q_cells = (qb - qa) * d;
  float qv[kQBatch];
#pragma unroll
  for (int u = 0; u < kQBatch; ++u) {
    const long long f = tid + static_cast<long long>(u) * kThreads;
    qv[u] = q_fast && f < q_cells ? __ldg(g + qa * d + f) : 0.f;
  }
  uint32_t* cntq = bufs;  // [kQRows], free till 3.
  const FastDiv by_fanout(static_cast<uint32_t>(fanout));

  // 1. count the slice: per tile source, below the tile, valid in all
  for (int t = tid; t < rt; t += kThreads) hist[t] = 0;
  if (tid < kMaxCluster) ocnt[tid] = 0;
  if (tid == 0) {
    s_below = 0;
    s_valid = 0;
  }
  for (int k = tid; k < kQRows; k += kThreads) cntq[k] = 0;
  for (int k = tid; k < kZeroBytes / 16; k += kThreads)
    reinterpret_cast<float4*>(zeros)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the zeros are read by the TMA's proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t below = 0, valid = 0;
  int src[kPer];
  bool on[kPer];
  load_round(edge_src, edge_mask, e_lo, e_hi, src, on);
  for (long long e0 = e_lo; e0 < e_hi; e0 += kRound) {
    int nsrc[kPer];  // the next round's edges, in flight meanwhile
    bool non[kPer];
    load_round(edge_src, edge_mask, e0 + kRound, e_hi, nsrc, non);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (on[u] && static_cast<unsigned>(src[u]) < static_cast<unsigned>(m)) {
        ++valid;
        if (src[u] < s0) ++below;
        else if (src[u] < s1) atomicAdd(hist + (src[u] - s0), 1u);
      }
      if (on[u] && q_fast) {  // the unmasked edges of a quotient row
        const long long i = by_fanout(static_cast<uint32_t>(
            e0 + static_cast<long long>(u) * kThreads + tid));
        if (i >= qa && i < qb) atomicAdd(cntq + (i - qa), 1u);
      }
      src[u] = nsrc[u];
      on[u] = non[u];
    }
  }
  below = warp_sum(below);
  valid = warp_sum(valid);
  if (lane == 0) {
    atomicAdd(&s_below, below);
    atomicAdd(&s_valid, valid);
  }
  __syncthreads();
  // the slice's edges of each owner's sources (a thread's contiguous
  // stretch of the histogram meets few owners)
  {
    const int per = (rt + kThreads - 1) / kThreads;
    const int t0 = min(tid * per, rt), t1 = min(t0 + per, rt);
    int r = 0;
    while (r + 1 < C && oa(r + 1) <= t0) ++r;
    uint32_t acc = 0;
    for (int t = t0; t < t1; ++t) {
      while (r + 1 < C && oa(r + 1) <= t) {
        if (acc) atomicAdd(ocnt + r, acc);
        acc = 0;
        ++r;
      }
      acc += hist[t];
    }
    if (acc) atomicAdd(ocnt + r, acc);
  }
  cluster_arrive();
  // while the cluster meets: the quotients q = g / max(count, 1) of rows
  // [qa, qb), stored in rows of dq floats (16-byte aligned for the sums'
  // TMA copies): the loaded cells, then any more, kQBatch loads a thread
  // in flight; rows beyond kQRows count their edges a warp a row
  const FastDiv by_d(static_cast<uint32_t>(d));
  const int dq = (d + 3) & ~3;
  if (q_fast) {
    for (long long f0 = tid; f0 < q_cells; f0 += kThreads * kQBatch) {
      if (f0 != tid) {
#pragma unroll
        for (int u = 0; u < kQBatch; ++u) {
          const long long f = f0 + static_cast<long long>(u) * kThreads;
          qv[u] = f < q_cells ? __ldg(g + qa * d + f) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kQBatch; ++u) {
        const long long f = f0 + static_cast<long long>(u) * kThreads;
        if (f < q_cells) {
          const uint32_t r = by_d(static_cast<uint32_t>(f));
          q[(qa + r) * dq + (f - static_cast<long long>(r) * d)] =
              qv[u] / fmaxf(static_cast<float>(cntq[r]), 1.0f);
        }
      }
    }
  } else {
    float* cnts = reinterpret_cast<float*>(bufs);  // [kRound], free till 3.
    const long long rows = max(1, min(kRound, (1 << 30) / d));
    for (long long r0 = qa; r0 < qb; r0 += rows) {
      const int nr = static_cast<int>(min(rows, qb - r0));
      __syncthreads();
      for (int r = warp; r < nr; r += kWarps) {
        const uint8_t* mk = edge_mask + (r0 + r) * fanout;
        uint32_t c = 0;
        for (int j = lane; j < fanout; j += 32) c += mk[j] ? 1u : 0u;
        c = warp_sum(c);
        if (lane == 0) cnts[r] = fmaxf(static_cast<float>(c), 1.0f);
      }
      __syncthreads();
      const long long cells = static_cast<long long>(nr) * d;
      for (long long f = tid; f < cells; f += kThreads) {
        const uint32_t r = by_d(static_cast<uint32_t>(f));
        q[(r0 + r) * dq + (f - static_cast<long long>(r) * d)] =
            __ldg(g + r0 * d + f) / cnts[r];
      }
    }
  }
  cluster_wait();

  // 2. the block's share of the tile's sources, [oa(b), oa(b + 1)): their
  //    counts over the cluster, scanned; where the share starts in the
  //    tile, where the tile starts, the valid edges in all
  if (warp == 0) {
    uint32_t off = 0, base = 0, nv = 0;
    if (lane < C) {
      const uint32_t* oc = cluster.map_shared_rank(ocnt, lane);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < b) off += oc[r];
      base = *cluster.map_shared_rank(&s_below, lane);
      nv = *cluster.map_shared_rank(&s_valid, lane);
    }
    off = warp_sum(off);
    base = warp_sum(base);
    nv = warp_sum(nv);
    if (lane == 0) {
      s_off = off;
      s_base = base;
      s_nvalid = nv;
    }
  }
  const int ob = oa(b), n_own = oa(b + 1) - ob;
  const int per = (n_own + kThreads - 1) / kThreads;
  const int f0 = min(tid * per, n_own), f1 = min(f0 + per, n_own);
  uint32_t sum = 0;
  for (int f = f0; f < f1; ++f) {
    uint32_t L = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) L += cluster.map_shared_rank(hist, r)[ob + f];
    own[f] = L;
    sum += L;
  }
  uint32_t total;
  uint32_t run = block_scan(sum, tot, &total);  // its barriers publish s_*
  const uint32_t tile_base = s_base;
  {
    const uint32_t n_valid = s_nvalid;
    const long long units = n_valid;  // the sums' work: a placed edge each
    const long long G = sum_blocks;
    run += s_off;
    for (int f = f0; f < f1; ++f) {
      const uint32_t L = own[f];
      const uint32_t st = run;  // the row's first slot in the tile
      run += L;
      uint32_t c[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < C) c[r] = cluster.map_shared_rank(hist, r)[ob + f];
      uint32_t cur = st;  // each (source, block)'s first slot in the tile
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < C) {
          cluster.map_shared_rank(hist, r)[ob + f] = cur;
          cur += c[r];
        }
      }
      const int s = s0 + ob + f;
      const uint32_t bg = tile_base + st;
      begin[s] = static_cast<int32_t>(bg);
      if (s == m - 1) begin[m] = static_cast<int32_t>(n_valid);
      // the sum blocks whose share starts in this row's edges
      if (L > 0) {
        const long long u0 = bg, u1 = u0 + L;
        for (long long j = (u0 * G + units - 1) / units;
             j < G && j * units / G < u1; ++j) {
          bounds[2 * j] = s;
          bounds[2 * j + 1] = static_cast<int32_t>(bg);
        }
      }
    }
  }
  cluster_arrive();  // every cursor written; no remote access after this
  cluster_wait();
  // the zeros of the share's rows no edge reads: the last warp finds their
  // runs (32 rows at a time) and stores them by TMA bulk stores from the
  // zeroed tile, streaming out while the block places its edges
  if (warp == kWarps - 1) {
    for (int f0 = 0; f0 < n_own; f0 += 32) {
      const int f = f0 + lane;
      const unsigned zs = __ballot_sync(kFull, f < n_own && own[f] == 0);
      const bool head =
          ((zs >> lane) & 1u) && (lane == 0 || !((zs >> (lane - 1)) & 1u));
      if (head) {
        const unsigned after = ~zs & ~(0xffffffffu >> (31 - lane));
        const int len =
            (after ? __ffs(after) - 1 : min(32, n_own - f0)) - lane;
        zero_rows(dh, d, s0 + ob + f, s0 + ob + f + len, zeros);
      }
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }

  // 3. place the slice's edges of the tile, in edge order: a round's
  //    edges are compacted by owner (source % 16) and, within an owner, in
  //    edge order; owner warp w then places its edges, a source at a time
  load_round(edge_src, edge_mask, e_lo, e_hi, src, on);
  for (long long e0 = e_lo; e0 < e_hi; e0 += kRound) {
    for (int k = tid; k < kBuckets; k += kThreads) bcnt[k] = 0;
    __syncthreads();
    unsigned same[kPer];
    uint32_t tl[kPer];
    uint32_t placed;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const bool ok = on[u] && src[u] >= s0 && src[u] < s1;
      const uint32_t t = ok ? static_cast<uint32_t>(src[u] - s0) : 0u;
      unsigned sm = __ballot_sync(kFull, ok);
#pragma unroll
      for (int bit = 0; bit < 4; ++bit) {  // the lanes of the same owner
        const unsigned bb = __ballot_sync(kFull, (t >> bit) & 1u);
        sm &= ((t >> bit) & 1u) ? bb : ~bb;
      }
      same[u] = ok ? sm : 0u;
      tl[u] = t;
      if (ok && (sm & lanes_below(lane)) == 0)
        bcnt[(t % kOwners) * kPer * kWarps + u * kWarps + warp] = __popc(sm);
    }
    // the next round's edges, in flight while this one is placed
    load_round(edge_src, edge_mask, e0 + kRound, e_hi, src, on);
    __syncthreads();
    {  // exclusive scan of the counts: owner, then round order, then warp
      constexpr int kEach = kBuckets / kThreads;
      uint32_t v[kEach], t = 0;
#pragma unroll
      for (int r = 0; r < kEach; ++r) {
        v[r] = bcnt[tid * kEach + r];
        t += v[r];
      }
      uint32_t p = block_scan(t, tot, &placed);
#pragma unroll
      for (int r = 0; r < kEach; ++r) {
        bcnt[tid * kEach + r] = p;
        p += v[r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if ((same[u] >> lane) & 1u) {
        const int k =
            static_cast<int>(bcnt[(tl[u] % kOwners) * kPer * kWarps +
                                  u * kWarps + warp]) +
            __popc(same[u] & lanes_below(lane));
        bufs[k] = tl[u];
        bufi[k] = static_cast<int32_t>(by_fanout(static_cast<uint32_t>(
            e0 + static_cast<long long>(u) * kThreads + tid)));
      }
    }
    const int kb = warp + 1 < kOwners
                       ? static_cast<int>(bcnt[(warp + 1) * kPer * kWarps])
                       : static_cast<int>(placed);
    const int ka = static_cast<int>(bcnt[warp * kPer * kWarps]);
    __syncthreads();
    // owner warp w places its edges 32 at a time: the lanes of a source
    // ranked in edge order from the source's cursor
    for (int k0 = ka; k0 < kb; k0 += 32) {
      const int k = k0 + lane;
      const bool in = k < kb;
      const uint32_t sl = in ? bufs[k] : 0xffffffffu;
      const unsigned peers = __match_any_sync(kFull, sl);
      const int head = __ffs(peers) - 1;
      uint32_t base = 0;
      if (in && lane == head) {
        base = hist[sl];
        hist[sl] = base + __popc(peers);
      }
      base = __shfl_sync(kFull, base, head);
      if (in)
        ord[tile_base + base + __popc(peers & lanes_below(lane))] = bufi[k];
    }
    __syncthreads();
  }

}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T add(const T& a, const T& v) {
    return make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
  }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static T add(const T& a, const T& v) {
    return make_float2(a.x + v.x, a.y + v.y);
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T add(const T& a, const T& v) { return a + v; }
};

// A row's share of this block's units: the vector columns [c0, c1) of
// its nv, in proportion to where [u_lo, u_hi) cuts its L units (none for
// a row no edge reads).
struct RowPart {
  int c0, c1, L;
};

__device__ __forceinline__ RowPart row_part(const int32_t* __restrict__ wb,
                                            int w, int s, long long u_lo,
                                            long long u_hi, int nv) {
  RowPart p;
  p.L = wb[w + 1] - wb[w];
  const long long u0 = wb[w];
  const long long n = p.L;
  const long long lo = max(u0, u_lo), hi = min(u0 + n, u_hi);
  if (lo < hi) {
    p.c0 = static_cast<int>((lo - u0) * nv / n);
    p.c1 = static_cast<int>((hi - u0) * nv / n);
  } else {
    p.c0 = p.c1 = 0;
  }
  return p;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from global `src` (16-byte aligned) into
// shared `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The sums of a window are passes over up to three groups of rows: the
// first row's columns, the whole rows between, the last row's columns.
struct Groups {
  int r0[3], r1[3], c0[3], c1[3];
  // group g's field, by selects (no indexed local memory)
  __device__ static int pick(const int (&f)[3], int g) {
    return g == 0 ? f[0] : g == 1 ? f[1] : f[2];
  }
};

// Where the chunks of a window have got to: group g's pass from vector
// column cs, at row r, slot k.
struct Pos {
  int g, cs, r, k;
};

// A chunk: rows [r0, r1) whole (their slots [k0, k0 + ne)), or `piece`:
// slots [k0, k0 + ne) of row r0 alone, a run longer than a chunk holds.
// A slot's stage row is `row_bytes` of the q row from byte `a0`, the pass's
// columns from vector `off` of it.
struct Chunk {
  int g, cs, nc, r0, r1, k0, ne, a0, off, row_bytes;
  bool piece;
};

// The pass of group g from column cs, within the held slots [lo, hi):
// its first position and the layout of its stage rows.
template <int VEC>
__device__ __forceinline__ void pass_layout(const Groups& G, int g, int cs,
                                            Chunk& c) {
  constexpr int kV = VEC * 4;  // bytes a vector
  c.g = g;
  c.cs = cs;
  c.nc = min(kMaxCols, Groups::pick(G.c1, g) - cs);
  c.a0 = (cs * kV) & ~15;
  c.off = (cs * kV - c.a0) / kV;
  c.row_bytes = (((cs + c.nc) * kV + 15) & ~15) - c.a0;
}

// The chunk at `p` (false past the last): a run longer than a chunk holds
// is cut into pieces; shorter ones are taken whole, as many as fit. Then
// `p` moves past it: the next row, the next pass of the group (or only
// the pass cs_only >= 0), the next group.
template <int VEC>
__device__ __forceinline__ bool next_chunk(const Groups& G,
                                           const int32_t* __restrict__ wb,
                                           int lo, int hi, int cs_only,
                                           Pos& p, Chunk& c) {
  while (true) {
    if (p.g > 2) return false;
    const int r1 = Groups::pick(G.r1, p.g);
    const int c0 = Groups::pick(G.c0, p.g), c1 = Groups::pick(G.c1, p.g);
    if (c1 <= c0 || p.cs >= c1 || p.r >= r1 || p.k >= hi) {
      // the group's pass is done: the next pass, else the next group
      if (cs_only < 0 && c1 > c0 && p.cs + kMaxCols < c1) {
        p.cs += kMaxCols;
      } else {
        ++p.g;
        if (p.g > 2) return false;
        p.cs = cs_only >= 0 ? cs_only : Groups::pick(G.c0, p.g);
      }
      p.r = Groups::pick(G.r0, p.g);
      p.k = max(lo, wb[p.r]);
      continue;
    }
    pass_layout<VEC>(G, p.g, p.cs, c);
    const int per = kStageBytes / c.row_bytes;  // slots a chunk holds
    const int end = min(hi, wb[p.r + 1]);
    if (wb[p.r + 1] - wb[p.r] > per) {  // a piece of a long run
      c.piece = true;
      c.r0 = p.r;
      c.r1 = p.r + 1;
      c.k0 = p.k;
      c.ne = min(per, end - p.k);
      p.k += c.ne;
      if (p.k >= wb[p.r + 1]) ++p.r;
      return true;
    }
    // whole rows from p.r: the most whose slots fit
    int lo2 = p.r + 1, hi2 = r1;
    while (lo2 < hi2) {
      const int mid = (lo2 + hi2 + 1) >> 1;
      if (wb[mid] - wb[p.r] <= per && wb[mid] <= hi) lo2 = mid;
      else hi2 = mid - 1;
    }
    c.piece = false;
    c.r0 = p.r;
    c.r1 = lo2;
    c.k0 = wb[p.r];
    c.ne = wb[lo2] - wb[p.r];
    p.r = lo2;
    p.k = wb[lo2];
    if (c.ne == 0) continue;  // rows no edge reads: stored as zeros
    return true;
  }
}

// The consumers' running sums of a long run cut into pieces (two columns
// a thread, kConsumers apart).
template <int VEC>
struct Carry {
  typename Vec<VEC>::T a0, a1;
};

// a0 (and a1, gsize columns on) += the stage rows [ka, kb)'s vectors,
// in order, four rows' loads issued ahead of their adds.
template <int VEC>
__device__ __forceinline__ void add_run(const uint8_t* base, int row_bytes,
                                        int ka, int kb, int gsize, bool two,
                                        typename Vec<VEC>::T& a0,
                                        typename Vec<VEC>::T& a1) {
  using V = typename Vec<VEC>::T;
  int k = ka;
  for (; k + 4 <= kb; k += 4) {
    V v[4], w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const V* row = reinterpret_cast<const V*>(base + (k + h) * row_bytes);
      v[h] = row[0];
      if (two) w[h] = row[gsize];
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      a0 = Vec<VEC>::add(a0, v[h]);
      if (two) a1 = Vec<VEC>::add(a1, w[h]);
    }
  }
  for (; k < kb; ++k) {
    const V* row = reinterpret_cast<const V*>(base + k * row_bytes);
    a0 = Vec<VEC>::add(a0, row[0]);
    if (two) a1 = Vec<VEC>::add(a1, row[gsize]);
  }
}

// Adds a chunk: whole rows go to groups of threads (a thread a column, or
// two where the pass is wider than the consumers), a row to a group in
// turn, each adding its row's quotients in edge order and storing it; a
// piece of a long run goes to the first group, which carries its sums to
// the run's next piece.
template <int VEC>
__device__ __forceinline__ void add_chunk(const int32_t* __restrict__ wb,
                                          int s, int d, const Chunk& c,
                                          const uint8_t* stage, Carry<VEC>& cy,
                                          int ct, int ncons,
                                          float* __restrict__ dh) {
  using V = typename Vec<VEC>::T;
  // ct of the ncons threads adding; two columns a thread where the pass is
  // wider than they, or where that gives more groups (rows at once) to a
  // chunk of whole rows (a piece has one group: its chain is the run)
  const int cpt = c.nc > ncons || (!c.piece && ncons / ((c.nc + 1) / 2) >
                                                   ncons / c.nc)
                      ? 2
                      : 1;
  const int gsize = (c.nc + cpt - 1) / cpt;
  const int P = c.piece ? 1 : ncons / gsize;
  const int j = ct / gsize, t = ct - j * gsize;
  if (j >= P) return;
  const bool two = cpt == 2 && t + gsize < c.nc;
  const uint8_t* base = stage + (c.off + t) * sizeof(V);
  if (c.piece) {
    V a0 = cy.a0, a1 = cy.a1;
    if (c.k0 == wb[c.r0]) a0 = a1 = Vec<VEC>::zero();
    add_run<VEC>(base, c.row_bytes, 0, c.ne, gsize, two, a0, a1);
    cy.a0 = a0;
    cy.a1 = a1;
    if (c.k0 + c.ne == wb[c.r0 + 1]) {
      V* out = reinterpret_cast<V*>(dh + static_cast<size_t>(s + c.r0) * d) +
               c.cs + t;
      out[0] = a0;
      if (two) out[gsize] = a1;
    }
    return;
  }
  for (int r = c.r0 + j; r < c.r1; r += P) {
    const int ka = wb[r] - c.k0, kb = wb[r + 1] - c.k0;
    if (ka == kb) continue;  // no edge reads the row: stored as zeros
    V a0 = Vec<VEC>::zero(), a1 = Vec<VEC>::zero();
    add_run<VEC>(base, c.row_bytes, ka, kb, gsize, two, a0, a1);
    V* out = reinterpret_cast<V*>(dh + static_cast<size_t>(s + r) * d) +
             c.cs + t;
    out[0] = a0;
    if (two) out[gsize] = a1;
  }
}

// Every chunk of the held slots [lo, hi) (their dst rows in ordw from
// lo): warp 0 loads each chunk's q rows by TMA bulk copies, a lane a
// slot, into the stage ring (kStages buffers, full and empty barriers);
// the other warps add them. `n` counts the block's chunks, so that the
// ring's phases carry from one call to the next.
template <int VEC>
__device__ __forceinline__ void run_chunks(
    const float* __restrict__ q, int dq, int d, const Groups& G,
    const int32_t* __restrict__ wb, const int32_t* __restrict__ ordw, int s,
    int lo, int hi, uint8_t* stage, uint64_t* full, uint64_t* empty, int& n,
    Carry<VEC>& cy, float* __restrict__ dh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pos p;
  p.g = 0;
  p.cs = G.c0[0];
  p.r = G.r0[0];
  p.k = max(lo, wb[p.r]);
  Chunk c;
  int i = n;
  while (next_chunk<VEC>(G, wb, lo, hi, -1, p, c)) {
    const int st = i % kStages;
    const uint32_t fill = static_cast<uint32_t>(i / kStages);
    uint8_t* buf = stage + st * kStageBytes;
    if (warp == 0) {
      mbar_wait(empty + st, (fill & 1u) ^ 1u);  // the buffer is free
      if (lane == 0) mbar_expect(full + st, c.ne * c.row_bytes);
      __syncwarp();
      for (int k = lane; k < c.ne; k += 32) {
        const int row = ordw[c.k0 - lo + k];
        bulk_load(buf + k * c.row_bytes,
                  reinterpret_cast<const uint8_t*>(q) +
                      static_cast<size_t>(row) * dq * 4 + c.a0,
                  c.row_bytes, full + st);
      }
    } else {
      mbar_wait(full + st, fill & 1u);
      add_chunk<VEC>(wb, s, d, c, buf, cy, threadIdx.x - 32, kConsumers, dh);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    ++i;
  }
  n = i;
}

// The chunks of the groups whose stage rows are narrow (fewer than
// kBulkMin bytes: a TMA request a slot would cost more than its bytes) by
// the whole block: every thread copies 16-byte cells with cp.async into
// one of two stage buffers while all add the other, as the consumers do.
// The sums of a long run carry in `cy` (this mapping's own).
template <int VEC>
__device__ __forceinline__ void coop_chunks(
    const float* __restrict__ q, int dq, int d, const Groups& G,
    const int32_t* __restrict__ wb, const int32_t* __restrict__ ordw, int s,
    int lo, int hi, int cs_only, uint8_t* stage, Carry<VEC>& cy,
    float* __restrict__ dh) {
  const int tid = threadIdx.x;
  Pos p;
  p.g = 0;
  p.cs = cs_only >= 0 ? cs_only : G.c0[0];
  p.r = G.r0[0];
  p.k = max(lo, wb[p.r]);
  Chunk c, nx;
  if (!next_chunk<VEC>(G, wb, lo, hi, cs_only, p, c)) return;
  auto issue = [&](const Chunk& ch, uint8_t* buf) {
    const int cpr = ch.row_bytes / 16;  // cells a slot
    for (int f = tid; f < ch.ne * cpr; f += kThreads) {
      const int k = f / cpr, x = f - k * cpr;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(q) +
                           static_cast<size_t>(ordw[ch.k0 - lo + k]) * dq * 4 +
                           ch.a0 + x * 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(buf + k * ch.row_bytes + x * 16)),
                   "l"(src)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  __syncthreads();  // the stage buffers are free
  issue(c, stage);
  int bi = 0;
  while (true) {
    const bool more = next_chunk<VEC>(G, wb, lo, hi, cs_only, p, nx);
    if (more) {
      issue(nx, stage + (bi ^ 1) * kStageBytes);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    add_chunk<VEC>(wb, s, d, c, stage + bi * kStageBytes, cy, tid, kThreads,
                   dh);
    __syncthreads();
    if (!more) break;
    c = nx;
    bi ^= 1;
  }
}

template <int VEC>
__device__ __forceinline__ bool narrow(const Groups& G, int g) {
  Chunk c;
  pass_layout<VEC>(G, g, G.c0[g], c);
  return c.row_bytes < kBulkMin;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
sum_kernel(const float* __restrict__ q, int d,
           const int32_t* __restrict__ ord,
           const int32_t* __restrict__ begin,
           const int32_t* __restrict__ bounds, int m,
           float* __restrict__ dh) {
  using V = typename Vec<VEC>::T;
  extern __shared__ __align__(128) uint8_t smem_b[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_b);  // [kStages]
  uint64_t* empty = full + kStages;                       // [kStages]
  uint8_t* stage = smem_b + kBarBytes;                    // [kStages]
  int32_t* wb = reinterpret_cast<int32_t*>(stage + kStages * kStageBytes);
  int32_t* ordw = wb + kWin + 1;                          // [kSeg]

  const int tid = threadIdx.x;
  const int nv = d / VEC, dq = (d + 3) & ~3;
  // the share's first row and its first slot, loaded beside the count
  const int first_row = __ldcg(bounds + 2 * blockIdx.x);
  const int first_slot = __ldcg(bounds + 2 * blockIdx.x + 1);
  const long long units = __ldcg(begin + m);  // a placed edge each
  const long long G = gridDim.x;
  const long long u_lo = blockIdx.x * units / G;
  const long long u_hi = (blockIdx.x + 1) * units / G;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int s = u_lo < u_hi ? first_row : m;
  int ka = first_slot;  // the window's first placed edge
  int n = 0;
  Carry<VEC> cyc;  // the whole block's running sums of a long run
  Carry<VEC> cy;
  while (s < m) {
    const int nr = min(kWin, m - s);
    __syncthreads();
    // the window's first slots, at once with the rows (kSeg, or to the end)
    const int seg = static_cast<int>(min(static_cast<long long>(kSeg),
                                         units - ka));
    for (int r = tid; r <= nr; r += kThreads) wb[r] = __ldcg(begin + s + r);
    for (int k = tid; k < seg; k += kThreads) ordw[k] = __ldcg(ord + ka + k);
    __syncthreads();
    // the window: its rows in the share, [0, n_in), each starting before
    // u_hi, and no more than kSeg placed edges (or one row)
    int lo = 0, hi = nr;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (wb[mid - 1] < u_hi && wb[mid] - wb[0] <= kSeg) lo = mid;
      else hi = mid - 1;
    }
    const int n_in = max(lo, 1);
    const bool more_rows = s + n_in < m && wb[n_in] < u_hi;
    const RowPart first = row_part(wb, 0, s, u_lo, u_hi, nv);
    const RowPart last = row_part(wb, n_in - 1, s, u_lo, u_hi, nv);
    const bool part_first = !(first.c0 == 0 && first.c1 == nv);
    const bool part_last = n_in > 1 && !(last.c0 == 0 && last.c1 == nv);
    Groups gs;
    gs.r0[0] = 0;
    gs.r1[0] = 1;
    gs.c0[0] = first.c0;
    gs.c1[0] = part_first ? first.c1 : first.c0;
    gs.r0[1] = part_first ? 1 : 0;
    gs.r1[1] = part_last ? n_in - 1 : n_in;
    gs.c0[1] = 0;
    gs.c1[1] = nv;
    gs.r0[2] = n_in - 1;
    gs.r1[2] = n_in;
    gs.c0[2] = last.c0;
    gs.c1[2] = part_last ? last.c1 : last.c0;
    const int kb = wb[n_in];
    if (kb - ka <= kSeg) {
      // the rows by the TMA ring, but for a long row cut to a narrow
      // column range (a hub row's share of a few columns): by the whole
      // block, after; a TMA request a slot would fetch a few columns
      Groups ring = gs, block = gs;
      for (int g = 0; g < 3; g += 2) {
        Chunk c;
        pass_layout<VEC>(gs, g, gs.c0[g], c);
        if (gs.c1[g] > gs.c0[g] && c.row_bytes < kBulkMin &&
            wb[gs.r1[g]] - wb[gs.r0[g]] > kBlockRun)
          ring.c1[g] = ring.c0[g];
        else
          block.c1[g] = block.c0[g];
      }
      block.c1[1] = block.c0[1];
      run_chunks<VEC>(q, dq, d, ring, wb, ordw, s, ka, kb, stage, full, empty,
                      n, cy, dh);
      coop_chunks<VEC>(q, dq, d, block, wb, ordw, s, ka, kb, -1, stage, cyc,
                       dh);
    } else {
      // one row of more than kSeg edges: each pass over its placed edges a
      // segment at a time, by the whole block, the running sums carried
      const int g = part_first ? 0 : 1;
      for (int cs = gs.c0[g]; cs < gs.c1[g]; cs += kMaxCols) {
        for (int lo2 = ka; lo2 < kb; lo2 += kSeg) {
          const int hi2 = min(kb, lo2 + kSeg);
          __syncthreads();
          for (int k = tid; k < hi2 - lo2; k += kThreads)
            ordw[k] = __ldcg(ord + lo2 + k);
          coop_chunks<VEC>(q, dq, d, gs, wb, ordw, s, lo2, hi2, cs, stage,
                           cyc, dh);
        }
      }
    }
    if (!more_rows) break;
    s += n_in;
    ka = kb;
  }

}

// the dynamic shared-memory limits and the cluster size above 8, raised
// once so that a CUDA-graph capture never calls cudaFuncSetAttribute
cudaError_t set_limits() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kOrderSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        order_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  // both kernels at the sum kernel's shared-memory carveout, so that no
  // multiprocessor reconfigures its L1 between them
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(order_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sum_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSumSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sum_kernel<4>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sum_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSumSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sum_kernel<2>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sum_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSumSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sum_kernel<1>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err == cudaSuccess) done = true;
  return err;
}

cudaLaunchConfig_t order_config(int blocks, cudaLaunchAttribute* attr,
                                int cluster, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kOrderSmem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Clusters of `cluster` order blocks the card runs at once (*out), for
// the wrapper's plan of tiles.
extern "C" int repro_gather_agg_bwd_clusters(int cluster, int* out) {
  cudaError_t err = set_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = order_config(cluster, attr, cluster, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, order_kernel, &cfg));
}

// g (nd, d) float32; edge_src (nd * fanout,) int32; edge_mask
// (nd * fanout,) bool; the plan (gather_agg.py `plan_backward`): `cluster`
// blocks a cluster (8 to 16), `tiles` clusters of `tile_rows` sources
// (tile_rows <= 16,384, the last tile holding row m - 1), `sum_blocks` sum
// blocks; scratch q (nd, dq) float32 (dq = d rounded up to 4), ord
// (nd * fanout,) int32, begin (m + 1,) int32, bounds (2 * sum_blocks,)
// int32 (each sum block's first row and that row's first slot), all
// written before read; dh (m, d) float32, every row written; vec (4, 2 or
// 1) the float vector width d and dh's address allow.
extern "C" int repro_gather_agg_bwd(const void* g, int d, const void* edge_src,
                                    const void* edge_mask, int nd, int fanout,
                                    int m, int cluster, int tiles,
                                    int tile_rows, int sum_blocks, void* q,
                                    void* ord, void* begin, void* bounds,
                                    void* dh, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile_rows < 1 || tile_rows > kMaxTileRows || cluster < kMinCluster ||
      cluster > kMaxCluster ||
      static_cast<long long>(tiles) * tile_rows < m ||
      static_cast<long long>(tiles - 1) * tile_rows >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = order_config(tiles * cluster, attr, cluster, st);
  err = cudaLaunchKernelEx(&cfg, order_kernel,
                           static_cast<const int32_t*>(edge_src),
                           static_cast<const uint8_t*>(edge_mask), nd, fanout,
                           m, tile_rows, sum_blocks,
                           static_cast<const float*>(g), d,
                           static_cast<float*>(q), static_cast<int32_t*>(ord),
                           static_cast<int32_t*>(begin),
                           static_cast<int32_t*>(bounds),
                           static_cast<float*>(dh));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qp = static_cast<const float*>(q);
  const int32_t* op = static_cast<const int32_t*>(ord);
  const int32_t* bp = static_cast<const int32_t*>(begin);
  const int32_t* np = static_cast<const int32_t*>(bounds);
  float* out = static_cast<float*>(dh);
  if (vec == 4)
    sum_kernel<4><<<sum_blocks, kThreads, kSumSmem, st>>>(qp, d, op, bp, np,
                                                         m, out);
  else if (vec == 2)
    sum_kernel<2><<<sum_blocks, kThreads, kSumSmem, st>>>(qp, d, op, bp, np,
                                                         m, out);
  else
    sum_kernel<1><<<sum_blocks, kThreads, kSumSmem, st>>>(qp, d, op, bp, np,
                                                         m, out);
  return static_cast<int>(cudaGetLastError());
}
