// Stable LSD radix sort of non-negative int32 keys, with an optional int32
// payload riding along, for Hopper (sm_90a): a one-sweep sort (Adinets &
// Merrill, "Onesweep", 2022) whose tiles meet in thread block clusters, one
// launch per 8-bit pass after one histogram launch.
//
// Replaces the TPU kernel repro/kernels/seg_sort/seg_sort.py
// `_radix_pass_kernel` / `radix_sort`: one grid step per 4-bit pass with
// the whole key vector resident in VMEM (so at most MAX_VMEM_N = 2^19
// keys), a masked cumsum per digit value for the stable ranks and a
// scalar store loop for the reorder.
//
// Bound: bytes. A sort that reads each key once and writes it once moves
// 8 bytes a key (16.8 MB, 5.0 us at 3.35 TB/s, for the schedule
// compiler's 2,097,152 keys); an LSD sort reads and writes the keys once
// per pass, and this design reads them once more for the histograms:
// 4 * (1 + 2 * passes) bytes a key. A call is 1 + passes launches:
//
//   1. histogram_kernel reads the keys once and counts every pass's 256
//      digits: each thread counts runs of equal digits among 8 consecutive
//      keys in shared memory (a composite key's high digit repeats, so a
//      run costs one shared atomic, and a warp whose 256 keys share one
//      digit adds them with one), and each block adds its counts into the
//      global histogram with integer atomics (deterministic: integer
//      sums). The same launch resets every pass's cluster ticket and
//      look-back status words. The global histogram is kept per card and
//      left zero by each call (the pass that reads it zeroes it), as a
//      captured graph replays it.
//   2. onesweep_kernel, one launch per pass, in thread block clusters of
//      kCluster blocks (launched with cudaLaunchKernelEx), a block a tile of
//      kTile keys. The cluster's rank-0 block takes a ticket, which the others
//      read through distributed shared memory, so clusters start in input
//      order and a cluster's predecessors are always running; block b takes
//      tile ticket * kCluster + b. Thread 0 loads the tile (and its payload)
//      into shared memory by one TMA bulk copy on an mbarrier (threads load
//      the up to three keys at each end that are not 16-byte aligned). The
//      block ranks its keys stably: warp w owns a contiguous run of the tile,
//      32 keys a round; a round whose lanes share one digit takes consecutive
//      ranks at once, otherwise a round's lanes of one digit find each other
//      by an atomicOr of their lane bits into the warp's shared word for the
//      digit, and a per-warp shared histogram counts the earlier rounds. Each
//      block publishes its tile's digit counts in shared memory and the
//      cluster meets (a split barrier, while each block scans its counts into
//      its tile's offsets). Block b owns every digit d with d % kCluster == b,
//      a group of kCluster lanes a digit, lane g the cluster's block g: the
//      group reads the blocks' counts of d through distributed shared memory,
//      scans them and publishes the cluster's count of d at once (cluster 0
//      its inclusive prefix, from the exclusive scan of the global histogram).
//      While the earlier clusters publish, the block puts its tile in sorted
//      order in shared memory; then the group looks back over the earlier
//      clusters' status words, a word a lane a step, until an inclusive one,
//      publishes the cluster's inclusive prefix and writes each block's first
//      output slot of d into that block's shared memory. After a second
//      meeting each block writes its tile out in sorted order, each digit's
//      run contiguous.
//
// A status word is 64 bits: the flag in the high half, the count in the
// low half (a digit's prefix is below n < 2^31, so 32 bits always hold
// it). It is written and read whole, with relaxed accesses at gpu scope,
// so no stale L1 line is ever read.
//
// At the schedule compiler's 2,097,152 keys (456 tiles) the 57 clusters of
// 8 are all resident at once (four blocks a multiprocessor, 64 registers
// a thread, ranks kept two to a register), and the keys stay in L2 from
// pass to pass. A pass is then a chain of latencies and of shared-memory
// work in step on every multiprocessor: the ticket, the tile's load, the
// ranking (bound by shared-memory accesses), the cluster's meetings, the
// look-back (which waits on the slowest tile of the earlier clusters) and
// the writes. Measured on an H100, and left out: clusters of 16 or 4
// (16 meets more slowly, 4 walks farther), a look-back reading more words
// a lane a step or walking from both ends (their extra reads of the
// status words cost more than the shorter chain saves), ranking by eight
// ballots or __match_any_sync, 11-bit digits (two passes, but their 128 KB
// of ranking tables leave one block a multiprocessor), and 4,096-key tiles
// at five blocks a multiprocessor (64 clusters; 2 % slower a call).
//
// Digits: 8 bits, so 2^num_bits key spaces take ceil((num_bits + 1) / 8)
// passes (3 for the 20-bit composite keys of the schedule compiler). The
// extra bit is for keys at or above 2^num_bits, such as the INT32_MAX pad
// sentinel: they are ranked as the one value 2^num_bits, so they sort
// after every real key wherever they stand in the input, and the full
// 32-bit key is moved, so the sentinel stays INT32_MAX.
//
// Every scratch word is written before it is read. A refused launch (too
// much shared memory, a cluster size the card refuses) is returned to the
// wrapper, which raises.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 18;                  // keys per thread per tile
constexpr int kTile = kThreads * kRounds;    // 4,608 keys per block
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;     // == kThreads: one digit a thread
constexpr int kMaxPasses = 4;
constexpr int kHistThreads = 512;
constexpr int kHistRun = 8;                  // consecutive keys a thread counts
constexpr int kHistBlocksPerSm = 4;
constexpr int kCluster = 8;                  // blocks (tiles) a cluster

constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

static_assert(kDigits == kThreads, "one thread per digit");
static_assert(kDigits % kCluster == 0 && (kCluster & (kCluster - 1)) == 0,
              "a group of kCluster lanes a digit");

__device__ __forceinline__ uint32_t digit_of(uint32_t key, uint32_t clamp,
                                             int shift) {
  const uint32_t u = key < clamp ? key : clamp;
  return (u >> shift) & (kDigits - 1);
}

// A status word holds all it says (flag and count), so it is read and
// written as one relaxed 64-bit access at gpu scope (never from a stale L1
// line); no other memory is published with it, so no fence is needed.
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
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

// Exclusive prefix sum of v over the block (kBlock threads, a multiple of
// 32); *total gets the block's sum. warp_sums holds kBlock / 32 ints.
template <int kBlock>
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_sums,
                                         uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kBlock / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kBlock / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kBlock / 32 - 1];
  __syncthreads();                 // warp_sums may be reused on return
  return before + x - v;
}

// Block b counts the digits of keys [b * chunk, (b + 1) * chunk) for every
// pass and adds them into hist (zero on entry); all blocks together reset
// the status words and block 0 the cluster tickets.
__global__ void __launch_bounds__(kHistThreads)
    histogram_kernel(const int32_t* __restrict__ keys, int n, uint32_t clamp,
                     int passes, long long chunk, uint32_t* __restrict__ hist,
                     unsigned long long* __restrict__ status,
                     long long status_words, uint32_t* __restrict__ tickets) {
  __shared__ uint32_t count[kMaxPasses * kDigits];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int k = tid; k < kMaxPasses * kDigits; k += kHistThreads) count[k] = 0;
  if (blockIdx.x == 0 && tid < kMaxPasses) tickets[tid] = 0;
  for (long long k = static_cast<long long>(blockIdx.x) * kHistThreads + tid;
       k < status_words;
       k += static_cast<long long>(gridDim.x) * kHistThreads)
    status[k] = 0ull;
  __syncthreads();
  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  // chunk and lo are multiples of kHistRun, so a whole run of a 16-byte
  // aligned key array is two aligned int4
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  // warp-uniform trips: a warp takes 32 consecutive runs a step
  for (long long w0 = lo + static_cast<long long>(warp) * 32 * kHistRun;
       w0 < hi; w0 += static_cast<long long>(kHistThreads) * kHistRun) {
    const long long b = w0 + static_cast<long long>(lane) * kHistRun;
    const int m = b >= hi ? 0
                          : (hi - b < kHistRun ? static_cast<int>(hi - b)
                                               : kHistRun);
    uint32_t u[kHistRun];
    if (vec && m == kHistRun) {
      const int4 x0 = __ldg(reinterpret_cast<const int4*>(keys + b));
      const int4 x1 = __ldg(reinterpret_cast<const int4*>(keys + b) + 1);
      const int32_t x[kHistRun] = {x0.x, x0.y, x0.z, x0.w,
                                   x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int r = 0; r < kHistRun; ++r) u[r] = static_cast<uint32_t>(x[r]);
    } else {
#pragma unroll
      for (int r = 0; r < kHistRun; ++r)
        u[r] = r < m ? static_cast<uint32_t>(__ldg(keys + b + r)) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kHistRun; ++r) u[r] = u[r] < clamp ? u[r] : clamp;
    for (int p = 0; p < passes; ++p) {
      const int shift = p * kDigitBits;
      uint32_t cur = (u[0] >> shift) & (kDigits - 1);
      bool one = true;                       // the run's keys share a digit
#pragma unroll
      for (int r = 1; r < kHistRun; ++r)
        one = one && (r >= m || ((u[r] >> shift) & (kDigits - 1)) == cur);
      const uint32_t lead = __shfl_sync(kFull, cur, 0);
      if (__all_sync(kFull, m == 0 || (one && cur == lead))) {
        uint32_t sum = static_cast<uint32_t>(m);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        if (lane == 0) atomicAdd(&count[p * kDigits + lead], sum);
        continue;
      }
      if (m == 0) continue;
      uint32_t run = 1;
#pragma unroll
      for (int r = 1; r < kHistRun; ++r) {
        if (r < m) {
          const uint32_t d = (u[r] >> shift) & (kDigits - 1);
          if (d == cur) {
            ++run;
          } else {
            atomicAdd(&count[p * kDigits + cur], run);
            cur = d;
            run = 1;
          }
        }
      }
      atomicAdd(&count[p * kDigits + cur], run);
    }
  }
  __syncthreads();
  for (int k = tid; k < passes * kDigits; k += kHistThreads) {
    if (count[k]) atomicAdd(hist + k, count[k]);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
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
// shared `dst` (16-byte aligned), counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Where a tile of `len` int32 at `src` lies in its shared buffer: entry k
// at buf[mis + k], so that the 16-byte aligned body [head, head + body)
// lands 16-byte aligned for the bulk copy; threads load the head and tail.
struct Span {
  int mis, head, body;
  __device__ Span(const int32_t* src, int len) {
    mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
    head = min(len, (4 - mis) & 3);
    body = (len - head) & ~3;
  }
};

__device__ __forceinline__ void load_ends(int32_t* buf, const int32_t* src,
                                          int len, const Span& s) {
  const int tail = len - s.head - s.body;
  const int t = threadIdx.x;
  if (t < s.head) buf[s.mis + t] = __ldg(src + t);
  if (t >= 4 && t < 4 + tail) {
    const int k = s.head + s.body + t - 4;
    buf[s.mis + k] = __ldg(src + k);
  }
}

// Shared memory of one onesweep block (dynamic), then the payload's tile.
struct alignas(16) SortSmem {
  int32_t keys[kTile + 4];               // the tile; then in sorted order
  uint32_t warp_count[kWarps][kDigits];  // counts, then first slots
  union {
    uint32_t match[kWarps][kDigits];     // a round's lanes of one digit
    struct {
      uint32_t count[kDigits];  // the tile's digit counts (read remotely)
      uint32_t first[kDigits];  // the tile's first slot of each digit
      uint32_t gexcl[kDigits];  // cluster 0: the global offsets
      uint32_t base[kDigits];   // each digit's first output slot (written
                                // remotely by the digit's owner), then
                                // less the tile's first slot
    } d;
  } u;
  uint64_t bar;
  uint32_t ticket;
  uint32_t warp_sums[kWarps];
};

template <bool kPayload>
constexpr size_t sort_smem_bytes() {
  return sizeof(SortSmem) + (kPayload ? sizeof(int32_t) * (kTile + 4) : 0);
}

// One pass over 8-bit digits at `shift`: keys_in -> keys_out (and the
// payload), stable. status holds this pass's clusters x kDigits words
// (zero on entry), ticket its cluster ticket, hist its 256 global digit
// counts (read by cluster 0, then zeroed for the next call).
template <bool kPayload>
__global__ void __launch_bounds__(kThreads, 4)
    onesweep_kernel(const int32_t* __restrict__ keys_in,
                    const int32_t* __restrict__ pay_in,
                    int32_t* __restrict__ keys_out,
                    int32_t* __restrict__ pay_out, int n, uint32_t clamp,
                    int shift, unsigned long long* __restrict__ status,
                    uint32_t* __restrict__ ticket, uint32_t* __restrict__ hist) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SortSmem& s = *reinterpret_cast<SortSmem*>(smem_raw);
  int32_t* s_pay = reinterpret_cast<int32_t*>(smem_raw + sizeof(SortSmem));
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  // the cluster's ticket, taken by its rank-0 block
  if (rank == 0 && tid == 0) s.ticket = atomicAdd(ticket, 1u);
  if (tid == 0) {
    mbar_init(&s.bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();
  for (int w = 0; w < kWarps; ++w) {
    s.warp_count[w][tid] = 0;
    s.u.match[w][tid] = 0;
  }
  cluster_wait();
  const uint32_t cl = *cluster.map_shared_rank(&s.ticket, 0);
  const long long tile0 = (static_cast<long long>(cl) * C + rank) * kTile;
  const int tile_n = tile0 < n ? static_cast<int>(min(
                                     static_cast<long long>(kTile), n - tile0))
                               : 0;
  const Span sk(keys_in + tile0, tile_n);
  const Span sp(kPayload ? pay_in + tile0 : keys_in, tile_n);
  if (tile_n > 0) {
    const uint32_t bytes = 4u * (sk.body + (kPayload ? sp.body : 0));
    if (tid == 0 && bytes > 0) {
      mbar_expect(&s.bar, bytes);
      if (sk.body > 0)
        bulk_load(s.keys + sk.mis + sk.head, keys_in + tile0 + sk.head,
                  4u * sk.body, &s.bar);
      if (kPayload && sp.body > 0)
        bulk_load(s_pay + sp.mis + sp.head, pay_in + tile0 + sp.head,
                  4u * sp.body, &s.bar);
    }
    load_ends(s.keys, keys_in + tile0, tile_n, sk);
    if (kPayload) load_ends(s_pay, pay_in + tile0, tile_n, sp);
    __syncthreads();
    if (bytes > 0) mbar_wait(&s.bar, 0);
  }

  // ranks within the warp (earlier rounds first, then lower lanes), two
  // 16-bit ranks a word (a warp holds 512 keys)
  const int wfirst = warp * (32 * kRounds) + lane;
  uint32_t rk[kRounds / 2];
  uint32_t(&match)[kDigits] = s.u.match[warp];
  uint32_t(&wcount)[kDigits] = s.warp_count[warp];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = wfirst + 32 * r;
    const bool act = i < tile_n;
    const uint32_t d =
        act ? digit_of(static_cast<uint32_t>(s.keys[sk.mis + i]), clamp, shift)
            : 0u;
    const uint32_t d0 = __shfl_sync(kFull, d, 0);
    uint32_t rank_r;
    if (__all_sync(kFull, act && d == d0)) {   // one digit: ranks in a row
      const uint32_t before = wcount[d0];
      __syncwarp();
      if (lane == 0) wcount[d0] = before + 32;
      rank_r = before + lane;
    } else {
      // a round's lanes of one digit find each other by an atomicOr of
      // their lane bits into the warp's word for the digit; the lowest of
      // them adds their number to the warp's count and clears the word
      if (act) atomicOr(&match[d], 1u << lane);
      __syncwarp();
      const unsigned peers = act ? match[d] : 0u;
      const uint32_t before = act ? wcount[d] : 0u;
      __syncwarp();
      if (act && (peers & lanes_below) == 0) {
        wcount[d] = before + __popc(peers);
        match[d] = 0u;
      }
      rank_r = before + __popc(peers & lanes_below);
    }
    __syncwarp();
    rk[r / 2] = r % 2 ? rk[r / 2] | (rank_r << 16) : rank_r;
  }
  __syncthreads();

  // thread t owns digit t: each warp's first slot among the tile's keys of
  // the digit, and the tile's count of it, published for the cluster (the
  // match words are dead: their space holds the counts)
  uint32_t count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t x = s.warp_count[w][tid];
    s.warp_count[w][tid] = count;
    count += x;
  }
  s.u.d.count[tid] = count;
  cluster_arrive();
  // while the cluster meets: the tile's first slot of each digit, and
  // cluster 0's offsets, the exclusive scan of the global histogram
  uint32_t all;
  const uint32_t tile_off = block_exclusive_scan<kThreads>(count, s.warp_sums,
                                                           &all);
  s.u.d.first[tid] = tile_off;
  for (int w = 0; w < kWarps; ++w) s.warp_count[w][tid] += tile_off;
  if (cl == 0)
    s.u.d.gexcl[tid] = block_exclusive_scan<kThreads>(__ldcg(hist + tid),
                                                      s.warp_sums, &all);
  __syncthreads();                          // the block's own writes above
  cluster_wait();

  // block `rank` owns the digits d with d % C == rank, a group of C lanes
  // a digit, lane g the cluster's block g: the group
  // scans the blocks' counts of d and publishes the cluster's count (or,
  // in cluster 0, its inclusive prefix) at once
  const int g = tid % C;
  const int d = (tid / C) * C + rank;
  const unsigned gmask = ((1u << C) - 1u) << (lane - g);
  const uint32_t mine = cluster.map_shared_rank(s.u.d.count, g)[d];
  uint32_t inc = mine;
  for (int o = 1; o < C; o <<= 1) {
    const uint32_t y = __shfl_up_sync(gmask, inc, o, C);
    if (g >= o) inc += y;
  }
  const uint32_t agg = __shfl_sync(gmask, inc, C - 1, C);
  unsigned long long* word =
      status + static_cast<long long>(cl) * kDigits + d;
  uint32_t excl = cl == 0 ? s.u.d.gexcl[d] : 0u;
  if (g == 0)
    store_status(word, cl == 0 ? kInclusive | (excl + agg)
                               : kAggregate | agg);

  // while the earlier clusters publish: the tile in sorted order in shared
  // memory (digit, then warp, then rank)
  {
    int32_t key[kRounds];
    int32_t pay[kPayload ? kRounds : 1];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {           // rk becomes the slots
      const int i = wfirst + 32 * r;
      key[r] = i < tile_n ? s.keys[sk.mis + i] : 0;
      if (kPayload) pay[kPayload ? r : 0] = i < tile_n ? s_pay[sp.mis + i] : 0;
      const uint32_t slot =
          s.warp_count[warp][digit_of(static_cast<uint32_t>(key[r]), clamp,
                                      shift)] +
          (r % 2 ? rk[r / 2] >> 16 : rk[r / 2] & 0xffffu);
      rk[r / 2] = r % 2 ? (rk[r / 2] & 0xffffu) | (slot << 16)
                        : (rk[r / 2] & 0xffff0000u) | slot;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (wfirst + 32 * r < tile_n) {
        const uint32_t slot = r % 2 ? rk[r / 2] >> 16 : rk[r / 2] & 0xffffu;
        s.keys[slot] = key[r];
        if (kPayload) s_pay[slot] = pay[kPayload ? r : 0];
      }
    }
  }

  if (cl > 0) {                             // block-uniform
    // lane g reads predecessor j - g; the nearest inclusive word ends the
    // walk, an unpublished one ends the step (the next starts from it)
    long long j = static_cast<long long>(cl) - 1;
    for (;;) {
      const long long at = j - g;
      const unsigned long long v =
          at >= 0 ? load_status(status + at * kDigits + d) : kInclusive;
      const unsigned long long flag = v & ~0xffffffffull;
      const unsigned incl =
          (__ballot_sync(gmask, flag == kInclusive) & gmask) >> (lane - g);
      const unsigned stop =
          incl | (__ballot_sync(gmask, flag == 0) & gmask) >> (lane - g);
      // the lanes below the first stop, and the stop itself if inclusive
      const int first = stop ? __ffs(stop) - 1 : C;
      const bool fin = first < C && ((incl >> first) & 1u);
      const int take = fin ? first + 1 : first;
      uint32_t x = g < take ? static_cast<uint32_t>(v) : 0u;
      for (int o = C / 2; o > 0; o >>= 1) x += __shfl_xor_sync(gmask, x, o, C);
      excl += x;
      if (fin) break;
      j -= take;
    }
    if (g == 0) store_status(word, kInclusive | (excl + agg));
  }
  // block g's first output slot of d, into its shared memory
  cluster.map_shared_rank(s.u.d.base, g)[d] = excl + inc - mine;
  __syncwarp();                             // the groups' walks end apart
  cluster_arrive();
  cluster_wait();                           // no remote access after this

  s.u.d.base[tid] -= s.u.d.first[tid];      // less the tile's first slot
  __syncthreads();
  for (int k = tid; k < tile_n; k += kThreads) {
    const int32_t x = s.keys[k];
    const uint32_t dst = s.u.d.base[digit_of(static_cast<uint32_t>(x), clamp,
                                             shift)] + k;
    keys_out[dst] = x;
    if (kPayload) pay_out[dst] = s_pay[k];
  }
  if (cl == 0 && rank == 0) hist[tid] = 0;  // left zero for the next call
}

int passes_of(int num_bits) {
  const int bits = num_bits + 1 > 32 ? 32 : num_bits + 1;
  return (bits + kDigitBits - 1) / kDigitBits;
}

long long clusters_of(int n) {
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  return (tiles + kCluster - 1) / kCluster;
}

// the dynamic shared-memory limits, raised once a card (the attribute is
// the current device's) so that a CUDA-graph capture never calls
// cudaFuncSetAttribute
cudaError_t set_limits() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(onesweep_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sort_smem_bytes<false>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(onesweep_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sort_smem_bytes<true>()));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

// Bytes of the per-call scratch for n keys: every pass's look-back status
// words (clusters x kDigits, 64 bits each), then the kMaxPasses cluster
// tickets.
extern "C" long long repro_radix_sort_scratch_bytes(int n, int num_bits) {
  return passes_of(num_bits) * clusters_of(n) * kDigits * 8LL +
         kMaxPasses * 4LL;
}

// int32 entries of the per-card global histogram (zero before the first
// call; every call leaves it zero).
extern "C" int repro_radix_sort_hist_len() { return kMaxPasses * kDigits; }

// Sort n keys (and the payload, if pay_in is not null) from keys_in into
// keys_out. keys_tmp/pay_tmp are ping-pong scratch of n entries, scratch
// holds repro_radix_sort_scratch_bytes(n, num_bits) bytes (8-byte
// aligned), hist the per-card histogram; the inputs are not written.
// 1 <= num_bits <= 31; real keys lie below 2^num_bits, anything above
// sorts last in input order. sms: the card's multiprocessors. After a
// nonzero return the histogram may hold counts: the caller drops it.
extern "C" int repro_radix_sort(const void* keys_in, const void* pay_in,
                                void* keys_out, void* pay_out,
                                void* keys_tmp, void* pay_tmp, void* scratch,
                                void* hist, int n, int num_bits, int sms,
                                void* stream) {
  if (n <= 0) return 0;
  if (num_bits < 1 || num_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = passes_of(num_bits);
  const long long clusters = clusters_of(n);
  const uint32_t clamp = 1u << num_bits;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  uint32_t* tickets =
      reinterpret_cast<uint32_t*>(status + passes * clusters * kDigits);
  uint32_t* counts = static_cast<uint32_t*>(hist);

  const long long per_block = static_cast<long long>(kHistThreads) * kHistRun;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > static_cast<long long>(kHistBlocksPerSm) * sms)
    blocks = static_cast<long long>(kHistBlocksPerSm) * sms;
  if (blocks < 1) blocks = 1;
  // a block's keys: a multiple of kHistRun, so each run lies in one block
  long long chunk = (n + blocks - 1) / blocks;
  chunk = (chunk + kHistRun - 1) / kHistRun * kHistRun;
  histogram_kernel<<<static_cast<unsigned>(blocks), kHistThreads, 0, s>>>(
      static_cast<const int32_t*>(keys_in), n, clamp, passes, chunk, counts,
      status, passes * clusters * kDigits, tickets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int32_t* src_k = static_cast<const int32_t*>(keys_in);
  const int32_t* src_p = static_cast<const int32_t*>(pay_in);
  for (int p = 0; p < passes; ++p) {
    // the last pass lands in keys_out: alternate backwards from it
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    int32_t* dst_k = static_cast<int32_t*>(to_out ? keys_out : keys_tmp);
    int32_t* dst_p = pay_in == nullptr
        ? nullptr
        : static_cast<int32_t*>(to_out ? pay_out : pay_tmp);
    unsigned long long* st = status + p * clusters * kDigits;
    if (pay_in == nullptr) {
      cfg.dynamicSmemBytes = sort_smem_bytes<false>();
      err = cudaLaunchKernelEx(&cfg, onesweep_kernel<false>, src_k, src_p,
                               dst_k, dst_p, n, clamp, p * kDigitBits, st,
                               tickets + p, counts + p * kDigits);
    } else {
      cfg.dynamicSmemBytes = sort_smem_bytes<true>();
      err = cudaLaunchKernelEx(&cfg, onesweep_kernel<true>, src_k, src_p,
                               dst_k, dst_p, n, clamp, p * kDigitBits, st,
                               tickets + p, counts + p * kDigits);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_k = dst_k;
    src_p = dst_p;
  }
  return 0;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
