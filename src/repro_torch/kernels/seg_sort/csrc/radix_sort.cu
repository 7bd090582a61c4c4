// Stable LSD radix sort of non-negative int32 keys, with an optional int32
// payload riding along, for Hopper (sm_90a): a one-sweep sort (Adinets &
// Merrill, "Onesweep", 2022), one launch per 8-bit pass after one
// histogram launch.
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
// 4 * (1 + 2 * passes) bytes a key (58.7 MB, 17.5 us, at 3 passes). The
// first design (three launches a pass: per-block digit counts, a scan of
// them, a scatter) read the keys twice a pass and ran nine launches for
// three passes, each of them short and paying its own start and drain.
// Here a call is 1 + passes launches:
//
//   1. histogram_kernel reads the keys once and counts every pass's 256
//      digits: each thread counts runs of equal digits among 8 consecutive
//      keys in shared memory (a composite key's high digit repeats, so a
//      run costs one shared atomic), and each block adds its counts into
//      the global histogram with integer atomics (deterministic: integer
//      sums). The same launch resets every pass's tile ticket and look-back
//      status words. The global histogram is kept per card and left zero
//      by each call (the pass that reads it zeroes it), as a captured graph
//      replays it.
//   2. onesweep_kernel, one launch per pass, one block per tile of kTile
//      keys. A block takes its tile from an atomic ticket, so tiles start
//      in input order and a tile's predecessors are always running. It
//      ranks its keys stably: warp w owns a contiguous run of the tile,
//      32 keys a round; a round's lanes of one digit find each other by an
//      atomicOr of their lane bits into the warp's shared word for the
//      digit, and a per-warp shared histogram counts the earlier rounds, so
//      a key's rank within its warp is the count of earlier equal digits.
//      Thread t owns digit t: it turns the warps' counts into each warp's
//      first slot, publishes the tile's count of digit t with an
//      "aggregate" flag, and looks back over the predecessors' status
//      words, kLookback at a time, until it meets an "inclusive" one,
//      summing as it goes; then it publishes its own inclusive prefix.
//      Tile 0 publishes at once, its prefix the exclusive scan of the
//      global histogram. Keys (and payload) are put in the tile's sorted
//      order in shared memory and written out in that order, so each
//      digit's run of a tile is stored contiguously.
//
// A status word is 64 bits: the flag in the high half, the count in the
// low half (a digit's prefix is below n < 2^31, so 32 bits always hold
// it; 30 would not for n >= 2^30). It is written and read whole, with
// relaxed accesses at gpu scope, so no stale L1 line is ever read.
//
// At the schedule compiler's 2,097,152 keys all 512 tiles of a pass are
// resident at once (four blocks a multiprocessor), so a pass lasts about
// as long as one tile: its loads, its ranking (the whole card's ranking
// work, shared by the resident tiles), its look-back (a chain of
// dependent L2 reads, as all tiles publish together) and its writes.
// Finding equal digits with a shared word cuts the ranking (eight ballots
// a key, or __match_any_sync, were slower), and reading kLookback status
// words a step shortens the chain (more words a step cost more L2 reads
// than they save; two levels, tile groups with their own look-back, were
// no faster).
//
// Digits: 8 bits, so 2^num_bits key spaces take ceil((num_bits + 1) / 8)
// passes (3 for the 20-bit composite keys of the schedule compiler). The
// extra bit is for keys at or above 2^num_bits, such as the INT32_MAX pad
// sentinel: they are ranked as the one value 2^num_bits, so they sort
// after every real key wherever they stand in the input, and the full
// 32-bit key is moved, so the sentinel stays INT32_MAX.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                  // keys per thread per tile
constexpr int kTile = kThreads * kRounds;    // 4,096 keys per block
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;     // == kThreads: one digit a thread
constexpr int kMaxPasses = 4;
constexpr int kHistThreads = 512;
constexpr int kHistRun = 8;                  // consecutive keys a thread counts
constexpr int kHistBlocksPerSm = 2;
constexpr int kLookback = 4;                 // status words a step reads

constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

static_assert(kDigits == kThreads, "one thread per digit in the look-back");

__device__ __forceinline__ uint32_t digit_of(int32_t key, uint32_t clamp,
                                             int shift) {
  uint32_t u = static_cast<uint32_t>(key);
  u = u < clamp ? u : clamp;
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
// the status words and block 0 the tile tickets.
__global__ void __launch_bounds__(kHistThreads)
    histogram_kernel(const int32_t* __restrict__ keys, int n, uint32_t clamp,
                     int passes, long long chunk, uint32_t* __restrict__ hist,
                     unsigned long long* __restrict__ status,
                     long long status_words, uint32_t* __restrict__ tickets) {
  __shared__ uint32_t count[kMaxPasses * kDigits];
  const int tid = threadIdx.x;
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
  for (long long b = lo + static_cast<long long>(tid) * kHistRun; b < hi;
       b += static_cast<long long>(kHistThreads) * kHistRun) {
    uint32_t u[kHistRun];
    const int m = hi - b < kHistRun ? static_cast<int>(hi - b) : kHistRun;
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

// One pass over 8-bit digits at `shift`: keys_in -> keys_out (and the
// payload), stable. status holds this pass's tiles x kDigits words (zero on
// entry), ticket its tile ticket, hist its 256 global digit counts (read by
// tile 0, then zeroed for the next call).
template <bool kPayload>
__global__ void __launch_bounds__(kThreads, 4)
    onesweep_kernel(const int32_t* __restrict__ keys_in,
                    const int32_t* __restrict__ pay_in,
                    int32_t* __restrict__ keys_out,
                    int32_t* __restrict__ pay_out, int n, uint32_t clamp,
                    int shift, unsigned long long* __restrict__ status,
                    uint32_t* __restrict__ ticket, uint32_t* __restrict__ hist) {
  __shared__ uint32_t s_tile;
  __shared__ uint32_t warp_count[kWarps][kDigits];
  // each warp's lanes of one digit while ranking; then the sorted tile
  __shared__ union {
    uint32_t match[kWarps][kDigits];
    int32_t keys[kTile];
  } s;
  __shared__ int32_t s_pay[kPayload ? kTile : 1];
  __shared__ int32_t s_base[kDigits];
  __shared__ uint32_t warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  if (tid == 0) s_tile = atomicAdd(ticket, 1u);
  for (int w = 0; w < kWarps; ++w) {
    warp_count[w][tid] = 0;
    s.match[w][tid] = 0;
  }
  __syncthreads();
  const uint32_t tile = s_tile;
  const long long tile0 = static_cast<long long>(tile) * kTile;
  const long long first = tile0 + warp * (32 * kRounds) + lane;

  int32_t key[kRounds];
  int32_t pay[kPayload ? kRounds : 1];
  uint32_t rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = first + 32 * r;
    key[r] = i < n ? keys_in[i] : 0;
    if (kPayload) pay[kPayload ? r : 0] = i < n ? pay_in[i] : 0;
  }
  // ranks within the warp: earlier rounds first, then lower lanes. A
  // round's lanes of one digit find each other by an atomicOr of their
  // lane bits into the warp's word for the digit; the lowest of them adds
  // their number to the warp's count of the digit and clears the word.
  uint32_t(&match)[kDigits] = s.match[warp];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const bool act = first + 32 * r < n;
    const uint32_t d = digit_of(key[r], clamp, shift);
    if (act) atomicOr(&match[d], 1u << lane);
    __syncwarp();
    const unsigned peers = act ? match[d] : 0u;
    const uint32_t before = act ? warp_count[warp][d] : 0u;
    __syncwarp();
    if (act && (peers & lanes_below) == 0) {
      warp_count[warp][d] = before + __popc(peers);
      match[d] = 0u;
    }
    __syncwarp();
    rank[r] = before + __popc(peers & lanes_below);
  }
  __syncthreads();

  // thread tid owns digit tid: each warp's first slot among the tile's keys
  // of the digit, and the tile's count of it
  uint32_t count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_count[w][tid];
    warp_count[w][tid] = count;
    count += c;
  }
  unsigned long long* mine = status + static_cast<long long>(tile) * kDigits;
  uint32_t excl;
  if (tile == 0) {                             // block-uniform
    const uint32_t total = hist[tid];
    hist[tid] = 0;                             // left zero for the next call
    uint32_t all;
    excl = block_exclusive_scan<kThreads>(total, warp_sums, &all);
    store_status(mine + tid, kInclusive | (excl + count));
  } else {
    store_status(mine + tid, kAggregate | count);
    // walk back kLookback predecessors a step, in order, summing
    // aggregates until an inclusive word; a word not yet published ends
    // the step, and the next step starts again from it
    uint32_t sum = 0;
    long long j = static_cast<long long>(tile) - 1;
    for (bool done = false; !done;) {
      unsigned long long v[kLookback];
#pragma unroll
      for (int q = 0; q < kLookback; ++q)
        v[q] = j - q >= 0 ? load_status(status + (j - q) * kDigits + tid)
                          : 0ull;
      int step = 0;
      bool stop = false;
#pragma unroll
      for (int q = 0; q < kLookback; ++q) {
        const unsigned long long flag = v[q] & ~0xffffffffull;
        if (!stop) {
          if (flag == 0) {
            stop = true;                       // not published yet
          } else {
            sum += static_cast<uint32_t>(v[q]);
            ++step;
            if (flag == kInclusive) stop = done = true;
          }
        }
      }
      j -= step;
    }
    excl = sum;
    store_status(mine + tid, kInclusive | (excl + count));
  }

  // the tile in sorted order in shared memory: digit, then warp, then rank
  uint32_t all;
  const uint32_t tile_off = block_exclusive_scan<kThreads>(count, warp_sums,
                                                           &all);
  s_base[tid] = static_cast<int32_t>(excl - tile_off);
  for (int w = 0; w < kWarps; ++w) warp_count[w][tid] += tile_off;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (first + 32 * r < n) {
      const uint32_t slot =
          warp_count[warp][digit_of(key[r], clamp, shift)] + rank[r];
      s.keys[slot] = key[r];
      if (kPayload) s_pay[slot] = pay[kPayload ? r : 0];
    }
  }
  __syncthreads();
  const int tile_n = n - tile0 < kTile ? static_cast<int>(n - tile0) : kTile;
  for (int k = tid; k < tile_n; k += kThreads) {
    const int32_t x = s.keys[k];
    const int32_t dst = s_base[digit_of(x, clamp, shift)] + k;
    keys_out[dst] = x;
    if (kPayload) pay_out[dst] = s_pay[k];
  }
}

int passes_of(int num_bits) {
  const int bits = num_bits + 1 > 32 ? 32 : num_bits + 1;
  return (bits + kDigitBits - 1) / kDigitBits;
}

long long tiles_of(int n) { return (static_cast<long long>(n) + kTile - 1) / kTile; }

}  // namespace

// Bytes of the per-call scratch for n keys: every pass's look-back status
// words (tiles x kDigits, 64 bits each), then the kMaxPasses tile tickets.
extern "C" long long repro_radix_sort_scratch_bytes(int n, int num_bits) {
  return passes_of(num_bits) * tiles_of(n) * kDigits * 8LL +
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
// sorts last in input order. sms: the card's multiprocessors.
extern "C" int repro_radix_sort(const void* keys_in, const void* pay_in,
                                void* keys_out, void* pay_out,
                                void* keys_tmp, void* pay_tmp, void* scratch,
                                void* hist, int n, int num_bits, int sms,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = passes_of(num_bits);
  const long long tiles = tiles_of(n);
  const uint32_t clamp = 1u << num_bits;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  uint32_t* tickets =
      reinterpret_cast<uint32_t*>(status + passes * tiles * kDigits);
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
      status, passes * tiles * kDigits, tickets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int32_t* src_k = static_cast<const int32_t*>(keys_in);
  const int32_t* src_p = static_cast<const int32_t*>(pay_in);
  for (int p = 0; p < passes; ++p) {
    // the last pass lands in keys_out: alternate backwards from it
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    int32_t* dst_k = static_cast<int32_t*>(to_out ? keys_out : keys_tmp);
    int32_t* dst_p = pay_in == nullptr
        ? nullptr
        : static_cast<int32_t*>(to_out ? pay_out : pay_tmp);
    unsigned long long* st = status + p * tiles * kDigits;
    if (pay_in == nullptr) {
      onesweep_kernel<false><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          src_k, nullptr, dst_k, nullptr, n, clamp, p * kDigitBits, st,
          tickets + p, counts + p * kDigits);
    } else {
      onesweep_kernel<true><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          src_k, src_p, dst_k, dst_p, n, clamp, p * kDigitBits, st,
          tickets + p, counts + p * kDigits);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_k = dst_k;
    src_p = dst_p;
  }
  return 0;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
