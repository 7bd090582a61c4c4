// Stable LSD radix sort of non-negative int32 keys, with an optional int32
// payload riding along, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/seg_sort/seg_sort.py
// `_radix_pass_kernel` / `radix_sort`: one grid step per 4-bit pass with
// the whole key vector resident in VMEM (so at most MAX_VMEM_N = 2^19
// keys), a masked cumsum per digit value for the stable ranks and a
// scalar store loop for the reorder.
//
// On the card the vector lives in HBM and is cut into tiles of kTile keys,
// one block each. Every pass over 8-bit digits is three launches:
//   1. histogram: per-block digit counts, written digit-major
//      (hist[digit * blocks + block]);
//   2. scan: one block per digit turns its row of counts into exclusive
//      offsets within the digit and writes the digit's total;
//   3. scatter: each block first adds the exclusive prefix of the digit
//      totals to its row offsets, so offsets run in (digit, block) order;
//      then it walks its tile in input order, one key per thread per
//      round, ranks each key among equal digits before it (within the
//      warp by __match_any_sync, across warps by a per-round prefix over
//      per-warp digit counts) and stores it at its digit's offset plus
//      that rank. Keys that tie on a digit keep their input order, so the
//      sort is stable and the output is the one of a stable comparison
//      sort.
// No atomics anywhere: every count is written by one owner. Each thread
// loads its whole share of the tile (kRounds keys, and payloads) into
// registers before the first round, so the rounds wait on no global load.
//
// Digits: 8 bits, so 2^num_bits key spaces take ceil((num_bits + 1) / 8)
// passes (3 for the 20-bit composite keys of the schedule compiler). The
// extra bit is for keys at or above 2^num_bits, such as the INT32_MAX pad
// sentinel: they are ranked as the one value 2^num_bits, so they sort
// after every real key wherever they stand in the input, and the full
// 32-bit key is moved, so the sentinel stays INT32_MAX.
//
// Bound: bytes. Each pass reads the keys twice (histogram and scatter)
// and writes them once, plus the payload read and written once; the
// digit-count table is 1 KB per 4,096 keys.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                  // keys per thread per tile
constexpr int kTile = kThreads * kRounds;    // 4,096 keys per block
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;     // == kThreads: one digit a thread
constexpr int kScanThreads = 512;
constexpr uint32_t kNoDigit = kDigits;       // lanes past the end of the input
constexpr unsigned kFull = 0xffffffffu;

static_assert(kDigits == kThreads, "one thread per digit in the prefix");

__device__ __forceinline__ uint32_t digit_of(int32_t key, uint32_t clamp,
                                             int shift) {
  uint32_t u = static_cast<uint32_t>(key);
  u = u < clamp ? u : clamp;
  return (u >> shift) & (kDigits - 1);
}

// Exclusive prefix sum of v over the block (kBlock threads, a multiple of
// 32); *total gets the block's sum. warp_sums holds kBlock / 32 ints.
template <int kBlock>
__device__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_sums,
                                        int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kBlock / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kBlock / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const int32_t before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kBlock / 32 - 1];
  __syncthreads();                 // warp_sums may be reused on return
  return before + x - v;
}

__global__ void histogram_kernel(const int32_t* __restrict__ keys, int n,
                                 uint32_t clamp, int shift,
                                 int32_t* __restrict__ hist, int blocks) {
  __shared__ int32_t warp_count[kWarps][kDigits];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << (tid & 31)) - 1u;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  uint32_t d[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = tile0 + r * kThreads + tid;
    d[r] = i < n ? digit_of(__ldg(keys + i), clamp, shift) : kNoDigit;
  }
  for (int w = 0; w < kWarps; ++w) warp_count[w][tid] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned peers = __match_any_sync(kFull, d[r]);
    // the lowest lane of each digit group adds the group's size: one
    // writer per (warp, digit) per round
    if (d[r] != kNoDigit && (peers & lanes_below) == 0) {
      warp_count[warp][d[r]] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  int32_t total = 0;
  for (int w = 0; w < kWarps; ++w) total += warp_count[w][tid];
  hist[static_cast<long long>(tid) * blocks + blockIdx.x] = total;
}

// Block d scans digit d's row of per-block counts in place (exclusive)
// and writes the digit's total.
__global__ void scan_kernel(int32_t* __restrict__ hist, int blocks,
                            int32_t* __restrict__ digit_total) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  int32_t* row = hist + static_cast<long long>(blockIdx.x) * blocks;
  int32_t carry = 0;
  for (int base = 0; base < blocks; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int32_t v = i < blocks ? row[i] : 0;
    int32_t sum;
    const int32_t ex = block_exclusive_scan<kScanThreads>(v, warp_sums, &sum);
    if (i < blocks) row[i] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) digit_total[blockIdx.x] = carry;
}

__global__ void scatter_kernel(const int32_t* __restrict__ keys_in,
                               const int32_t* __restrict__ pay_in,
                               int32_t* __restrict__ keys_out,
                               int32_t* __restrict__ pay_out, int n,
                               uint32_t clamp, int shift,
                               const int32_t* __restrict__ offsets,
                               const int32_t* __restrict__ digit_total,
                               int blocks) {
  __shared__ int32_t next[kDigits];               // next free slot per digit
  __shared__ int32_t warp_count[kWarps][kDigits];
  __shared__ int32_t warp_base[kWarps][kDigits];
  __shared__ int32_t warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << (tid & 31)) - 1u;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const bool with_payload = pay_in != nullptr;
  int32_t key[kRounds];
  int32_t pay[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = tile0 + r * kThreads + tid;
    key[r] = i < n ? keys_in[i] : 0;
    pay[r] = (with_payload && i < n) ? pay_in[i] : 0;
  }
  int32_t all;
  const int32_t digit_base =
      block_exclusive_scan<kThreads>(digit_total[tid], warp_sums, &all);
  next[tid] = digit_base +
              offsets[static_cast<long long>(tid) * blocks + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) warp_count[w][tid] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const bool active = tile0 + r * kThreads + tid < n;
    const uint32_t d = active ? digit_of(key[r], clamp, shift) : kNoDigit;
    const unsigned peers = __match_any_sync(kFull, d);
    const int rank = __popc(peers & lanes_below);
    if (active && rank == 0) warp_count[warp][d] = __popc(peers);
    __syncthreads();
    // thread t owns digit t: warps of this round take their slots in
    // warp order after every earlier round's keys of the digit
    {
      int32_t run = next[tid];
      for (int w = 0; w < kWarps; ++w) {
        warp_base[w][tid] = run;
        run += warp_count[w][tid];
        warp_count[w][tid] = 0;
      }
      next[tid] = run;
    }
    __syncthreads();
    if (active) {
      const int32_t dst = warp_base[warp][d] + rank;
      keys_out[dst] = key[r];
      if (with_payload) pay_out[dst] = pay[r];
    }
  }
}

}  // namespace

// Length of the int32 scratch for n keys: the digit-count table
// (kDigits per block) and the kDigits digit totals.
extern "C" long long repro_radix_sort_scratch_len(int n) {
  const long long blocks = (static_cast<long long>(n) + kTile - 1) / kTile;
  return blocks * kDigits + kDigits;
}

// Sort n keys (and the payload, if pay_in is not null) from keys_in into
// keys_out. keys_tmp/pay_tmp are ping-pong scratch of n entries, scratch
// holds repro_radix_sort_scratch_len(n) int32; the inputs are not
// written. 1 <= num_bits <= 31; real keys lie below 2^num_bits, anything
// above sorts last in input order.
extern "C" int repro_radix_sort(const void* keys_in, const void* pay_in,
                                void* keys_out, void* pay_out,
                                void* keys_tmp, void* pay_tmp, void* scratch,
                                int n, int num_bits, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kTile - 1) / kTile;
  const int bits = num_bits + 1 > 32 ? 32 : num_bits + 1;
  const uint32_t clamp = 1u << num_bits;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const int32_t* src_k = static_cast<const int32_t*>(keys_in);
  const int32_t* src_p = static_cast<const int32_t*>(pay_in);
  int32_t* hist = static_cast<int32_t*>(scratch);
  int32_t* totals = hist + static_cast<long long>(blocks) * kDigits;
  for (int p = 0; p < passes; ++p) {
    // the last pass lands in keys_out: alternate backwards from it
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    int32_t* dst_k = static_cast<int32_t*>(to_out ? keys_out : keys_tmp);
    int32_t* dst_p = pay_in == nullptr
        ? nullptr
        : static_cast<int32_t*>(to_out ? pay_out : pay_tmp);
    const int shift = p * kDigitBits;
    histogram_kernel<<<blocks, kThreads, 0, s>>>(src_k, n, clamp, shift,
                                                 hist, blocks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_kernel<<<kDigits, kScanThreads, 0, s>>>(hist, blocks, totals);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scatter_kernel<<<blocks, kThreads, 0, s>>>(src_k, src_p, dst_k, dst_p, n,
                                               clamp, shift, hist, totals,
                                               blocks);
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
