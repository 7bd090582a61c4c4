// Hot-set rank and hit test for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cache_lookup/cache_lookup.py
// `_search_kernel` / `search`, which sums (Tq x Tc) comparison masks on
// the vector unit: pos(q) = #{ids < q}, hit(q) = any(ids == q).
//
// The bound is bytes: the query, pos and hit vectors (9 bytes a query)
// and the sorted ids once, a few hundred KB a micro-batch -- below the
// cost of one launch, so on the main path the rank is folded into the
// fused assembly kernel (kernels/assemble/csrc/assemble.cu) and this
// kernel runs only where the rank is wanted on its own (the staged
// assembly, the hot-token embedding lookup). What the design does about
// the bound is to keep each query's chain of dependent loads short and
// out of device memory:
//
//   1. Splitter table in shared memory. Each block of a persistent grid
//      (at most 2 a multiprocessor, a grid-stride loop over queries, so
//      the table is read once a block) issues its first query loads, then
//      copies the last id of every segment of `seg` ids into shared
//      memory: seg = 32 (one 128-byte line) up to n_hot = 65,536, so at
//      most 2,048 words (8 KB); above that the least multiple of 32 that
//      keeps the table at 2,048 words.
//   2. Each thread binary-searches the table: c = #{splitters < q} names
//      the one segment holding the rank (every id of segments < c is
//      below q, the last id of segment c is not; c past the table means
//      every id is below q and pos = n_hot).
//   3. It finishes with a lower bound inside segment c in device memory:
//      at seg = 32 one 128-byte line, so one L1/L2 miss a query and L1
//      hits after it, where a search over the whole array waits on 13
//      dependent loads at n_hot 4,096. ids[pos] == q is read from the same
//      line. (Reading the line with 8 independent int4 loads and counting
//      instead measured slower on the card: PERF.md, section 6.)
//   4. Consecutive threads write consecutive pos words and hit bytes.
//
// Contract (kept from the TPU kernel): the wrapper substitutes one
// INT32_MAX sentinel row for an empty cache; queries pad with -1 (never
// hit, pos 0); a sentinel query never hits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 2147483647;
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kTableWords = 2048;
constexpr int kLine = 32;  // int32 ids in a 128-byte line

__device__ __forceinline__ int32_t load_query(const int32_t* query, int m,
                                              int i) {
  return i < m ? __ldg(query + i) : -1;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    search_kernel(const int32_t* __restrict__ ids, int n_hot, int seg,
                  int n_split, const int32_t* __restrict__ query, int m,
                  int32_t* __restrict__ pos, uint8_t* __restrict__ hit) {
  __shared__ int32_t split[kTableWords];
  const int stride = gridDim.x * kThreads;
  int i = blockIdx.x * kThreads + threadIdx.x;
  int32_t q = load_query(query, m, i);  // in flight while the table fills
  for (int j = threadIdx.x; j < n_split; j += kThreads) {
    const long long last = static_cast<long long>(j + 1) * seg - 1;
    split[j] = __ldg(ids + (last < n_hot ? last : n_hot - 1));
  }
  __syncthreads();
  for (; i < m; i += stride) {
    int lo = 0;
    int hi = n_split;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (split[mid] < q) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int rank = n_hot;
    bool eq = false;
    if (lo < n_split) {
      // ids[end - 1] >= q, so the lower bound lands inside the segment
      int a = lo * seg;
      int b = min(a + seg, n_hot) - 1;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (__ldg(ids + mid) < q) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      rank = a;
      eq = __ldg(ids + a) == q;
    }
    pos[i] = rank;
    hit[i] = (eq && q != kSentinel) ? 1 : 0;
    q = load_query(query, m, i + stride);
  }
}

int multiprocessors() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return count[dev] > 0 ? count[dev] : 1;
}

}  // namespace

extern "C" int repro_search(const void* ids, int n_hot, const void* query,
                            int m, void* pos, void* hit, void* stream) {
  // seg: a line of ids, or the least multiple of a line that keeps the
  // splitter table within kTableWords (tests/test_torch_search_plan.py
  // emulates this plan)
  const long long span = static_cast<long long>(kTableWords) * kLine;
  const int seg = kLine * static_cast<int>((n_hot + span - 1) / span);
  const int n_split = (n_hot + seg - 1) / seg;
  const int want = (m + kThreads - 1) / kThreads;
  const int cap = kBlocksPerSm * multiprocessors();
  const int blocks = want < cap ? want : cap;
  search_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), n_hot, seg, n_split,
      static_cast<const int32_t*>(query), m, static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(hit));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
