// Hot-set rank and hit test for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cache_lookup/cache_lookup.py
// `_search_kernel` / `search`, which sums (Tq x Tc) comparison masks on
// the vector unit: pos(q) = #{ids < q}, hit(q) = any(ids == q).
//
// On the card each query is one thread doing a lower-bound binary search
// over the sorted int32 cache ids. For sorted ids the lower bound IS
// #{ids < q}, and a hit exists iff ids[lower bound] == q, so the output
// is bit-identical to the mask sum while the work drops from
// O(m * n_hot) to O(m * log n_hot). The ids (16 KB at n_hot = 4096)
// stay in L1/L2 across the whole grid; the bound is the bytes of the
// query, pos and hit vectors, a few hundred KB per micro-batch.
//
// Contract (kept from the TPU kernel): the wrapper substitutes one
// INT32_MAX sentinel row for an empty cache; queries pad with -1 (never
// hit, pos 0); a sentinel query never hits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 2147483647;
constexpr int kThreads = 256;

__global__ void search_kernel(const int32_t* __restrict__ ids, int n_hot,
                              const int32_t* __restrict__ query, int m,
                              int32_t* __restrict__ pos,
                              uint8_t* __restrict__ hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int32_t q = query[i];
  int lo = 0;
  int hi = n_hot;  // first k with ids[k] >= q, i.e. #{ids < q}
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  pos[i] = lo;
  hit[i] = (lo < n_hot && __ldg(ids + lo) == q && q != kSentinel) ? 1 : 0;
}

}  // namespace

extern "C" int repro_search(const void* ids, int n_hot, const void* query,
                            int m, void* pos, void* hit, void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  search_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), n_hot,
      static_cast<const int32_t*>(query), m, static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(hit));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
