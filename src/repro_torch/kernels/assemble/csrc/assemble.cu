// Fused feature assembly (rank, classify and select in one pass) for
// Hopper (sm_90a).
//
// Replaces the TPU path repro/kernels/assemble/assemble.py `assemble`:
// `classify` over the `search` kernel (repro/kernels/cache_lookup/
// cache_lookup.py:65), then `_select_kernel`, a (m, d/dt) grid whose
// scalar-prefetched BlockSpecs bring the local-shard row, the cache row
// and the pulled row of every query into VMEM and write the winner once.
//
// On the card one launch does all of it, and one warp owns one output
// row. It reads the row's query id and does the classify arithmetic of
// repro/kernels/assemble/assemble.py:40 inline, in priority order:
//
//   1. local shard: 0 <= q - base < n_per. The rank is never needed.
//   2. cache hit: the warp ranks q over the sorted hot-set ids with a
//      32-ary search. At each level lane k probes
//      ids[min(lo + (k + 1) * step - 1, n_hot - 1)]; __ballot_sync of
//      probe < q and __popc give the number of probes below q, which
//      moves lo by that many steps; step = ceil(step / 32) until step is
//      1. Three levels at n_hot 4,096 (steps 128, 4, 1) and at 32,768
//      (1,024, 32, 1); the first level's 32 probes are the same for
//      every warp and stay in L1, the last reads at most 32 contiguous
//      ids. pos = min(lo, n_hot) = #{ids < q}; hit is ids[pos] == q (the
//      probe the last level's lane c already holds, broadcast with
//      __shfl_sync) and q != INT32_MAX. The cache row is
//      cpos = min(pos, n_hot - 1).
//   3. otherwise the pulled row.
//
// The reference also clips the local slot to [0, n_per - 1] because it
// addresses all three candidates unconditionally; here the local row is
// read only inside the branch 0 <= slot < n_per, which makes that clip a
// no-op. pos and hit never leave the warp. The bound is bytes: one row
// read from its winning source and one row written per query, the
// queries and the ids once, 2 x m x d x 4 + m x 4 + n_hot x 4 bytes.
// Rows move as 16-byte vectors when both the source and the destination
// row are 16-byte aligned (d = 602 rows alternate between 16- and 8-byte
// alignment), as 8-byte vectors when both are 8-byte aligned, else as
// scalars; the d % width tail is copied element-wise, so any d works.
// Each lane loads up to 64 bytes of its row before it stores any, so a
// warp keeps its whole row of d = 602 in flight in one or two rounds:
// the rank's three dependent L1/L2 loads then cost the copy less than a
// row-at-a-vector loop does (PERF.md, section 6). The rank runs in 32-bit
// arithmetic (n_hot < 2^30): 64-bit indices cost registers and, with
// them, warps in flight.
// n_hot = 0 assembles cache-less (local shard over pulled rows). Every
// output row is a bit copy of one source row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 2147483647;
constexpr int kWarpsPerBlock = 8;
// bytes a lane loads before it stores, per round of a row copy
constexpr int kLaneBytes = 64;
constexpr unsigned kFull = 0xffffffffu;

// #{ids < q} over sorted ids (1 <= n_hot < 2^30), the same in every
// lane; *hit = ids[rank] == q and q is not the sentinel.
__device__ __forceinline__ int warp_rank(const int32_t* __restrict__ ids,
                                         int n_hot, int32_t q, int lane,
                                         bool* hit) {
  int lo = 0;
  int step = (n_hot + 31) / 32;
  int32_t probe;
  int below;
  while (true) {
    const int at = lo + (lane + 1) * step - 1;
    probe = __ldg(ids + min(at, n_hot - 1));
    below = __popc(__ballot_sync(kFull, probe < q));
    lo = min(lo + below * step, n_hot);
    if (step == 1) break;
    step = (step + 31) / 32;
  }
  // below < 32 whenever lo < n_hot: lane `below` probed ids[lo]
  const int32_t at_rank = __shfl_sync(kFull, probe, below & 31);
  *hit = lo < n_hot && at_rank == q && q != kSentinel;
  return lo;
}

// One row of d floats as vectors of V: each lane loads up to kLaneBytes
// of the row before it stores any (a row of d = 602 in one or two rounds).
template <typename V>
__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst, int d,
                                         int lane) {
  constexpr int kWidth = static_cast<int>(sizeof(V) / sizeof(float));
  constexpr int kUnroll = kLaneBytes / static_cast<int>(sizeof(V));
  const int nv = d / kWidth;
  const V* sv = reinterpret_cast<const V*>(src);
  V* dv = reinterpret_cast<V*>(dst);
  for (int k0 = 0; k0 < nv; k0 += 32 * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * 32 + lane;
      if (k < nv) v[u] = sv[k];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * 32 + lane;
      if (k < nv) dv[k] = v[u];
    }
  }
  for (int k = nv * kWidth + lane; k < d; k += 32) dst[k] = src[k];
}

__global__ void assemble_kernel(const float* __restrict__ table,
                                long long n_per, long long base,
                                const int32_t* __restrict__ cache_ids,
                                const float* __restrict__ cache_feats,
                                int n_hot, const float* __restrict__ pulled,
                                const int32_t* __restrict__ query,
                                float* __restrict__ out, int m, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (row >= m) return;  // the whole warp: threadIdx.y is its row
  const int lane = threadIdx.x;
  const int32_t q = __ldg(query + row);
  const long long slot = static_cast<long long>(q) - base;
  const float* src = pulled + static_cast<long long>(row) * d;
  if (slot >= 0 && slot < n_per) {
    src = table + slot * d;
  } else if (n_hot > 0) {
    bool hit;
    const int pos = warp_rank(cache_ids, n_hot, q, lane, &hit);
    if (hit) {
      const int cpos = min(pos, n_hot - 1);
      src = cache_feats + static_cast<long long>(cpos) * d;
    }
  }
  float* dst = out + static_cast<long long>(row) * d;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst);
  if ((align & 15) == 0) {
    copy_row<float4>(src, dst, d, lane);
  } else if ((align & 7) == 0) {
    copy_row<float2>(src, dst, d, lane);
  } else {
    copy_row<float>(src, dst, d, lane);
  }
}

}  // namespace

extern "C" int repro_assemble(const void* table, long long n_per,
                              long long base, const void* cache_ids,
                              const void* cache_feats, int n_hot,
                              const void* pulled, const void* query,
                              void* out, int m, int d, void* stream) {
  if (n_hot >= (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, kWarpsPerBlock);
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  assemble_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), n_per, base,
      static_cast<const int32_t*>(cache_ids),
      static_cast<const float*>(cache_feats), n_hot,
      static_cast<const float*>(pulled), static_cast<const int32_t*>(query),
      static_cast<float*>(out), m, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
