// Single-pass feature assembly (the select pass) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/assemble/assemble.py
// `_select_kernel` / `assemble`: a (m, d/dt) grid whose scalar-prefetched
// BlockSpecs bring the local-shard row, the cache row and the pulled row
// of every query into VMEM and write the winner once.
//
// On the card one warp owns one output row. It reads the row's query id
// and the `search` kernel's (pos, hit), does the classify arithmetic of
// repro/kernels/assemble/assemble.py:40 inline (priority local shard >
// cache hit > pulled, with the clamp cpos = min(pos, n_hot - 1)), and
// copies ONLY the winning source row. The reference also clips the local
// slot to [0, n_per - 1] because it addresses all three candidates
// unconditionally; here the local row is read only inside the branch
// 0 <= slot < n_per, which makes that clip a no-op. The bound is bytes: one row read and one row written per query,
// 2 x m x d x 4 bytes. Rows move as 16-byte vectors when both the source
// and the destination row are 16-byte aligned (d = 602 rows alternate
// between 16- and 8-byte alignment), as 8-byte vectors when both are
// 8-byte aligned, else as scalars; the d % width tail is copied
// element-wise, so any d works. Every output row is a bit copy of one
// source row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename V>
__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst, int d,
                                         int lane) {
  constexpr int kWidth = static_cast<int>(sizeof(V) / sizeof(float));
  const int nv = d / kWidth;
  const V* sv = reinterpret_cast<const V*>(src);
  V* dv = reinterpret_cast<V*>(dst);
  for (int k = lane; k < nv; k += 32) dv[k] = sv[k];
  for (int k = nv * kWidth + lane; k < d; k += 32) dst[k] = src[k];
}

__global__ void select_kernel(const float* __restrict__ table,
                              long long n_per, long long base,
                              const float* __restrict__ cache_feats,
                              int n_hot, const float* __restrict__ pulled,
                              const int32_t* __restrict__ query,
                              const int32_t* __restrict__ pos,
                              const uint8_t* __restrict__ hit,
                              float* __restrict__ out, int m, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (row >= m) return;
  const int lane = threadIdx.x;
  const long long slot = static_cast<long long>(query[row]) - base;
  const float* src;
  if (slot >= 0 && slot < n_per) {
    src = table + slot * d;
  } else if (hit[row]) {
    const int cpos = min(pos[row], n_hot - 1);
    src = cache_feats + static_cast<long long>(cpos) * d;
  } else {
    src = pulled + static_cast<long long>(row) * d;
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

extern "C" int repro_assemble_select(const void* table, long long n_per,
                                     long long base, const void* cache_feats,
                                     int n_hot, const void* pulled,
                                     const void* query, const void* pos,
                                     const void* hit, void* out, int m,
                                     int d, void* stream) {
  const dim3 block(32, kWarpsPerBlock);
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  select_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), n_per, base,
      static_cast<const float*>(cache_feats), n_hot,
      static_cast<const float*>(pulled), static_cast<const int32_t*>(query),
      static_cast<const int32_t*>(pos), static_cast<const uint8_t*>(hit),
      static_cast<float*>(out), m, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
