// Hot-set merge (`merge_gather`) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cache_lookup/cache_lookup.py
// `_merge_kernel` / `merge_gather`: a (m, d/dt) grid whose
// scalar-prefetched BlockSpec brings cache row pos[i] and base row i into
// VMEM and writes `hit[i] ? cache_feats[pos[i]] : base[i]`, the cache row
// cast to base's dtype.
//
//   out[i] = hit[i] ? cast(cache_feats[min(pos[i], n_hot - 1)]) : base[i]
//
// The function is a pure copy, so the bound is bytes: one row read from
// its winning source and one row written, 2 x m x d x elem bytes (plus
// the 5-byte pos/hit pair of a row). On the card one warp owns one
// output row: it reads the row's hit flag and position, picks the source
// row, and copies only that row -- a losing row is never read. When the
// cache and the output share a dtype the row moves as raw bytes in the
// widest vector (16, 8, 4, 2 or 1 bytes) that divides the source
// address, the destination address and the row's byte length: at
// d = 602 in float32 a row is 2,408 bytes, so rows alternate between
// 16- and 8-byte alignment and move as 8-byte vectors where 16 would
// fault, while at d = 2,304 every row moves as 16-byte vectors. Any d
// (d = 1 included) and any m >= 1 work; the wrapper launches nothing for
// m = 0, d = 0 or an empty cache. Where the cache is float32 and the
// output bfloat16 (or the reverse) a hit row is converted element-wise
// with round-to-nearest-even, as `astype` does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// dtype codes shared with the Python binding
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename V>
__device__ __forceinline__ void copy_bytes(const char* __restrict__ src,
                                           char* __restrict__ dst,
                                           long long nbytes, int lane) {
  const long long nv = nbytes / static_cast<long long>(sizeof(V));
  const V* sv = reinterpret_cast<const V*>(src);
  V* dv = reinterpret_cast<V*>(dst);
  for (long long k = lane; k < nv; k += 32) dv[k] = sv[k];
}

__device__ __forceinline__ void copy_row(const char* src, char* dst,
                                         long long nbytes, int lane) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(nbytes);
  if ((align & 15) == 0) {
    copy_bytes<uint4>(src, dst, nbytes, lane);
  } else if ((align & 7) == 0) {
    copy_bytes<uint2>(src, dst, nbytes, lane);
  } else if ((align & 3) == 0) {
    copy_bytes<uint32_t>(src, dst, nbytes, lane);
  } else if ((align & 1) == 0) {
    copy_bytes<uint16_t>(src, dst, nbytes, lane);
  } else {
    copy_bytes<uint8_t>(src, dst, nbytes, lane);
  }
}

__device__ __forceinline__ float load_as_float(const char* row, int k,
                                               int dtype) {
  if (dtype == kFloat32) return reinterpret_cast<const float*>(row)[k];
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[k]);
}

__device__ __forceinline__ void store_float(char* row, int k, float v,
                                            int dtype) {
  if (dtype == kFloat32) {
    reinterpret_cast<float*>(row)[k] = v;
  } else {
    reinterpret_cast<__nv_bfloat16*>(row)[k] = __float2bfloat16_rn(v);
  }
}

__global__ void merge_gather_kernel(const char* __restrict__ cache_feats,
                                    int n_hot, int cache_dtype,
                                    const char* __restrict__ base,
                                    const int32_t* __restrict__ pos,
                                    const uint8_t* __restrict__ hit,
                                    char* __restrict__ out, int out_dtype,
                                    int m, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (row >= m) return;
  const int lane = threadIdx.x;
  const long long out_esize = out_dtype == kFloat32 ? 4 : 2;
  const long long row_bytes = out_esize * d;
  char* dst = out + static_cast<long long>(row) * row_bytes;
  if (!hit[row]) {
    copy_row(base + static_cast<long long>(row) * row_bytes, dst, row_bytes,
             lane);
    return;
  }
  // pos is a rank (#{ids < q}) and so never negative; the clamp from below
  // only keeps a malformed pos inside the cache
  const int cpos = max(0, min(pos[row], n_hot - 1));
  const long long cache_esize = cache_dtype == kFloat32 ? 4 : 2;
  const char* src = cache_feats + static_cast<long long>(cpos) * cache_esize * d;
  if (cache_dtype == out_dtype) {
    copy_row(src, dst, row_bytes, lane);
    return;
  }
  for (int k = lane; k < d; k += 32) {
    store_float(dst, k, load_as_float(src, k, cache_dtype), out_dtype);
  }
}

}  // namespace

extern "C" int repro_merge_gather(const void* cache_feats, int n_hot,
                                  int cache_dtype, const void* base,
                                  const void* pos, const void* hit,
                                  void* out, int out_dtype, int m, int d,
                                  void* stream) {
  const dim3 block(32, kWarpsPerBlock);
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  merge_gather_kernel<<<blocks, block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(cache_feats), n_hot, cache_dtype,
      static_cast<const char*>(base), static_cast<const int32_t*>(pos),
      static_cast<const uint8_t*>(hit), static_cast<char*>(out), out_dtype,
      m, d);
  return static_cast<int>(cudaGetLastError());
}
