// Backward of the fan-out-regular masked neighbour mean for Hopper
// (sm_90a): dh[s] = sum over unmasked edges e with src_e = s of
// g[e / fanout] / max(cnt[e / fanout], 1), dh of shape (m, d).
//
// Replaces the custom VJP of repro/kernels/gather_agg/ops.py
// (`_kernel_bwd`, one segment_sum of the scaled messages over edge_src).
// A scatter-add with atomics would sum each row in whatever order the
// atomics land, so two runs could differ in the last bit. Here the sum is
// a gather instead: the wrapper first sorts the edges by source with the
// port's own seg_sort kernel (key src_e, INT32_MAX for masked-out edges;
// payload the edge index, so equal sources keep ascending edge order),
// then
//   1. count_kernel: cnt[i] = max(#unmasked edges of dst row i, 1);
//   2. bounds_kernel: one thread per row s in [0, m] finds lo[s], the
//      first sorted key >= s, so row s's run is [lo[s], lo[s + 1]);
//   3. row_sum_kernel: block (s, c) owns source row s and kThreads
//      columns; each thread sums its column over the run in ascending
//      edge order, from +0, loading kBatch edges' rows at once so a long
//      run is not one chain of dependent loads. Rows no edge references
//      get 0.
// The order is fixed, so the result is deterministic and equal to a
// sequential scatter-add in edge order. A hub row with thousands of edges
// is one long loop in its blocks, its time set by memory latency, which
// the batched loads hide; rows and column chunks are independent, so the
// grid stays wide, and the binary searches run once per row in a pass of
// their own instead of in every block. Bound: bytes, the (m, d) output written once
// plus g, read once, and the edge lists.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCountThreads = 256;
constexpr int kBatch = 8;

__global__ void count_kernel(const uint8_t* __restrict__ edge_mask, int nd,
                             int fanout, float* __restrict__ cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nd) return;
  const long long e0 = static_cast<long long>(i) * fanout;
  int c = 0;
  for (int j = 0; j < fanout; ++j) c += edge_mask[e0 + j] ? 1 : 0;
  cnt[i] = fmaxf(static_cast<float>(c), 1.0f);
}

// first k in [0, n) with keys[k] >= v (n if none)
__device__ int lower_bound(const int32_t* __restrict__ keys, int n,
                           long long v) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (static_cast<long long>(__ldg(keys + mid)) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void bounds_kernel(const int32_t* __restrict__ sorted_src,
                              int n_edges, int m, int32_t* __restrict__ lo) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s > m) return;
  lo[s] = lower_bound(sorted_src, n_edges, s);
}

__global__ void row_sum_kernel(const float* __restrict__ g, int d,
                               const int32_t* __restrict__ sorted_edge,
                               const int32_t* __restrict__ lo,
                               const float* __restrict__ cnt, int fanout,
                               float* __restrict__ dh) {
  const long long s = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= d) return;
  const int begin = __ldg(lo + s);
  const int end = __ldg(lo + s + 1);
  float acc = 0.0f;
  int k = begin;
  // kBatch edges at a time: their loads are issued together, then added
  // in edge order, so the sum is the sequential one
  for (; k + kBatch <= end; k += kBatch) {
    float v[kBatch];
    float c[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long i = __ldg(sorted_edge + k + j) / fanout;
      v[j] = __ldg(g + i * d + col);
      c[j] = __ldg(cnt + i);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc += v[j] / c[j];
  }
  for (; k < end; ++k) {
    const long long i = __ldg(sorted_edge + k) / fanout;
    acc += __ldg(g + i * d + col) / __ldg(cnt + i);
  }
  dh[s * d + col] = acc;
}

}  // namespace

// g (nd, d) float32; sorted_src/sorted_edge (n_edges,) int32 from the
// by-source sort; edge_mask (n_edges,) bool; cnt (nd,) float32 and
// lo (m + 1,) int32 scratch; dh (m, d) float32 output, every row written.
extern "C" int repro_gather_agg_bwd(const void* g, int d,
                                    const void* sorted_src,
                                    const void* sorted_edge,
                                    const void* edge_mask, int nd,
                                    int fanout, void* cnt, void* lo, int m,
                                    void* dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_edges = nd * fanout;
  if (nd > 0) {
    count_kernel<<<(nd + kCountThreads - 1) / kCountThreads, kCountThreads,
                   0, s>>>(static_cast<const uint8_t*>(edge_mask), nd,
                           fanout, static_cast<float*>(cnt));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bounds_kernel<<<(m + 1 + kCountThreads - 1) / kCountThreads, kCountThreads,
                  0, s>>>(static_cast<const int32_t*>(sorted_src), n_edges, m,
                          static_cast<int32_t*>(lo));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m, (d + kThreads - 1) / kThreads);
  row_sum_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(g), d,
      static_cast<const int32_t*>(sorted_edge),
      static_cast<const int32_t*>(lo), static_cast<const float*>(cnt),
      fanout, static_cast<float*>(dh));
  return static_cast<int>(cudaGetLastError());
}
