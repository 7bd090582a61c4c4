// Fan-out-regular masked neighbour mean (the AGG of paper Eq. 1) for
// Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel repro/kernels/gather_agg/gather_agg.py
// `_kernel` / `gather_agg`: a sequential (nd, fanout, d/dt) grid that
// brings one source row per step into VMEM and accumulates it into the
// revisited output block, then divides by max(count, 1).
//
// On the card blocks run in parallel and in no order, so the sequential
// fan-out grid axis becomes a loop inside the thread: block (i, c) owns
// dst row i and a chunk of kThreads feature columns; each thread walks
// j = 0 .. fanout-1 in order and adds h[edge_src[i*fanout + j], col]
// where the edge is unmasked. No atomics: the result is deterministic and
// summed in the TPU kernel's order (a masked edge adds +0 there, which
// never changes the +0-started sum, so skipping its row is exact). The
// division is IEEE (no fast math). The bound is bytes: the distinct
// source rows the unmasked edges reference, read once, plus the
// (nd, d) output; neighbouring threads read neighbouring columns of one
// source row, so every row read is a coalesced stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void gather_agg_kernel(const float* __restrict__ h, int d,
                                  const int32_t* __restrict__ edge_src,
                                  const uint8_t* __restrict__ edge_mask,
                                  int fanout, float* __restrict__ out) {
  const long long i = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= d) return;
  const long long e0 = i * fanout;
  float acc = 0.0f;
  int cnt = 0;
#pragma unroll 5
  for (int j = 0; j < fanout; ++j) {
    if (__ldg(edge_mask + e0 + j)) {
      const long long s = __ldg(edge_src + e0 + j);
      acc += __ldg(h + s * d + col);
      ++cnt;
    }
  }
  out[i * d + col] = acc / fmaxf(static_cast<float>(cnt), 1.0f);
}

}  // namespace

extern "C" int repro_gather_agg(const void* h, int d, const void* edge_src,
                                const void* edge_mask, int nd, int fanout,
                                void* out, void* stream) {
  const dim3 grid(nd, (d + kThreads - 1) / kThreads);
  gather_agg_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), d, static_cast<const int32_t*>(edge_src),
      static_cast<const uint8_t*>(edge_mask), fanout,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
