// Fan-out-regular masked neighbour mean (the AGG of paper Eq. 1) for
// Hopper (sm_90a), forward only:
//   out[i] = (sum over j < fanout, edge i*fanout + j unmasked, of
//             h[edge_src[i*fanout + j]]) / max(count_i, 1),
// each column summed in j order from +0, the division IEEE (no fast math).
//
// Replaces the TPU kernel repro/kernels/gather_agg/gather_agg.py
// `_kernel` / `gather_agg`: a sequential (nd, fanout, d/dt) grid that
// brings one source row per step into VMEM and accumulates it into the
// revisited output block, then divides by max(count, 1).
//
// Bound: bytes. The distinct source rows the unmasked edges reference,
// read once, plus the (nd, d) output and the edge lists. At the training
// path's layer 0 (h (21,093, 602), 4,622 rows of 25 edges) that is at
// most 50.8 + 11.1 + 0.6 MB; the table is about L2's size and a row is
// read about 5.5 times, so the re-reads should mostly hit L2. What the
// first design (a 128-thread block per dst row and 128 columns) lost was
// not bytes but trips: every block re-read its row's edge ids and mask
// bytes (5 blocks a row at d = 602, the last 70 % idle), and every thread
// walked the fan-out as a dependent chain (mask byte, then source id, then
// one 4-byte value), so few loads were in flight. Here:
//
//   * A warp owns a dst row (or a slice of its columns, see below). Lanes
//     j < fanout load the row's mask bytes and source ids in one coalesced
//     load each, side by side; __ballot_sync gives the unmasked edges as a
//     bit set (its population is the count) and __shfl_sync hands each
//     edge's source to every lane. A fan-out above 32 is taken in rounds of
//     32 edges. The edge lists are read once a row (the first round stays
//     in registers across column passes; later rounds are read again, from
//     L1, only when a row needs more than one pass).
//   * Columns are vectors, the widest of float4, float2 and float that d
//     and both rows' addresses allow (the wrapper's choice): d = 256 takes
//     float4, d = 602 float2 (a 2,408-byte row stride is only 8-byte
//     aligned). A lane owns C vectors 32 apart in a column pass.
//   * Loads run ahead of the adds: the unmasked edges are taken
//     Unroll<C>::value at a time (warp-uniform, from the bit set, so that
//     a lane has at most kInFlight row loads out), all their loads issued
//     before the adds, and the adds done in j order. A masked edge is
//     skipped, which is exact: the sum starts at +0 and so is never -0, and
//     adding +0 to it (what the TPU kernel and the plain version do for a
//     masked edge) changes nothing.
//   * Where nd alone gives too few warps to fill the card (the serving
//     layers, training's layer 1), the wrapper cuts a row's columns over
//     `splits` warps, each at least 32 vectors wide.
//
// One launch a call, no atomics, no scratch: the result is deterministic
// and bit-equal to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;
// row loads a lane keeps in flight: Unroll<C>::value edges x C vectors
constexpr int kInFlight = 16;

template <int C>
struct Unroll {
  static constexpr int value = kInFlight / C < 1 ? 1 : kInFlight / C;
};

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void zero(float& a) { a = 0.0f; }
__device__ __forceinline__ void zero(float2& a) { a = make_float2(0.f, 0.f); }
__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ float divide(float a, float c) { return a / c; }
__device__ __forceinline__ float2 divide(float2 a, float c) {
  return make_float2(a.x / c, a.y / c);
}
__device__ __forceinline__ float4 divide(float4 a, float c) {
  return make_float4(a.x / c, a.y / c, a.z / c, a.w / c);
}

// Add the rows of the unmasked edges in `bits` (lanes' sources in srcl) to
// acc, in ascending edge order, Unroll<C>::value edges' loads ahead of
// their adds.
template <int V, int C>
__device__ __forceinline__ void add_edges(
    const typename Vec<V>::T* __restrict__ hv, int nvec, int col0, int v1,
    int srcl, unsigned bits, typename Vec<V>::T (&acc)[C]) {
  using T = typename Vec<V>::T;
  constexpr int U = Unroll<C>::value;
  while (bits) {                              // warp-uniform
    long long row[U];
    bool on[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      on[u] = bits != 0u;
      const int j = on[u] ? __ffs(bits) - 1 : 0;
      bits &= bits - 1u;
      row[u] = static_cast<long long>(__shfl_sync(kFull, srcl, j)) * nvec;
    }
    T v[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = col0 + 32 * c;
        zero(v[u][c]);
        if (on[u] && col < v1) v[u][c] = __ldg(hv + row[u] + col);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (on[u]) {
#pragma unroll
        for (int c = 0; c < C; ++c) add(acc[c], v[u][c]);
      }
    }
  }
}

// Warp w = blockIdx.x * kWarps + warp owns dst row w / splits and the
// (w % splits)-th of `splits` equal slices of its nvec = d / V vectors.
template <int V, int C>
__global__ void __launch_bounds__(kThreads)
    gather_agg_kernel(const float* __restrict__ h, int d,
                      const int32_t* __restrict__ edge_src,
                      const uint8_t* __restrict__ edge_mask, long long nd,
                      int fanout, int splits, float* __restrict__ out) {
  using T = typename Vec<V>::T;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= nd * splits) return;               // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long i = w / splits;
  const int s = static_cast<int>(w - i * splits);
  const int nvec = d / V;
  const int per = (nvec + splits - 1) / splits;
  const int v0 = s * per;
  const int v1 = min(v0 + per, nvec);
  const long long e0 = i * fanout;
  const T* hv = reinterpret_cast<const T*>(h);
  T* ov = reinterpret_cast<T*>(out) + i * nvec;

  // the first round of edges, kept for every column pass; the source id is
  // loaded beside the mask byte, not after it (a masked edge's id is read
  // and never used)
  const int n0 = min(fanout, 32);
  int src0 = 0;
  bool m0 = false;
  if (lane < n0) {
    src0 = __ldg(edge_src + e0 + lane);
    m0 = __ldg(edge_mask + e0 + lane) != 0;
  }
  const unsigned bits0 = __ballot_sync(kFull, m0);

  for (int base = v0; base < v1; base += 32 * C) {
    T acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) zero(acc[c]);
    const int col0 = base + lane;
    int cnt = __popc(bits0);
    add_edges<V, C>(hv, nvec, col0, v1, src0, bits0, acc);
    for (int j0 = 32; j0 < fanout; j0 += 32) {
      const int nj = min(fanout - j0, 32);
      int srcl = 0;
      bool ml = false;
      if (lane < nj) {
        srcl = __ldg(edge_src + e0 + j0 + lane);
        ml = __ldg(edge_mask + e0 + j0 + lane) != 0;
      }
      const unsigned bits = __ballot_sync(kFull, ml);
      cnt += __popc(bits);
      add_edges<V, C>(hv, nvec, col0, v1, srcl, bits, acc);
    }
    const float denom = fmaxf(static_cast<float>(cnt), 1.0f);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = col0 + 32 * c;
      if (col < v1) ov[col] = divide(acc[c], denom);
    }
  }
}

template <int V, int C>
int launch(const void* h, int d, const void* edge_src, const void* edge_mask,
           long long nd, int fanout, int splits, void* out,
           cudaStream_t stream) {
  const long long warps = nd * splits;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  gather_agg_kernel<V, C><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const float*>(h), d, static_cast<const int32_t*>(edge_src),
      static_cast<const uint8_t*>(edge_mask), nd, fanout, splits,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_v(int chunks, const void* h, int d, const void* edge_src,
             const void* edge_mask, long long nd, int fanout, int splits,
             void* out, cudaStream_t s) {
  switch (chunks) {
    case 1: return launch<V, 1>(h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    case 2: return launch<V, 2>(h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    case 3: return launch<V, 3>(h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    case 4: return launch<V, 4>(h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    case 5: return launch<V, 5>(h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    case 6: return launch<V, 6>(h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    case 7: return launch<V, 7>(h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    case 8: return launch<V, 8>(h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// vec (1, 2, 4): floats a lane loads at once; d % vec == 0 and h, out
// 4 * vec-byte aligned. splits >= 1 warps a row, chunks (1..kMaxChunks)
// vectors a lane owns in a column pass: the wrapper's plan
// (gather_agg.py `plan_forward`).
extern "C" int repro_gather_agg(const void* h, int d, const void* edge_src,
                                const void* edge_mask, long long nd,
                                int fanout, int vec, int splits, int chunks,
                                void* out, void* stream) {
  if (nd <= 0 || d <= 0) return 0;
  if (fanout < 1 || splits < 1 || chunks < 1 || chunks > kMaxChunks ||
      d % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1: return launch_v<1>(chunks, h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    case 2: return launch_v<2>(chunks, h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    case 4: return launch_v<4>(chunks, h, d, edge_src, edge_mask, nd, fanout, splits, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
