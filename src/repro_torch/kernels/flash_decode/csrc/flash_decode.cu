// Single-token attention over a KV cache (decode) for Hopper (sm_90a):
// (acc, m, l) partials over the valid positions start <= pos < length,
// GQA, tanh logit softcap.
//
// Replaces the TPU kernel repro/kernels/flash_decode/flash_decode.py
// `_kernel` / `flash_decode`: a (kvH, S/ts) grid, one batch element per
// call (JAX vmaps it), walking the cache tiles in order on one core with
// (m, l, acc) in VMEM scratch, the kv head's whole q-head group in the
// block, and emitting the UNNORMALIZED (acc, m, l) so that shards of a
// cache combine.
//
// On the card one launch takes the whole batch. Block (b*kvH + h, split)
// owns one kv head's G query heads over one slice of the cache. Inside
// it, groups of L lanes (L = dh/8 rounded up to a power of two; 32 at
// dh = 256) each take four keys at a time, every lane 8 columns of each,
// so each key row is one coalesced 16- or 32-byte-per-lane read and four
// rows are in flight per group; the dot products are finished by
// shuffles inside the group, and each group keeps its own running
// (m, l, acc) over its keys, rescaled once per four keys. The groups' states merge in
// shared memory at the end with the combine rule, and a second small
// kernel combines the slices and normalises: the TPU kernel's own
// (acc, m, l) contract, used here to spread a long cache over the card's
// 132 multiprocessors (B*kvH alone is 32 blocks at the serving shape).
// Positions outside [start, length) are never read, which is exact: a
// masked key leaves (m, l, acc) unchanged. Any S (no tile-multiple
// assert); with no valid position m = -1e30, l = 0, acc = 0 and the
// normalised output is 0, as the reference's finalize gives.
//
// Arithmetic is float32, as on the TPU: q is cast and then scaled,
// s = (q*scale).k, then tanh(s/softcap)*softcap, online max and sum.
// The bound is bytes: the valid K/V rows, read once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // keys a lane group has in flight
// the most shared memory a shape the wrapper admits needs (MAXG = 8,
// dh = 8: 256 one-lane groups), under the card's 227 KB a block
constexpr int kMaxSmem = 96 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int32_t* __restrict__ length,
                      const int32_t* __restrict__ start, int B, int S, int H,
                      int kvH, int dh, int lanes_log2, int chunk, float scale,
                      float softcap, float* __restrict__ part_acc,
                      float* __restrict__ part_m,
                      float* __restrict__ part_l) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / kvH;
  const int b = blockIdx.x / kvH, h = blockIdx.x - b * kvH;
  const int split = blockIdx.y;
  const int L = 1 << lanes_log2, ngrp = kThreads >> lanes_log2;
  const int tid = threadIdx.x, grp = tid >> lanes_log2, c = tid & (L - 1);
  float* q_s = smem;              // [G][dh]        q * scale
  float* m_s = q_s + G * dh;      // [ngrp][G]
  float* l_s = m_s + ngrp * G;    // [ngrp][G]
  float* a_s = l_s + ngrp * G;    // [ngrp][G][dh]

  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) *
                        dh;
  for (int i = tid; i < G * dh; i += kThreads)
    q_s[i] = to_float(qb[i]) * scale;
  __syncthreads();

  int lo = split * chunk;
  int hi = min(min(lo + chunk, S), length[b]);
  if (start != nullptr) lo = max(lo, start[b]);
  lo = max(lo, 0);

  const bool col_on = 8 * c < dh;
  float m[MAXG], l[MAXG], acc[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }
  const size_t stride = static_cast<size_t>(kvH) * dh;
  const size_t base = static_cast<size_t>(b) * S * stride +
                      static_cast<size_t>(h) * dh + 8 * c;

  // lo/hi are the block's own, so every lane runs the same iterations and
  // the group shuffles stay converged. Each group loads kUnroll keys
  // before it uses any, so that many rows are in flight, and rescales its
  // state once for them.
  for (int s0 = lo; s0 < hi; s0 += kUnroll * ngrp) {
    float kx[kUnroll][8], vx[kUnroll][8];
    bool on[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * ngrp + grp;
      on[u] = s < hi;
      if (on[u] && col_on) {
        load8(k + base + static_cast<size_t>(s) * stride, kx[u]);
        load8(v + base + static_cast<size_t>(s) * stride, vx[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kx[u][i] = vx[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          x[u] = 0.f;
          if (col_on) {
            const float* qg = q_s + g * dh + 8 * c;
#pragma unroll
            for (int i = 0; i < 8; ++i) x[u] = fmaf(qg[i], kx[u][i], x[u]);
          }
        }
        for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            x[u] += __shfl_xor_sync(0xffffffffu, x[u], off);
        }
        float mn = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (softcap > 0.f) x[u] = tanhf(x[u] / softcap) * softcap;
          if (on[u]) mn = fmaxf(mn, x[u]);
        }
        const float alpha = expf(m[g] - mn);
        float p[kUnroll], psum = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = on[u] ? expf(x[u] - mn) : 0.f;
          psum += p[u];
        }
        l[g] = l[g] * alpha + psum;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float a = acc[g][i] * alpha;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vx[u][i], a);
          acc[g][i] = a;
        }
        m[g] = mn;
      }
    }
  }

  // merge the groups' states
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (c == 0) {
        m_s[grp * G + g] = m[g];
        l_s[grp * G + g] = l[g];
      }
      if (col_on) {
        float* dst = a_s + (grp * G + g) * dh + 8 * c;
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[i] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * dh; i += kThreads) {
    const int g = i / dh, j = i - g * dh;
    float M = kNegInf;
    for (int r = 0; r < ngrp; ++r) M = fmaxf(M, m_s[r * G + g]);
    float a = 0.f, ll = 0.f;
    for (int r = 0; r < ngrp; ++r) {
      const float w = expf(m_s[r * G + g] - M);
      a = fmaf(a_s[(r * G + g) * dh + j], w, a);
      ll = fmaf(l_s[r * G + g], w, ll);
    }
    const size_t o = (static_cast<size_t>(split) * B + b) * H +
                     static_cast<size_t>(h) * G + g;
    part_acc[o * dh + j] = a;
    if (j == 0) {
      part_m[o] = M;
      part_l[o] = ll;
    }
  }
}

// Combine the n_split slices of each (b, q head) row; write the partials
// (acc, m, l) and/or the normalised acc / max(l, 1e-30).
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      int n_split, int rows, int dh,
                                      float* __restrict__ out_acc,
                                      float* __restrict__ out_m,
                                      float* __restrict__ out_l,
                                      float* __restrict__ out) {
  const int row = blockIdx.x;
  float M = kNegInf;
  for (int sp = 0; sp < n_split; ++sp)
    M = fmaxf(M, part_m[static_cast<size_t>(sp) * rows + row]);
  for (int j = threadIdx.x; j < dh; j += blockDim.x) {
    float a = 0.f, ll = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t r = static_cast<size_t>(sp) * rows + row;
      const float w = expf(part_m[r] - M);
      a = fmaf(part_acc[r * dh + j], w, a);
      ll = fmaf(part_l[r], w, ll);
    }
    const size_t o = static_cast<size_t>(row) * dh + j;
    if (out != nullptr) out[o] = a / fmaxf(ll, 1e-30f);
    if (out_acc != nullptr) {
      out_acc[o] = a;
      if (j == 0) {
        out_m[row] = M;
        out_l[row] = ll;
      }
    }
  }
}

template <typename T, int MAXG>
cudaError_t run_partial(const void* q, const void* k, const void* v,
                        const int32_t* length, const int32_t* start, int B,
                        int S, int H, int kvH, int dh, float scale,
                        float softcap, int n_split, int chunk, float* pa,
                        float* pm, float* pl, cudaStream_t st) {
  const int G = H / kvH;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < dh / 8) ++lanes_log2;
  const int ngrp = kThreads >> lanes_log2;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(G) * dh + 2 * ngrp * G +
                       static_cast<size_t>(ngrp) * G * dh);
  // raise the limit to the most any shape needs, once per instantiation,
  // so a CUDA-graph capture never calls it
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<T, MAXG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const dim3 grid(B * kvH, n_split);
  decode_partial_kernel<T, MAXG><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, start, B, S, H, kvH, dh, lanes_log2,
      chunk, scale, softcap, pa, pm, pl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int32_t* length, const int32_t* start, int B,
                     int S, int H, int kvH, int dh, float scale,
                     float softcap, int n_split, int chunk, float* pa,
                     float* pm, float* pl, cudaStream_t st) {
  const int G = H / kvH;
  if (G <= 1)
    return run_partial<T, 1>(q, k, v, length, start, B, S, H, kvH, dh, scale,
                             softcap, n_split, chunk, pa, pm, pl, st);
  if (G <= 2)
    return run_partial<T, 2>(q, k, v, length, start, B, S, H, kvH, dh, scale,
                             softcap, n_split, chunk, pa, pm, pl, st);
  if (G <= 4)
    return run_partial<T, 4>(q, k, v, length, start, B, S, H, kvH, dh, scale,
                             softcap, n_split, chunk, pa, pm, pl, st);
  return run_partial<T, 8>(q, k, v, length, start, B, S, H, kvH, dh, scale,
                           softcap, n_split, chunk, pa, pm, pl, st);
}

}  // namespace

// q (B,H,dh), k/v (B,S,kvH,dh), length/start (B,) int32 (start may be
// null); dtype 0 = float32, 1 = bfloat16; dh % 8 == 0, dh <= 256,
// H/kvH <= 8 (checked by the wrapper). Scratch part_* holds
// (n_split, B, H[, dh]) float32. Writes out_acc/out_m/out_l and/or out
// where they are not null.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* length, const void* start,
                                  int dtype, int B, int S, int H, int kvH,
                                  int dh, float scale, float softcap,
                                  int n_split, int chunk, void* part_acc,
                                  void* part_m, void* part_l, void* out_acc,
                                  void* out_m, void* out_l, void* out,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(length);
  const int32_t* sta = static_cast<const int32_t*>(start);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, len, sta, B, S, H, kvH,
                                           dh, scale, softcap, n_split, chunk,
                                           pa, pm, pl, st)
                 : dispatch<float>(q, k, v, len, sta, B, S, H, kvH, dh, scale,
                                   softcap, n_split, chunk, pa, pm, pl, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * H;
  const int threads = dh >= 256 ? 256 : ((dh + 31) / 32) * 32;
  decode_combine_kernel<<<rows, threads, 0, st>>>(
      pa, pm, pl, n_split, rows, dh, static_cast<float*>(out_acc),
      static_cast<float*>(out_m), static_cast<float*>(out_l),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
