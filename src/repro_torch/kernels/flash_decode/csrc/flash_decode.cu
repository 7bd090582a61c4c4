// Single-token attention over a KV cache (decode) for Hopper (sm_90a),
// on the CUDA cores: (acc, m, l) partials, or the normalised output, over
// the valid positions start <= pos < length, GQA, tanh logit softcap.
// It takes float32 q/k/v, and bfloat16 where a kv head has one q head (G
// = 1, multi-head attention: seamless-m4t-medium's self and cross caches).
// Every other bfloat16 call takes the tensor-core kernel in
// flash_decode_mma.cu; repro_flash_decode dispatches by the wrapper's
// plan (warps 0 = this kernel). G = 1 stays here by a fixed rule: the
// tensor-core kernel spends 15 of its MMA's 16 rows on nothing there, and
// on the card it ran seamless's cross caches 12-13 % and its decode loop's
// cache 14-16 % slower than this kernel in the same run
// (tools/decode_ab.py), where G = 2 and up ran faster.
//
// Replaces the TPU kernel repro/kernels/flash_decode/flash_decode.py
// `_kernel` / `flash_decode`: a (kvH, S/ts) grid, one batch element per
// call (JAX vmaps it), walking the cache tiles in order on one core with
// (m, l, acc) in VMEM scratch, the kv head's whole q-head group in the
// block, and emitting the UNNORMALIZED (acc, m, l) so that shards of a
// cache combine.
//
// Bound: bytes, the valid K/V rows read once. Its design:
//   - one launch. Block ((b*kvH + h)*slices + slice, split) owns one kv
//     head's G query heads (all of them, or one slice: see below) over
//     the split-th equal part of the element's own valid
//     range [start_b, length_b), computed here from length/start; the
//     number of splits is a function of the shapes only (the wrapper's
//     plan), so a CUDA graph replays it. With one split the block
//     writes the partials or acc / max(l, 1e-30) itself. With more, each
//     block writes its partials, and the last block of its (b, kv head)
//     to finish -- known from an integer ticket, which it resets for the
//     next launch -- combines the splits in split order 0..n-1. Which
//     block is last changes nothing in the result.
//   - inside the block, groups of L lanes (L = dh/8 rounded up to a power
//     of two; 32 at dh = 256) each take 8 keys at a time in bfloat16 (4 in
//     float32), every lane 8 columns of each, loaded raw (16 bytes a lane
//     for bfloat16, 32 for float32), so that 8 (4) rows are in flight per
//     group. The first round's loads are issued
//     before q is staged, and q sits in registers (up to 4 heads a
//     group); wider groups read it from shared memory once a key, laid
//     out [head][i][lane] so that a group's lanes hit consecutive banks
//     (as [head][dh] the 8 columns of lanes c and c + 4 share banks). The
//     dot products are finished by shuffles inside the group; each group
//     keeps its own running (m, l, acc), merged once in shared memory
//     with weights computed once per (group, head). Where a group has a
//     lane for each of a round's G x 4 scores, their softcap and
//     exponentials are spread one a lane, so they cost one tanh and one
//     exp a lane.
//   - more than 8 q heads a kv head are cut into head slices of at most 8
//     (`head_slices`), a block each: the block's running (m, l, acc) then
//     fit in registers (8 heads x 8 columns a lane).
// Positions outside [start, length) are never read, which is exact: a
// masked key leaves (m, l, acc) unchanged. Any S; with no valid position
// m = -1e30, l = 0, acc = 0 and the normalised output is 0, as the
// reference's finalize gives.
//
// Arithmetic is float32, as on the TPU: q is cast and then scaled,
// s = (q*scale).k, then tanh(s/softcap)*softcap, online max and sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
// the most shared memory a shape the wrapper admits needs (MAXG = 8,
// dh = 8: 256 one-lane groups), under the card's 227 KB a block
constexpr int kMaxSmem = 96 * 1024;

// 8 consecutive elements of a row, as loaded: one 16-byte word for
// bfloat16, two for float32
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void clear() { w = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_float(float (&x)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void clear() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void to_float(float (&x)[8]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int KU>
__device__ __forceinline__ void load_round(const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           size_t base, size_t stride, int s0,
                                           int ngrp, int grp, int hi,
                                           bool col_on, Raw<T> (&kr)[KU],
                                           Raw<T> (&vr)[KU]) {
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const int s = s0 + u * ngrp + grp;
    if (s < hi && col_on) {
      kr[u].load(k + base + static_cast<size_t>(s) * stride);
      vr[u].load(v + base + static_cast<size_t>(s) * stride);
    } else {
      kr[u].clear();
      vr[u].clear();
    }
  }
}

// Write row o's results: the partials where out_acc is given, the
// normalised acc / max(l, 1e-30) where out is.
__device__ __forceinline__ void emit(size_t o, int j, int dh, float a,
                                     float M, float L,
                                     float* __restrict__ out_acc,
                                     float* __restrict__ out_m,
                                     float* __restrict__ out_l,
                                     float* __restrict__ out) {
  if (out != nullptr) out[o * dh + j] = a / fmaxf(L, 1e-30f);
  if (out_acc != nullptr) {
    out_acc[o * dh + j] = a;
    if (j == 0) {
      out_m[o] = M;
      out_l[o] = L;
    }
  }
}

template <typename T, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ length,
              const int32_t* __restrict__ start, int B, int S, int H,
              int kvH, int dh, int lanes_log2, int slices, int n_split,
              float scale,
              float softcap, float* __restrict__ part_acc,
              float* __restrict__ part_m, float* __restrict__ part_l,
              int32_t* __restrict__ tickets, float* __restrict__ out_acc,
              float* __restrict__ out_m, float* __restrict__ out_l,
              float* __restrict__ out) {
  // keys a lane group has in flight (its raw K and V rows in registers)
  constexpr int KU = sizeof(T) == 2 ? 8 : 4;
  extern __shared__ __align__(16) float smem[];
  // block x = (b, kv head h, head slice): G = the slice's q heads, the
  // q rows b*H + hb*G .. + G - 1, hb = h * slices + slice
  const int G = H / (kvH * slices);
  const int b = blockIdx.x / (kvH * slices);
  const int hb = blockIdx.x - b * kvH * slices, h = hb / slices;
  const int split = blockIdx.y;
  const int L = 1 << lanes_log2, ngrp = kThreads >> lanes_log2;
  const int tid = threadIdx.x, grp = tid >> lanes_log2, c = tid & (L - 1);
  // q * scale, element 8c + i of head g at [g][i][c]
  float* q_s = smem;              // [G][8][L]
  float* m_s = q_s + G * 8 * L;   // [ngrp][G]
  float* l_s = m_s + ngrp * G;    // [ngrp][G]
  float* w_s = l_s + ngrp * G;    // [ngrp][G]      merge weights
  float* ml_s = w_s + ngrp * G;   // [2][G]         merged m, l
  float* a_s = ml_s + 2 * G;      // [ngrp][G][dh]
  __shared__ int last_s;

  // this split's part of the element's own valid range
  const int hi_b = min(length[b], S);
  const int lo_b = start != nullptr ? max(start[b], 0) : 0;
  const int n = max(hi_b - lo_b, 0);
  const int chunk = (n + n_split - 1) / n_split;
  const int lo = lo_b + min(split * chunk, n);
  const int hi = lo_b + min((split + 1) * chunk, n);

  const bool col_on = 8 * c < dh;
  const size_t stride = static_cast<size_t>(kvH) * dh;
  const size_t base = static_cast<size_t>(b) * S * stride +
                      static_cast<size_t>(h) * dh + 8 * c;
  const int step = KU * ngrp;
  Raw<T> kr[KU], vr[KU];
  load_round<T, KU>(k, v, base, stride, lo, ngrp, grp, hi, col_on, kr, vr);

  const size_t row0 =
      static_cast<size_t>(b) * H + static_cast<size_t>(hb) * G;
  const T* qb = q + row0 * dh;
  for (int i = tid; i < G * dh; i += kThreads) {
    const int g = i / dh, j = i - g * dh;
    q_s[(g * 8 + (j & 7)) * L + (j >> 3)] = to_float(qb[i]) * scale;
  }
  __syncthreads();

  // q in registers for up to 4 heads a group (read once, not once a
  // key from shared memory)
  constexpr bool kQReg = MAXG <= 4;
  float qr[kQReg ? MAXG : 1][8];
  if constexpr (kQReg) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qr[g][i] = (g < G && col_on) ? q_s[(g * 8 + i) * L + c] : 0.f;
  }

  float m[MAXG], l[MAXG], acc[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  // lo/hi are the block's own, so every lane runs the same rounds and the
  // group shuffles stay converged
  for (int s0 = lo; s0 < hi; s0 += step) {
    float x[MAXG][KU];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      float kx[8];
      kr[u].to_float(kx);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float d = 0.f;
        if (g < G && col_on) {
          if constexpr (kQReg) {
#pragma unroll
            for (int i = 0; i < 8; ++i) d = fmaf(qr[g][i], kx[i], d);
          } else {
            const float* qg = q_s + g * 8 * L + c;
#pragma unroll
            for (int i = 0; i < 8; ++i) d = fmaf(qg[i * L], kx[i], d);
          }
        }
        x[g][u] = d;
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int u = 0; u < KU; ++u)
          if (g < G) x[g][u] += __shfl_xor_sync(0xffffffffu, x[g][u], off);
    }
    bool on[KU];
#pragma unroll
    for (int u = 0; u < KU; ++u) on[u] = s0 + u * ngrp + grp < hi;
    if (G * KU <= L) {
      // one (head, key) score a lane: the softcap and exp once, not once
      // a lane; x becomes p = exp(x - m), broadcast back to the group
      const int pg = c / KU, pu = c - pg * KU;
      float y = 0.f;
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int u = 0; u < KU; ++u)
          if (g * KU + u == c) y = x[g][u];
      const bool pon = c < G * KU && s0 + pu * ngrp + grp < hi;
      if (softcap > 0.f) y = tanhf(y / softcap) * softcap;
      float ym = pon ? y : kNegInf;
      for (int o = 1; o < KU; o <<= 1)
        ym = fmaxf(ym, __shfl_xor_sync(0xffffffffu, ym, o, L));
      float mn[MAXG];
      float my_mn = kNegInf;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        mn[g] = kNegInf;
        if (g < G) {
          mn[g] = fmaxf(m[g], __shfl_sync(0xffffffffu, ym, g * KU, L));
          if (g == pg) my_mn = mn[g];
        }
      }
      const float p = pon ? expf(y - my_mn) : 0.f;
      float ps = p;
      for (int o = 1; o < KU; o <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o, L);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float alpha = expf(m[g] - mn[g]);
          l[g] = l[g] * alpha + __shfl_sync(0xffffffffu, ps, g * KU, L);
          m[g] = mn[g];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
#pragma unroll
          for (int u = 0; u < KU; ++u)
            x[g][u] = __shfl_sync(0xffffffffu, p, g * KU + u, L);
        }
      }
    } else {
      // x becomes p = exp(x - m) in place, every lane for every score
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          float mn = m[g];
#pragma unroll
          for (int u = 0; u < KU; ++u) {
            if (softcap > 0.f) x[g][u] = tanhf(x[g][u] / softcap) * softcap;
            if (on[u]) mn = fmaxf(mn, x[g][u]);
          }
          const float alpha = expf(m[g] - mn);
          float psum = 0.f;
#pragma unroll
          for (int u = 0; u < KU; ++u) {
            x[g][u] = on[u] ? expf(x[g][u] - mn) : 0.f;
            psum += x[g][u];
          }
          l[g] = l[g] * alpha + psum;
          m[g] = mn;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      float vx[8];
      vr[u].to_float(vx);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][i] = fmaf(x[g][u], vx[i], acc[g][i]);
        }
    }
    if (s0 + step < hi)
      load_round<T, KU>(k, v, base, stride, s0 + step, ngrp, grp, hi, col_on,
                        kr, vr);
  }

  // merge the groups' states: weights once per (group, head)
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
  // a thread a (group, head) weight, then l summed in group order
  for (int t = tid; t < ngrp * G; t += kThreads) {
    const int g = t % G;
    float M = kNegInf;
    for (int r = 0; r < ngrp; ++r) M = fmaxf(M, m_s[r * G + g]);
    w_s[t] = expf(m_s[t] - M);
    if (t < G) ml_s[t] = M;
  }
  __syncthreads();
  if (tid < G) {
    float ll = 0.f;
    for (int r = 0; r < ngrp; ++r)
      ll = fmaf(l_s[r * G + tid], w_s[r * G + tid], ll);
    ml_s[G + tid] = ll;
  }
  __syncthreads();
  const int rows = B * H;
  for (int i = tid; i < G * dh; i += kThreads) {
    const int g = i / dh, j = i - g * dh;
    float a = 0.f;
    for (int r = 0; r < ngrp; ++r)
      a = fmaf(a_s[(r * G + g) * dh + j], w_s[r * G + g], a);
    if (n_split == 1) {
      emit(row0 + g, j, dh, a, ml_s[g], ml_s[G + g], out_acc, out_m, out_l,
           out);
    } else {
      const size_t o = static_cast<size_t>(split) * rows + row0 + g;
      part_acc[o * dh + j] = a;
      if (j == 0) {
        part_m[o] = ml_s[g];
        part_l[o] = ml_s[G + g];
      }
    }
  }
  if (n_split == 1) return;

  // the last block of this (b, kv head, slice) to finish combines the
  // splits
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(tickets + blockIdx.x, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int i = tid; i < G * dh; i += kThreads) {
    const int g = i / dh, j = i - g * dh;
    const size_t row = row0 + g;
    float M = kNegInf;
    for (int sp = 0; sp < n_split; ++sp)
      M = fmaxf(M, __ldcg(part_m + static_cast<size_t>(sp) * rows + row));
    float a = 0.f, ll = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t r = static_cast<size_t>(sp) * rows + row;
      const float w = expf(__ldcg(part_m + r) - M);
      a = fmaf(__ldcg(part_acc + r * dh + j), w, a);
      ll = fmaf(__ldcg(part_l + r), w, ll);
    }
    emit(row, j, dh, a, M, ll, out_acc, out_m, out_l, out);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

template <typename T, int MAXG>
cudaError_t run(const void* q, const void* k, const void* v,
                const int32_t* length, const int32_t* start, int B, int S,
                int H, int kvH, int dh, int slices, float scale,
                float softcap, int n_split, float* pa, float* pm, float* pl,
                int32_t* tickets, float* oa, float* om, float* ol, float* out,
                cudaStream_t st) {
  const int G = H / (kvH * slices);
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < dh / 8) ++lanes_log2;
  const int ngrp = kThreads >> lanes_log2;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(G) * 8 * (1 << lanes_log2) +
                       3 * ngrp * G + 2 * G +
                       static_cast<size_t>(ngrp) * G * dh);
  // raise the limit to the most any shape needs, once per instantiation,
  // so a CUDA-graph capture never calls it
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, MAXG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const dim3 grid(B * kvH * slices, n_split);
  decode_kernel<T, MAXG><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, start, B, S, H, kvH, dh, lanes_log2,
      slices, n_split, scale, softcap, pa, pm, pl, tickets, oa, om, ol, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int32_t* length, const int32_t* start, int B,
                     int S, int H, int kvH, int dh, int slices, float scale,
                     float softcap, int n_split, float* pa, float* pm,
                     float* pl, int32_t* tickets, float* oa, float* om,
                     float* ol, float* out, cudaStream_t st) {
  if (slices < 1 || H % (kvH * slices)) return cudaErrorInvalidValue;
  const int G = H / (kvH * slices);
  if (G > 8 || (sizeof(T) == 2 && G != 1)) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    return run<T, 1>(q, k, v, length, start, B, S, H, kvH, dh, slices, scale,
                     softcap, n_split, pa, pm, pl, tickets, oa, om, ol, out,
                     st);
  } else {
#define REPRO_DECODE_RUN(MAXG)                                               \
  return run<T, MAXG>(q, k, v, length, start, B, S, H, kvH, dh, slices,      \
                      scale, softcap, n_split, pa, pm, pl, tickets, oa, om,  \
                      ol, out, st)
    if (G <= 1) REPRO_DECODE_RUN(1);
    if (G <= 2) REPRO_DECODE_RUN(2);
    if (G <= 4) REPRO_DECODE_RUN(4);
    REPRO_DECODE_RUN(8);
#undef REPRO_DECODE_RUN
  }
}

}  // namespace

// the tensor-core kernel (bfloat16 at G >= 2), flash_decode_mma.cu
cudaError_t flash_decode_bf16_mma(const void* q, const void* k, const void* v,
                                  const int32_t* length, const int32_t* start,
                                  int B, int S, int H, int kvH, int dh,
                                  int slices, int warps, float scale,
                                  float softcap, int n_split, float* pa,
                                  float* pm, float* pl, int32_t* tickets,
                                  float* oa, float* om, float* ol, float* out,
                                  cudaStream_t st);

// q (B,H,dh), k/v (B,S,kvH,dh), length/start (B,) int32 (start may be
// null); dtype 0 = float32, 1 = bfloat16; warps 0 = this kernel (float32,
// or bfloat16 at G = 1), 2 or 4 = the tensor-core kernel's warps a block
// (bfloat16); dh % 8 == 0, dh <= 256; head_slices blocks a kv head's q
// heads (here equal slices of at most 8 heads; on the tensor cores of its
// ceil(G/16) row tiles), checked by the wrapper. With n_split > 1: scratch part_* holds (n_split,
// B, H[, dh]) float32 and tickets (B*kvH*head_slices,) int32 zeros, which
// every launch leaves zero again. Writes out_acc/out_m/out_l and/or out
// where they are not null, in one launch.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* length, const void* start,
                                  int dtype, int B, int S, int H, int kvH,
                                  int dh, int head_slices, int warps,
                                  float scale, float softcap, int n_split,
                                  void* part_acc, void* part_m, void* part_l,
                                  void* tickets, void* out_acc, void* out_m,
                                  void* out_l, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(length);
  const int32_t* sta = static_cast<const int32_t*>(start);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  int32_t* tk = static_cast<int32_t*>(tickets);
  float* oa = static_cast<float*>(out_acc);
  float* om = static_cast<float*>(out_m);
  float* ol = static_cast<float*>(out_l);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (dtype == 1 && warps > 0)
    err = flash_decode_bf16_mma(q, k, v, len, sta, B, S, H, kvH, dh,
                                head_slices, warps, scale, softcap, n_split,
                                pa, pm, pl, tk, oa, om, ol, o, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, len, sta, B, S, H, kvH, dh,
                                  head_slices, scale, softcap, n_split, pa,
                                  pm, pl, tk, oa, om, ol, o, st);
  else
    err = dispatch<float>(q, k, v, len, sta, B, S, H, kvH, dh, head_slices,
                          scale, softcap, n_split, pa, pm, pl, tk, oa, om,
                          ol, o, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
