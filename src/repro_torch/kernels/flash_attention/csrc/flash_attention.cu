// Causal online-softmax attention forward (prefill) for Hopper (sm_90a),
// GQA, optional sliding window, fused tanh logit softcap: the float32
// kernel, on the CUDA cores, and the C entry point. bfloat16 inputs go to
// the warpgroup-MMA kernel in flash_attention_wgmma.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// `_kernel` / `flash_attention`: a (B, kvH, S/tq, S/tk) grid whose KV axis
// runs in order on one core, carrying (m, l, acc) in VMEM scratch across
// grid steps, with the whole q-head group of one kv head in a block
// (a (tq, G, dh) q block against (tk, dh) K/V blocks).
//
// On the card blocks run in parallel and in no order, so the KV axis
// becomes a loop inside the block and (m, l, acc) live in registers.
// Block (tile, kvh, b) owns BR = 64 rows of the flattened
// (query position, group head) axis, row f = qpos * G + g, so one tile
// shape serves any group size G (q head kvh*G + g reads kv head kvh, as
// the TPU kernel's reshape(kvH, G, dh) does). It walks key tiles of
// BK = 64 from the first key its window admits to the last its causal
// mask admits: fully masked tiles are skipped, which is exact, since a
// tile with no valid key leaves (m, l, acc) unchanged. Tiles are taken
// heaviest first (reverse order) so the causal triangle's long rows do
// not trail the grid. Any S: ragged rows and keys are zero-filled and
// masked, with no tile-multiple assert. Without a mask (causal = 0, no
// window) k/v have a length Skv of their own, the reference's
// cross-attention: the key loop runs to Skv - 1, keys kp >= Skv are
// masked, and batch b's k/v rows start at b * Skv. With a mask Skv == S
// (checked by the wrapper).
//
// Arithmetic follows the TPU kernel exactly, all in float32: q is scaled,
// s = (q*scale).k, then tanh(s/softcap)*softcap, masked scores
// NEG_INF = -1e30 with p = 0, online max/sum, and out = acc / max(l, 1e-30).
// It runs on the CUDA cores (tensor cores would round float32 operands to
// TF32; a 3xTF32 split is ROADMAP work), so the bound is operations:
// 4*dh FLOP per valid (q head, key) pair. The design keeps both products
// register-tiled (4x4 of S and 4 x dh/16 of acc per thread) over
// transposed shared tiles (Q^T, K^T, P^T with a 68-float stride:
// conflict-free transposing stores, broadcast row reads), so the CUDA
// cores and not shared memory set the pace; a thread issues all its loads
// of a tile before its first store, so a tile costs one trip to L2, not
// one per load. The 16 threads that share a row are one half-warp, so row
// max and row sum are shuffles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 keys / columns
constexpr int BR = 64;         // rows (query position, group head) per block
constexpr int BK = 64;         // keys per tile
constexpr int LDT = 68;        // stride of the transposed tiles (BR == BK)

// Eight elements as loaded, before conversion, so a thread can have all
// its loads of a tile in flight before it uses the first.
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
};

__device__ __forceinline__ void load_raw(const float* p, Raw8<float>& r) {
  r.a = __ldg(reinterpret_cast<const float4*>(p));
  r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

__device__ __forceinline__ void zero_raw(Raw8<float>& r) {
  r.a = r.b = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void unpack(const Raw8<float>& r, float (&x)[8]) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Skv, int H, int kvH, int dh, float scale,
                       float softcap, int causal, int window) {
  constexpr int NC = DH / 64;  // float4 column chunks a thread owns
  constexpr int kLoads = BR * (DH / 8) / kThreads;  // 8-element loads a tile
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;           // [DH][LDT]  q * scale, transposed
  float* Kt = Qt + DH * LDT;  // [DH][LDT]  key tile, transposed
  float* Vs = Kt + DH * LDT;  // [BK][DH]   value tile
  float* Pt = Vs + BK * DH;   // [BK][LDT]  p tile, transposed

  const int G = H / kvH;
  const int nrows = S * G;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int f0 = tile * BR;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t kv_row = static_cast<size_t>(kvH) * dh;

  // q tile: row r of the block is flattened row f0 + r; every load of the
  // tile is issued before the first store
  {
    Raw8<T> raw[kLoads];
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx % BR, d0 = (idx / BR) * 8;
      const int f = f0 + r;
      if (f < nrows && d0 < dh) {
        const int qp = f / G, g = f - qp * G;
        load_raw(q + ((static_cast<size_t>(b) * S + qp) * H + h * G + g) * dh +
                     d0,
                 raw[it]);
      } else {
        zero_raw(raw[it]);
      }
    }
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx % BR, d0 = (idx / BR) * 8;
      float x[8];
      unpack(raw[it], x);
#pragma unroll
      for (int i = 0; i < 8; ++i) Qt[(d0 + i) * LDT + r] = x[i] * scale;
    }
  }

  float m[4], l[4], acc[4][4 * NC];
  int qpos[4];
  bool row_on[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + 4 * ty + i;
    row_on[i] = f < nrows;
    qpos[i] = row_on[i] ? f / G : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  const int last = min(f0 + BR, nrows) - 1;
  const int qlo = f0 / G, qhi = last / G;
  const int klo = window > 0 ? max(0, qlo - window + 1) : 0;
  const int khi = causal ? qhi : Skv - 1;

  for (int k0 = klo; k0 <= khi; k0 += BK) {
    __syncthreads();  // the last tile's reads are done; Qt is written
    // key tile, transposed: consecutive threads take consecutive keys.
    // All of a thread's loads are issued before its first store.
    {
      Raw8<T> raw[kLoads];
#pragma unroll
      for (int it = 0; it < kLoads; ++it) {
        const int idx = tid + it * kThreads;
        const int c = idx % BK, d0 = (idx / BK) * 8;
        const int kp = k0 + c;
        if (kp < Skv && d0 < dh)
          load_raw(k + (static_cast<size_t>(b) * Skv + kp) * kv_row +
                       static_cast<size_t>(h) * dh + d0,
                   raw[it]);
        else
          zero_raw(raw[it]);
      }
#pragma unroll
      for (int it = 0; it < kLoads; ++it) {
        const int idx = tid + it * kThreads;
        const int c = idx % BK, d0 = (idx / BK) * 8;
        float x[8];
        unpack(raw[it], x);
#pragma unroll
        for (int i = 0; i < 8; ++i) Kt[(d0 + i) * LDT + c] = x[i];
      }
    }
    // value tile, row-major: consecutive threads take consecutive columns
    {
      Raw8<T> raw[kLoads];
#pragma unroll
      for (int it = 0; it < kLoads; ++it) {
        const int idx = tid + it * kThreads;
        const int c = idx / (DH / 8), d0 = (idx % (DH / 8)) * 8;
        const int kp = k0 + c;
        if (kp < Skv && d0 < dh)
          load_raw(v + (static_cast<size_t>(b) * Skv + kp) * kv_row +
                       static_cast<size_t>(h) * dh + d0,
                   raw[it]);
        else
          zero_raw(raw[it]);
      }
#pragma unroll
      for (int it = 0; it < kLoads; ++it) {
        const int idx = tid + it * kThreads;
        const int c = idx / (DH / 8), d0 = (idx % (DH / 8)) * 8;
        float x[8];
        unpack(raw[it], x);
        store4(Vs + c * DH + d0, x[0], x[1], x[2], x[3]);
        store4(Vs + c * DH + d0 + 4, x[4], x[5], x[6], x[7]);
      }
    }
    __syncthreads();

    // s = (q*scale) . k for rows 4ty.., keys 4tx..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * LDT + 4 * ty);
      const float4 kb = *reinterpret_cast<const float4*>(Kt + d * LDT + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // softcap, mask, online softmax; the row's 16 threads are a half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned ok = 0;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * tx + j;
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool valid = row_on[i] && kp < Skv &&
                           (!causal || kp <= qpos[i]) &&
                           (window <= 0 || kp > qpos[i] - window);
        if (valid) ok |= 1u << j;
        s[i][j] = valid ? x : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mn = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (ok >> j & 1u) ? expf(s[i][j] - mn) : 0.f;
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(Pt + (4 * tx + j) * LDT + 4 * ty, s[0][j], s[1][j], s[2][j],
             s[3][j]);
    __syncthreads();

    // acc += p v for rows 4ty.., columns 4tx + 64n ..
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + c * LDT + 4 * ty);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 vb =
            *reinterpret_cast<const float4*>(Vs + c * DH + 4 * tx + 64 * n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * n + 0] = fmaf(pv[i], vb.x, acc[i][4 * n + 0]);
          acc[i][4 * n + 1] = fmaf(pv[i], vb.y, acc[i][4 * n + 1]);
          acc[i][4 * n + 2] = fmaf(pv[i], vb.z, acc[i][4 * n + 2]);
          acc[i][4 * n + 3] = fmaf(pv[i], vb.w, acc[i][4 * n + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_on[i]) continue;
    const int f = f0 + 4 * ty + i;
    const int qp = f / G, g = f - qp * G;
    T* o = out + ((static_cast<size_t>(b) * S + qp) * H + h * G + g) * dh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = 4 * tx + 64 * n;
      if (col < dh)
        store4(o + col, acc[i][4 * n] / den, acc[i][4 * n + 1] / den,
               acc[i][4 * n + 2] / den, acc[i][4 * n + 3] / den);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Skv, int H, int kvH, int dh, float scale,
                   float softcap, int causal, int window, cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * DH * LDT + BK * DH + BK * LDT);
  // set once per instantiation, so a CUDA-graph capture never calls it
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long rows = static_cast<long long>(S) * (H / kvH);
  const dim3 grid(static_cast<unsigned>((rows + BR - 1) / BR), kvH, B);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Skv, H, kvH, dh,
      scale, softcap, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int Skv, int H, int kvH, int dh,
                     float scale, float softcap, int causal, int window,
                     cudaStream_t st) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, out, B, S, Skv, H, kvH, dh, scale, softcap,
                         causal, window, st);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, out, B, S, Skv, H, kvH, dh, scale,
                          softcap, causal, window, st);
  return launch<T, 256>(q, k, v, out, B, S, Skv, H, kvH, dh, scale, softcap,
                        causal, window, st);
}

}  // namespace

// the bfloat16 kernel, flash_attention_wgmma.cu
cudaError_t flash_attention_bf16_mma(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int Skv, int H, int kvH, int dh,
                                     float scale, float softcap, int causal,
                                     int window, cudaStream_t st);

// q (B,S,H,dh), k/v (B,Skv,kvH,dh), out like q; dtype 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores); dh % 8 == 0 and dh <= 256, Skv >= 1
// and Skv == S unless causal == 0 and window == 0 (checked by the wrapper).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int B, int S, int Skv, int H, int kvH,
                                     int dh, float scale, float softcap,
                                     int causal, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? flash_attention_bf16_mma(q, k, v, out, B, S, Skv, H, kvH,
                                            dh, scale, softcap, causal, window,
                                            st)
                 : dispatch<float>(q, k, v, out, B, S, Skv, H, kvH, dh, scale,
                                   softcap, causal, window, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
