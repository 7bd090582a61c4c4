// Causal online-softmax attention forward (prefill) for Hopper (sm_90a),
// bfloat16 q/k/v on the tensor cores: GQA, optional sliding window, fused
// tanh logit softcap. float32 inputs take the CUDA-core kernel in
// flash_attention.cu; repro_flash_attention dispatches by dtype.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// `_kernel` / `flash_attention` (its (B, kvH, S/tq, S/tk) grid walks the
// KV tiles in order on one core with (m, l, acc) in VMEM scratch). Here
// the KV axis is a loop inside the block and (m, l, acc) live in
// registers. Block (tile, kvh, b) owns BR = 128 rows of the flattened
// (query position, group head) axis, row f = qpos * G + g, so one tile
// shape serves any group size G (q head kvh*G + g reads kv head kvh); warp
// w owns rows 16w..16w+15 and all dh output columns. Key tiles (48 keys at
// dh = 256, 64 below) run from the first key the window admits to the last
// the causal mask admits; row tiles are taken heaviest first. Any S:
// ragged rows and keys are zero-filled and masked. Without a mask (causal
// = 0, no window) k/v may have a length Skv of their own, the reference's
// cross-attention: the key loop ends at Skv - 1, keys kp >= Skv are
// masked (the edge test), and batch b's k/v rows start at b * Skv. With
// a mask Skv == S (checked by the wrapper). One instance a head width
// serves both cases.
//
// Bound: operations, 4*dh FLOP per valid (q head, key) pair at the bf16
// tensor-core rate. The TPU kernel's arithmetic is float32; on bf16 inputs
// the design keeps it float32-grade on bf16 tensor cores:
// - S = q.k^T by mma.sync m16n8k16 bf16 with float32 accumulators: a
//   bf16 x bf16 product is exact in float32, so this is the float32 einsum
//   up to the order of the sums. The scale is applied to the float32 sum
//   (exact for a power-of-two scale such as gemma2's 1/16), then the
//   softcap with accurate tanhf; the mask and the online max and sum stay
//   float32, in base 2 (log2(e) folded into the scale: the same softmax).
// - P.V without rounding p to bf16: p = p_hi + p_lo, two bf16 terms
//   (p_lo = bf16(p - p_hi)), each multiplied with the exact bf16 V and
//   accumulated in float32, so p keeps about 2^-17 relative error. The
//   accumulator layout of m16n8k16 is its A-operand layout, so p goes from
//   registers straight into the second product. Work: 1.5x the bound's
//   FLOP (2*dh for QK^T, 2*2*dh for P.V a pair).
// - Operands come from shared memory kept in bf16 by ldmatrix (.trans for
//   V), rows padded by 16 bytes so the 8 row addresses of each 8x8 matrix
//   fall in 8 distinct bank groups. K/V tiles arrive by cp.async into a
//   two-stage ring: tile t+1 loads while tile t is computed on. At
//   dh = 256: Q 128 x 528 B + 2 stages x (K, V) 48 x 528 B = 165 KB of
//   shared memory, 255 registers a thread and no spills (the float32
//   accumulator alone is 128; 64-key tiles spill), one block of 8 warps
//   on each SM.
// - Only tiles that straddle the causal diagonal, the window's edge or
//   the sequence end evaluate the mask; interior tiles skip it, through
//   compile-time variants of the score loop that keep it free of branches.
// Masked scores get p = 0 (the TPU kernel's -1e30 masking), a row with no
// valid key gives 0, out = acc / max(l, 1e-30) rounded to bf16. No
// atomics and a fixed order of summation, so runs are bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BR = 16 * kWarps;  // flattened rows per block, 16 a warp
constexpr int NSTAGE = 2;        // K/V tiles in the ring
constexpr int kPad = 8;          // bf16 elements of padding a shared row

// keys a tile: a multiple of 16 (the MMA's k) and of the copy's rows a
// pass (kThreads / (DH / 8)); at dh = 256 the score tile is kept small
// enough that the 128-register accumulator fits without spills
template <int DH>
__host__ __device__ constexpr int key_tile() {
  return DH > 128 ? 48 : 64;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(DH + kPad) *
         (BR + 2 * NSTAGE * key_tile<DH>());
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-fills when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) -> bf16 pairs hi = bf16(x, y), lo = bf16((x, y) - hi); x in the
// low half, as the A operand takes two neighbouring columns
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// 2^x (MUFU.EX2, about 2 ulp); 2^-inf = 0, results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// what an edge tile needs to mask: key of column 2*t4 of n-tile 0, the
// thread's two query positions, and the masking rule
struct Edge {
  int kp0, qp0, qp1, Skv, causal, window;
};

// score tile -> base-2 scores (x = s*c1, or tanh(s*c1)*c2 with CAP),
// masked to -inf where MASK says so, and each row's max over the thread's
// columns. Compile-time flags keep the element loop free of branches.
template <bool CAP, bool MASK, int NS>
__device__ __forceinline__ void scores(float (&s)[NS][4], float c1, float c2,
                                       const Edge& edge, float& mx0,
                                       float& mx1) {
  mx0 = mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * c1;
      if (CAP) x = tanhf(x) * c2;
      if (MASK) {
        const int kp = edge.kp0 + j * 8 + (e & 1);
        const int qp = e < 2 ? edge.qp0 : edge.qp1;
        if (kp >= edge.Skv || (edge.causal && kp > qp) ||
            (edge.window > 0 && kp <= qp - edge.window))
          x = -CUDART_INF_F;
      }
      s[j][e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int S, int H,
                           int kvH, int dh, float scale, float softcap,
                           int causal, int window, int Skv) {
  constexpr int BK = key_tile<DH>();
  constexpr int LD = DH + kPad;  // shared row stride, elements
  constexpr int NCH = DH / 8;    // 16-byte chunks a row
  constexpr int NS = BK / 8;     // n8 tiles of a score row
  constexpr int NO = DH / 8;     // n8 tiles of an output row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BR][LD]
  __nv_bfloat16* KVs = Qs + BR * LD;    // [NSTAGE][K, V][BK][LD]

  const int G = H / kvH;
  const int nrows = S * G;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int f0 = tile * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t kv_row = static_cast<size_t>(kvH) * dh;
  const __nv_bfloat16* kb =
      k + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(h) * dh;
  const __nv_bfloat16* vb =
      v + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(h) * dh;

  const int last = min(f0 + BR, nrows) - 1;
  const int qlo = f0 / G, qhi = last / G;
  const int klo = window > 0 ? max(0, qlo - window + 1) : 0;
  const int khi = causal ? qhi : Skv - 1;
  const int ntiles = (khi - klo) / BK + 1;

  // q tile: row r of the block is flattened row f0 + r
#pragma unroll
  for (int it = 0; it < BR * NCH / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / NCH, c = idx % NCH;
    const int f = f0 + r;
    const bool ok = f < nrows && c * 8 < dh;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int qp = f / G, g = f - qp * G;
      src = q + ((static_cast<size_t>(b) * S + qp) * H + h * G + g) * dh +
            c * 8;
    }
    cp_async16(smem_u32(Qs + r * LD + c * 8), src, ok);
  }
  // key tile from key k0 into ring stage `stage`: this thread copies
  // column chunk c0 of rows r0 + RSTEP * it
  constexpr int RSTEP = kThreads / NCH;
  const int r0 = tid / NCH, c0 = (tid % NCH) * 8;
  auto load_kv = [&](int stage, int k0) {
    const uint32_t kdst = smem_u32(KVs + (stage * 2 * BK + r0) * LD + c0);
    // opaque here, so the compiler computes the passes' offsets in place
    // rather than keeping them live (and spilled) across the loop
    size_t step = RSTEP * kv_row;
    asm volatile("" : "+l"(step));
    const size_t off0 = static_cast<size_t>(k0 + r0) * kv_row + c0;
#pragma unroll
    for (int it = 0; it < BK / RSTEP; ++it) {
      const bool ok = k0 + r0 + it * RSTEP < Skv && c0 < dh;
      const size_t off = ok ? off0 + it * step : 0;
      const uint32_t dst = kdst + it * RSTEP * LD * 2;
      cp_async16(dst, kb + off, ok);
      cp_async16(dst + BK * LD * 2, vb + off, ok);
    }
  };
  // one commit group a tile, the q tile with tile 0
#pragma unroll
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < ntiles) load_kv(p, klo + p * BK);
    cp_async_commit();
  }

  // this thread's rows of the accumulator layout: g4 and g4 + 8 of the warp
  const int g4 = lane >> 2, t4 = lane & 3;
  const int qp0 = (f0 + warp * 16 + g4) / G;
  const int qp1 = (f0 + warp * 16 + g4 + 8) / G;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // scores in base 2: x = s*scale*log2e, or tanh(s*scale/cap)*cap*log2e
  const float c1 = softcap > 0.f ? scale / softcap : scale * kLog2e;
  const float c2 = softcap * kLog2e;

  // ldmatrix row addresses of this lane: A from Q (rows 0-15, columns
  // 0/8), B from K (keys 0-7/8-15, columns 0/8), B from V transposed
  const uint32_t q_addr =
      smem_u32(Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = klo + t * BK;
    // tile t + NSTAGE - 1 goes into the stage tile t - 1 was read from
    if (t + NSTAGE - 1 < ntiles)
      load_kv((t + NSTAGE - 1) % NSTAGE, k0 + (NSTAGE - 1) * BK);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();  // tile t (and the q tile) have landed for all threads
    const __nv_bfloat16* Ks = KVs + (t % NSTAGE) * 2 * BK * LD;
    const uint32_t k_addr = smem_u32(Ks + k_off);
    const uint32_t v_addr = smem_u32(Ks + BK * LD + v_off);

    // s = q . k^T: 16 rows x BK keys a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + ks * 32);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, k_addr + (np * 16 * LD + ks * 16) * 2);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, mask (edge tiles only), online softmax; the 4
    // threads of a quad share a row
    const bool interior = k0 + BK - 1 < Skv &&
                          (!causal || k0 + BK - 1 <= qlo) &&
                          (window <= 0 || k0 > qhi - window);
    float mx0, mx1;
    const Edge edge{k0 + 2 * t4, qp0, qp1, Skv, causal, window};
    if (softcap > 0.f) {
      if (interior) scores<true, false>(s, c1, c2, edge, mx0, mx1);
      else scores<true, true>(s, c1, c2, edge, mx0, mx1);
    } else {
      if (interior) scores<false, false>(s, c1, c2, edge, mx0, mx1);
      else scores<false, true>(s, c1, c2, edge, mx0, mx1);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = ex2(s[j][0] - mn0);
      s[j][1] = ex2(s[j][1] - mn0);
      s[j][2] = ex2(s[j][2] - mn1);
      s[j][3] = ex2(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    // l holds this thread's columns only (alpha is the same across the
    // quad); the quad's partial sums are added once, after the loop
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    // rescale only when some row's max moved (multiplying by 1 is exact)
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }
    }

    // acc += p_hi . v + p_lo . v, 16 keys at a time
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < DH / 16; ++dn) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_addr + (kc * 16 * LD + dn * 16) * 2);
        mma_bf16(acc[2 * dn], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * dn], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage t is read; the next copy may overwrite it
  }

  // out = acc / max(l, 1e-30) in bf16, staged through the warp's own q
  // rows (no other warp reads them) for 16-byte stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(Os + g4 * LD + col) =
        __floats2bfloat162_rn(acc[n][0] / d0, acc[n][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(Os + (g4 + 8) * LD + col) =
        __floats2bfloat162_rn(acc[n][2] / d1, acc[n][3] / d1);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * NCH / 32; ++it) {
    const int idx = lane + it * 32;
    const int r = idx / NCH, c = idx % NCH;
    const int f = f0 + warp * 16 + r;
    if (f < nrows && c * 8 < dh) {
      const int qp = f / G, g = f - qp * G;
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(b) * S + qp) * H + h * G + g) * dh +
          c * 8) = *reinterpret_cast<const uint4*>(Os + r * LD + c * 8);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Skv, int H, int kvH, int dh, float scale,
                   float softcap, int causal, int window, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DH>();
  // set once per instantiation, so a CUDA-graph capture never calls it
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long rows = static_cast<long long>(S) * (H / kvH);
  const dim3 grid(static_cast<unsigned>((rows + BR - 1) / BR), kvH, B);
  flash_attention_mma_kernel<DH><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, H, kvH, dh, scale, softcap, causal, window, Skv);
  return cudaGetLastError();
}

}  // namespace

// bfloat16 q (B,S,H,dh), k/v (B,Skv,kvH,dh), out like q; dh % 8 == 0 and
// dh <= 256, Skv == S unless there is no mask (checked by the wrapper).
// Called by repro_flash_attention.
cudaError_t flash_attention_bf16_mma(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int Skv, int H, int kvH, int dh,
                                     float scale, float softcap, int causal,
                                     int window, cudaStream_t st) {
  if (dh <= 64)
    return launch<64>(q, k, v, out, B, S, Skv, H, kvH, dh, scale, softcap,
                      causal, window, st);
  if (dh <= 128)
    return launch<128>(q, k, v, out, B, S, Skv, H, kvH, dh, scale, softcap,
                       causal, window, st);
  return launch<256>(q, k, v, out, B, S, Skv, H, kvH, dh, scale, softcap,
                     causal, window, st);
}
