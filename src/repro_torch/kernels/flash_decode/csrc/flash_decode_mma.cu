// Single-token attention over a KV cache (decode) for Hopper (sm_90a),
// bfloat16 q/k/v on the tensor cores: (acc, m, l) partials, or the
// normalised output, over the valid positions start <= pos < length,
// GQA, tanh logit softcap. float32 inputs, and bfloat16 where a kv head
// has one q head (G = 1: 15 of the MMA's 16 rows would be empty), take
// the CUDA-core kernel in flash_decode.cu; repro_flash_decode dispatches
// by the wrapper's plan.
//
// Replaces the TPU kernel repro/kernels/flash_decode/flash_decode.py:29
// `_kernel` / :67 `flash_decode`: a (kvH, S/ts) grid, one batch element
// per call, walking the cache tiles in order with (m, l, acc) in VMEM
// scratch and the kv head's whole q-head group in the block, emitting the
// UNNORMALIZED (acc, m, l) so that shards of a cache combine.
//
// Bound: bytes, the valid K/V rows read once. The kv head's G q heads all
// read the same K/V row, and a decode kernel that reads each row once has
// at most 16 of them to apply to it: one m16n8k16 A tile. So the work a
// (key, q head) pair does leaves the lanes for the tensor cores. What the
// CUDA-core design (the bf16 instance of flash_decode.cu until it was
// replaced) paid at G >= 8, and what this design does about it:
//   - G x 8 FMAs a lane a key for q.k and as many for p.v: here S = q.k^T
//     and acc += P.V are mma.sync m16n8k16 products with float32
//     accumulators, the heads the A tile's 16 rows (rows past G are zero
//     and never stored).
//   - log2(L) shuffles to finish each score: a score comes out of the
//     accumulator whole; a tile's row max and row sum take 2 quad
//     shuffles each.
//   - q read from shared memory 8 times a head a key above 4 heads: q's
//     A fragments sit in registers for dh <= 128; at dh = 256 (where the
//     16 x 256 float32 accumulator is 128 registers a thread) they are
//     read by one ldmatrix a 16-column step a tile.
//   - keys in flight falling from 8 to 4 above 4 heads: the bytes in
//     flight do not depend on G. Each key group of warps streams tiles of
//     16 KB of K and V (4096 / dh keys: 64 at dh 64, 32 at 128, 16 at
//     256) by cp.async through a 2-stage ring of its own in shared
//     memory. (Tiles of 16 keys at every width gave dh 64 4 KB a tile:
//     too few bytes in flight.)
//   - G = 16 cut into two head slices that read the same K/V twice: the
//     whole group is in one block. A group wider than 16 takes ceil(G/16)
//     row tiles, one warp each, over the same K/V tiles in shared memory
//     (the warps of a key group share its ring and a named barrier), so
//     the cache is read once; only a group of more than 64 heads is cut
//     into blocks (`slices`).
//   - 64 blocks for recurrentgemma-9b's (8, 2048, 1, 256) window: the
//     wrapper's split plan now cuts by bytes and gives every shape of the
//     served models at least one block a multiprocessor.
// A block is 4 warps (one block a multiprocessor, by its ~140 KB ring)
// where the grid holds about one block a multiprocessor: the decode
// loops' caches, recurrentgemma's window. On larger grids it is 2 warps
// (~70 KB, three blocks a multiprocessor), so that a block's prologue (the
// lengths, q and its first tiles: two round trips) and epilogue (the
// merge, the partials, the ticket) hide behind the other blocks' loads;
// with one block a multiprocessor the SM idles through them, and the
// blocks of a grid of many splits spend half their lives there.
// Layout: block ((b*kvH + h)*slices + z, split) owns row tiles z*rtb ..
// of kv head h of element b over the split-th equal part of the element's
// own valid range [start_b, length_b); the split count and warps are a
// function of the shapes only (the wrapper's plan), so a CUDA graph
// replays a launch. Warp w takes row tile w % rtb and is in key group
// w / rtb; the key groups take the range's tiles round-robin, each with
// its own running (m, l, acc), merged once in shared memory in key-group
// order. With one split the block writes the partials or acc / max(l,
// 1e-30) itself; with more, each block writes its partials and the last
// block of its column to finish (an integer ticket, reset for the next
// launch) combines the splits in split order 0..n-1, so which block is
// last changes no bit. The epilogue and the combine index outputs as
// head * DH/4 + float4 column, never dividing by a runtime width, and the
// combine keeps 32 loads in flight a thread: a block's epilogue runs once,
// and its latency, not its work, is what it costs. Positions outside
// [start, length) are never read; only the tile that straddles the
// split's end is masked. A head width that 16 does not divide (e.g. 72)
// is zero-padded to the instance's width (64, 128 or 256) in shared
// memory.
//
// Arithmetic: float32-grade on bf16 tensor cores, as in
// flash_attention_wgmma.cu. A bf16 x bf16 product is exact in float32, so
// S is the float32 einsum up to the order of its sums; the scale is
// applied to the float32 sum, then the softcap (tanhf); the online max and
// sum are float32 in base 2 (log2(e) folded into the scale; m is returned
// in natural units). p is not rounded to bf16: p = p_hi + p_mid + p_lo,
// three bf16 terms, each multiplied by the exact bf16 V straight from the
// accumulator layout (the A layout), so p keeps about 2^-26 relative
// error. Two terms (2^-17, the prefill kernel's split) are not enough
// here: the partials' acc is a sum of thousands of p*v held to atol
// 1e-5 unnormalised, and two terms missed it by 2x on the card. No float
// atomics and fixed orders of summation: runs are bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPad = 8;  // bf16 elements of padding a shared row

// per instance: head width DH and warps a block NW (4 where the grid
// holds about one block a multiprocessor; 2 on larger grids, where three
// blocks share a multiprocessor and one's prologue and epilogue hide
// behind the others' loads); keys a warp's tile (16 KB of K and V at
// every width: 64 keys at dh 64, 32 at 128, 16 at 256), stages of each
// key group's ring
template <int DH, int NW>
struct Cfg {
  static constexpr int kWarps = NW;
  static constexpr int KT = 4096 / DH;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int LD = DH + kPad;  // shared K/V/q row stride (bf16)
  static constexpr int LDA = DH + 8;    // shared merge row stride (float)
  static constexpr bool kQReg = DH <= 128;
  static constexpr size_t kRing =
      sizeof(bf16) * kWarps * kStages * 2 * KT * LD;
  static constexpr size_t kMerge = sizeof(float) * kWarps * 16 * LDA;
  static_assert(KT % 16 == 0 && kRing >= kMerge, "the merge reuses the ring");
  // the ring, then the block's q rows (16 a row tile)
  static constexpr size_t smem(int rtb) {
    return kRing + sizeof(bf16) * 16 * rtb * LD;
  }
};

// the most splits the wrapper plans: the combine's weights, 2 floats a
// (split, head), fit the ring (2 * 64 splits * 64 heads * 4 bytes)
constexpr int kMaxSplits = 64;

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

// (x, y) -> three bf16 pairs hi + mid + lo = (x, y) to about 2^-26: hi =
// bf16(x, y), mid = bf16(rest), lo = bf16(rest - mid) (each rest exact in
// float32); x in the low half, as the A operand takes two neighbouring
// columns
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 fh = __bfloat1622float2(h);
  const float rx = x - fh.x, ry = y - fh.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 fm = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(rx - fm.x, ry - fm.y));
}

// 2^x (MUFU.EX2, about 2 ulp); 2^-inf = 0, results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a base-2 running max in natural units; no valid key stays -1e30
__device__ __forceinline__ float natural(float m2) {
  return m2 == kNegInf ? kNegInf : m2 * kLn2;
}

// the warps of key group kg (nthreads of them) wait for one another
__device__ __forceinline__ void group_sync(int kg, int nthreads) {
  if (nthreads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(kg + 1), "r"(nthreads) : "memory");
}

// score tile (NS n8 tiles of keys) -> base-2 scores (x = s*c1, or
// tanh(s*c1)*c2 with CAP), -inf at keys >= hi where MASK says so, and
// each row's max over the thread's columns. Compile-time flags keep the
// loop free of branches.
template <bool CAP, bool MASK, int NS>
__device__ __forceinline__ void scores(float (&s)[NS][4], float c1, float c2,
                                       int kp0, int hi, float& mx0,
                                       float& mx1) {
  mx0 = mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * c1;
      if (CAP) x = tanhf(x) * c2;
      if (MASK && kp0 + j * 8 + (e & 1) >= hi) x = -CUDART_INF_F;
      s[j][e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
}

// Write float4 column j4 of row o: the partials where out_acc is given,
// acc / max(l, 1e-30) (as acc * R, R = 1 / max(l, 1e-30)) where out is;
// m in natural units
__device__ __forceinline__ void emit4(size_t o, int j4, int dh4, float4 a,
                                      float M2, float L, float R,
                                      float* __restrict__ out_acc,
                                      float* __restrict__ out_m,
                                      float* __restrict__ out_l,
                                      float* __restrict__ out) {
  if (out != nullptr)
    reinterpret_cast<float4*>(out)[o * dh4 + j4] =
        make_float4(a.x * R, a.y * R, a.z * R, a.w * R);
  if (out_acc != nullptr) {
    reinterpret_cast<float4*>(out_acc)[o * dh4 + j4] = a;
    if (j4 == 0) {
      out_m[o] = natural(M2);
      out_l[o] = L;
    }
  }
}

template <int DH, int NWARPS>
__global__ void __launch_bounds__(Cfg<DH, NWARPS>::kThreads)
flash_decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int32_t* __restrict__ length,
                        const int32_t* __restrict__ start, int B, int S,
                        int H, int kvH, int dh, int slices, int rtb,
                        float scale, float softcap, int n_split,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l,
                        int32_t* __restrict__ tickets,
                        float* __restrict__ out_acc,
                        float* __restrict__ out_m, float* __restrict__ out_l,
                        float* __restrict__ out) {
  using C = Cfg<DH, NWARPS>;
  constexpr int NW = C::kWarps, KT = C::KT, NS = KT / 8, LD = C::LD;
  constexpr int LDA = C::LDA, NCH = DH / 8;
  constexpr int DH4 = DH / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + C::kRing);  // [16 * rtb][LD]
  __shared__ float m_s[NW][16], l_s[NW][16], w_s[NW][16];
  __shared__ float M_s[NW][16], L_s[NW][16], R_s[NW][16];
  __shared__ int last_s;

  // block x = (b, kv head h, slice z): row tiles z*rtb .., heads hb0 ..
  // hb0 + Gb - 1 of the group, q rows row0 .. row0 + Gb - 1
  const int G = H / kvH;
  const int b = blockIdx.x / (kvH * slices);
  const int hz = blockIdx.x - b * kvH * slices;
  const int h = hz / slices, z = hz - h * slices;
  const int hb0 = z * 16 * rtb;
  const int Gb = min(16 * rtb, G - hb0);
  const size_t row0 =
      static_cast<size_t>(b) * H + static_cast<size_t>(h) * G + hb0;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  // this warp's row tile and key group; the group's threads
  const int r = warp % rtb, kg = warp / rtb, KG = NW / rtb;
  const int NT = 32 * rtb, gt = tid - kg * NT;

  // q rows past Gb and columns past dh are zero; issued before the
  // lengths are read, which the K/V loads wait for
  for (int idx = tid; idx < 16 * rtb * NCH; idx += C::kThreads) {
    const int f = idx / NCH, c = idx % NCH;
    const bool ok = f < Gb && c * 8 < dh;
    cp_async16(smem_u32(Qs + f * LD + c * 8),
               ok ? q + (row0 + f) * dh + c * 8 : q, ok);
  }
  cp_async_commit();

  // this split's part of the element's own valid range, in tiles of KT
  // keys
  const int hi_b = min(length[b], S);
  const int lo_b = start != nullptr ? max(start[b], 0) : 0;
  const int n = max(hi_b - lo_b, 0);
  const int chunk = (n + n_split - 1) / n_split;
  const int lo = lo_b + min(split * chunk, n);
  const int hi = lo_b + min((split + 1) * chunk, n);
  const int T = (hi - lo + KT - 1) / KT;
  const int ni = T > kg ? (T - kg + KG - 1) / KG : 0;  // the group's tiles

  const size_t stride = static_cast<size_t>(kvH) * dh;
  const size_t base =
      static_cast<size_t>(b) * S * stride + static_cast<size_t>(h) * dh;
  bf16* ring = reinterpret_cast<bf16*>(smem) +
               static_cast<size_t>(kg) * C::kStages * 2 * KT * LD;
  // the group's i-th tile (keys lo + 16 (kg + KG i) ..) into its stage;
  // keys >= hi and columns >= dh zero-filled
  auto load = [&](int i) {
    const int k0 = lo + KT * (kg + KG * i);
    bf16* dst = ring + (i % C::kStages) * 2 * KT * LD;
    for (int idx = gt; idx < KT * NCH; idx += NT) {
      const int row = idx / NCH, c = idx % NCH;
      const bool ok = k0 + row < hi && c * 8 < dh;
      const size_t off =
          ok ? base + static_cast<size_t>(k0 + row) * stride + c * 8 : 0;
      cp_async16(smem_u32(dst + row * LD + c * 8), k + off, ok);
      cp_async16(smem_u32(dst + (KT + row) * LD + c * 8), v + off, ok);
    }
  };
#pragma unroll
  for (int p = 0; p < C::kStages - 1; ++p) {
    if (p < ni) load(p);
    cp_async_commit();
  }
  cp_async_wait<C::kStages - 1>();  // the q group
  __syncthreads();

  // ldmatrix row addresses of this lane: A from q (the warp's row tile),
  // B from K (keys 0-7/8-15, columns 0/8), B from V transposed
  const uint32_t q_addr =
      smem_u32(Qs + (r * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  uint32_t qf[C::kQReg ? DH / 16 : 1][4];
  if constexpr (C::kQReg) {
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) ldsm_x4(qf[ks], q_addr + ks * 32);
  }

  // base-2 scores: x = s*scale*log2e, or tanh(s*scale/cap)*cap*log2e
  const float c1 = softcap > 0.f ? scale / softcap : scale * kLog2e;
  const float c2 = softcap * kLog2e;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[DH / 8][4];
#pragma unroll
  for (int nn = 0; nn < DH / 8; ++nn)
    acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;

  for (int i = 0; i < ni; ++i) {
    // the group's tile i + stages - 1 goes where tile i - 1 was read from
    if (i + C::kStages - 1 < ni) load(i + C::kStages - 1);
    cp_async_commit();
    cp_async_wait<C::kStages - 1>();
    group_sync(kg, NT);  // tile i has landed for the whole group
    const bf16* Ks = ring + (i % C::kStages) * 2 * KT * LD;
    const uint32_t k_addr = smem_u32(Ks + k_off);
    const uint32_t v_addr = smem_u32(Ks + KT * LD + v_off);

    // s = q . k^T, 16 rows x KT keys; at 16 keys in two chains (even/odd
    // 16-column steps) so that the MMAs' latencies overlap
    constexpr int NC = NS > 2 ? 1 : 2;
    float s[NS][4], t[NC == 2 ? NS : 1][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < (NC == 2 ? NS : 1); ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t a[4];
      if constexpr (C::kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldsm_x4(a, q_addr + ks * 32);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, k_addr + (np * 16 * LD + ks * 16) * 2);
        if (NC == 2 && (ks & 1)) {
          mma_bf16(t[2 * np], a, bk[0], bk[1]);
          mma_bf16(t[2 * np + 1], a, bk[2], bk[3]);
        } else {
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
    if constexpr (NC == 2) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += t[j][e];
    }

    // scale, softcap, mask (the tile past the split's end only), online
    // softmax; the 4 threads of a quad share a row
    const int k0 = lo + KT * (kg + KG * i);
    const bool edge = k0 + KT > hi;
    float mx0, mx1;
    if (softcap > 0.f) {
      if (edge) scores<true, true, NS>(s, c1, c2, k0 + 2 * t4, hi, mx0, mx1);
      else scores<true, false, NS>(s, c1, c2, k0 + 2 * t4, hi, mx0, mx1);
    } else {
      if (edge) scores<false, true, NS>(s, c1, c2, k0 + 2 * t4, hi, mx0, mx1);
      else scores<false, false, NS>(s, c1, c2, k0 + 2 * t4, hi, mx0, mx1);
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
    // quad); the quad's sums are added once, after the loop
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;

    // acc = acc * alpha + (p_lo + p_mid + p_hi) . v. The tensor cores
    // align and cut their sums' low bits; summed into acc across thousands
    // of keys that cost the partials their atol 1e-5 at dh 128, so at 32-
    // and 64-key tiles the tile's product is taken in fresh accumulators
    // (smallest term first) and added to acc by one float32 fma. At dh 256
    // (16-key tiles) the fresh accumulators cost registers the 128-register
    // acc does not leave (ptxas spilled), and the three products go into
    // acc itself, rescaled first.
    uint32_t ph[KT / 16][4], pm[KT / 16][4], pl[KT / 16][4];
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
      split3_bf16(s[2 * kc][0], s[2 * kc][1], ph[kc][0], pm[kc][0],
                  pl[kc][0]);
      split3_bf16(s[2 * kc][2], s[2 * kc][3], ph[kc][1], pm[kc][1],
                  pl[kc][1]);
      split3_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[kc][2], pm[kc][2],
                  pl[kc][2]);
      split3_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[kc][3], pm[kc][3],
                  pl[kc][3]);
    }
#pragma unroll
    for (int dn = 0; dn < DH / 16; ++dn) {
      uint32_t bv[KT / 16][4];
#pragma unroll
      for (int kc = 0; kc < KT / 16; ++kc)
        ldsm_x4_trans(bv[kc], v_addr + (kc * 16 * LD + dn * 16) * 2);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float* a = acc[2 * dn + h2];
        if constexpr (KT == 16) {
          a[0] *= al0;
          a[1] *= al0;
          a[2] *= al1;
          a[3] *= al1;
          mma_bf16(acc[2 * dn + h2], pl[0], bv[0][2 * h2], bv[0][2 * h2 + 1]);
          mma_bf16(acc[2 * dn + h2], pm[0], bv[0][2 * h2], bv[0][2 * h2 + 1]);
          mma_bf16(acc[2 * dn + h2], ph[0], bv[0][2 * h2], bv[0][2 * h2 + 1]);
        } else {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kc = 0; kc < KT / 16; ++kc) {
            mma_bf16(c, pl[kc], bv[kc][2 * h2], bv[kc][2 * h2 + 1]);
            mma_bf16(c, pm[kc], bv[kc][2 * h2], bv[kc][2 * h2 + 1]);
            mma_bf16(c, ph[kc], bv[kc][2 * h2], bv[kc][2 * h2 + 1]);
          }
          a[0] = fmaf(a[0], al0, c[0]);
          a[1] = fmaf(a[1], al0, c[1]);
          a[2] = fmaf(a[2], al1, c[2]);
          a[3] = fmaf(a[3], al1, c[3]);
        }
      }
    }
    group_sync(kg, NT);  // the stage is read; the next copy may overwrite it
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // merge the key groups' states in group order, in shared memory (the
  // ring, read by now). Outputs are walked at positions p = f * DH4 + j4
  // (head f, float4 column j4 < dh4), so no index takes a division.
  cp_async_wait<0>();
  __syncthreads();
  float* a_s = reinterpret_cast<float*>(smem);  // [NW][16][LDA]
  {
    float* aw = a_s + warp * 16 * LDA;
#pragma unroll
    for (int nn = 0; nn < DH / 8; ++nn) {
      const int col = nn * 8 + 2 * t4;
      *reinterpret_cast<float2*>(aw + g4 * LDA + col) =
          make_float2(acc[nn][0], acc[nn][1]);
      *reinterpret_cast<float2*>(aw + (g4 + 8) * LDA + col) =
          make_float2(acc[nn][2], acc[nn][3]);
    }
    if (t4 == 0) {
      m_s[warp][g4] = m0;
      m_s[warp][g4 + 8] = m1;
      l_s[warp][g4] = l0;
      l_s[warp][g4 + 8] = l1;
    }
  }
  __syncthreads();
  // a thread a (row tile, row): M, the groups' weights, L, 1 / max(L, 1e-30)
  if (tid < rtb * 16) {
    const int rr = tid >> 4, row = tid & 15;
    float M = kNegInf;
    for (int g = 0; g < KG; ++g) M = fmaxf(M, m_s[g * rtb + rr][row]);
    float L = 0.f;
    for (int g = 0; g < KG; ++g) {
      const float w = ex2(m_s[g * rtb + rr][row] - M);
      w_s[g * rtb + rr][row] = w;
      L = fmaf(l_s[g * rtb + rr][row], w, L);
    }
    M_s[rr][row] = M;
    L_s[rr][row] = L;
    R_s[rr][row] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const size_t rows = static_cast<size_t>(B) * H;
  const int dh4 = dh >> 2;
  for (int p = tid; p < Gb * DH4; p += C::kThreads) {
    const int f = p / DH4, j4 = p % DH4;
    if (j4 >= dh4) continue;
    const int rr = f >> 4, row = f & 15;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < KG; ++g) {
      const int w = g * rtb + rr;
      const float4 x = *reinterpret_cast<const float4*>(
          a_s + (w * 16 + row) * LDA + 4 * j4);
      const float wt = w_s[w][row];
      a.x = fmaf(x.x, wt, a.x);
      a.y = fmaf(x.y, wt, a.y);
      a.z = fmaf(x.z, wt, a.z);
      a.w = fmaf(x.w, wt, a.w);
    }
    if (n_split == 1) {
      emit4(row0 + f, j4, dh4, a, M_s[rr][row], L_s[rr][row], R_s[rr][row],
            out_acc, out_m, out_l, out);
    } else {
      const size_t o = split * rows + row0 + f;
      reinterpret_cast<float4*>(part_acc)[o * dh4 + j4] = a;
      if (j4 == 0) {
        part_m[o] = M_s[rr][row];  // base 2
        part_l[o] = L_s[rr][row];
      }
    }
  }
  if (n_split == 1) return;

  // the last block of this column to finish combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(tickets + blockIdx.x, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the splits' weights a (split, head) in shared memory; M, L and
  // 1 / max(L, 1e-30) a head
  float* w_sp = reinterpret_cast<float*>(smem);  // [n_split][Gb]: m, then w
  float* l_sp = w_sp + n_split * Gb;             // [n_split][Gb]
  float* Mh = &M_s[0][0];  // [Gb]: Gb <= 16 * rtb <= 16 * NW
  float* Lh = &L_s[0][0];
  float* Rh = &R_s[0][0];
  for (int t = tid; t < n_split * Gb; t += C::kThreads) {
    const int sp = t / Gb, f = t - sp * Gb;
    const size_t o = sp * rows + row0 + f;
    w_sp[t] = __ldcg(part_m + o);
    l_sp[t] = __ldcg(part_l + o);
  }
  __syncthreads();
  for (int f = tid; f < Gb; f += C::kThreads) {
    float M = kNegInf;
    for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, w_sp[sp * Gb + f]);
    float L = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float w = ex2(w_sp[sp * Gb + f] - M);
      w_sp[sp * Gb + f] = w;
      L = fmaf(l_sp[sp * Gb + f], w, L);
    }
    Mh[f] = M;
    Lh[f] = L;
    Rh[f] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  // acc summed in split order. A thread takes U positions p = f * DH4 +
  // j4 at a time and loads them for 32 / U splits before it adds any, so
  // that 32 loads are in flight (the combine is one block's, and its time
  // is round trips to L2)
  const float4* pa = reinterpret_cast<const float4*>(part_acc);
  const int npos = Gb * DH4;
  auto pass = [&](auto u_) {
    constexpr int U = decltype(u_)::value, SU = 32 / U;
    for (int p0 = 0; p0 < npos; p0 += U * C::kThreads) {
      int fu[U], ju[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + tid + u * C::kThreads;
        fu[u] = p / DH4;
        ju[u] = p % DH4;
        ok[u] = fu[u] < Gb && ju[u] < dh4;
      }
      float4 a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp0 = 0; sp0 < n_split; sp0 += SU) {
        float4 x[SU][U];
#pragma unroll
        for (int k2 = 0; k2 < SU; ++k2)
#pragma unroll
          for (int u = 0; u < U; ++u)
            x[k2][u] = ok[u] && sp0 + k2 < n_split
                           ? __ldcg(pa + ((sp0 + k2) * rows + row0 + fu[u]) *
                                             dh4 + ju[u])
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k2 = 0; k2 < SU; ++k2) {
          if (sp0 + k2 >= n_split) break;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float wt = ok[u] ? w_sp[(sp0 + k2) * Gb + fu[u]] : 0.f;
            a[u].x = fmaf(x[k2][u].x, wt, a[u].x);
            a[u].y = fmaf(x[k2][u].y, wt, a[u].y);
            a[u].z = fmaf(x[k2][u].z, wt, a[u].z);
            a[u].w = fmaf(x[k2][u].w, wt, a[u].w);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u])
          emit4(row0 + fu[u], ju[u], dh4, a[u], Mh[fu[u]], Lh[fu[u]],
                Rh[fu[u]], out_acc, out_m, out_l, out);
    }
  };
  const int each = (npos + C::kThreads - 1) / C::kThreads;
  if (each <= 2) pass(std::integral_constant<int, 2>{});
  else if (each <= 4) pass(std::integral_constant<int, 4>{});
  else pass(std::integral_constant<int, 8>{});
  if (tid == 0) tickets[blockIdx.x] = 0;
}

template <int DH, int NW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* length, const int32_t* start, int B, int S,
                   int H, int kvH, int dh, int slices, int rtb, float scale,
                   float softcap, int n_split, float* pa, float* pm,
                   float* pl, int32_t* tickets, float* oa, float* om,
                   float* ol, float* out, cudaStream_t st) {
  using C = Cfg<DH, NW>;
  if (rtb > C::kWarps) return cudaErrorInvalidValue;
  // raise the limit to the most any row-tile count needs, once per
  // instance, so that a CUDA-graph capture never calls it
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_mma_kernel<DH, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::smem(C::kWarps)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(B * kvH * slices, n_split);
  flash_decode_mma_kernel<DH, NW><<<grid, C::kThreads, C::smem(rtb), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), length, start, B, S, H, kvH, dh, slices,
      rtb, scale, softcap, n_split, pa, pm, pl, tickets, oa, om, ol, out);
  return cudaGetLastError();
}

template <int NW>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int32_t* length, const int32_t* start, int B,
                     int S, int H, int kvH, int dh, int slices, int rtb,
                     float scale, float softcap, int n_split, float* pa,
                     float* pm, float* pl, int32_t* tickets, float* oa,
                     float* om, float* ol, float* out, cudaStream_t st) {
#define REPRO_DECODE_MMA(DH)                                                 \
  return launch<DH, NW>(q, k, v, length, start, B, S, H, kvH, dh, slices,    \
                        rtb, scale, softcap, n_split, pa, pm, pl, tickets,   \
                        oa, om, ol, out, st)
  if (dh <= 64) REPRO_DECODE_MMA(64);
  if (dh <= 128) REPRO_DECODE_MMA(128);
  REPRO_DECODE_MMA(256);
#undef REPRO_DECODE_MMA
}

}  // namespace

// bfloat16 q (B,H,dh), k/v (B,S,kvH,dh), length/start (B,) int32 (start
// may be null); dh % 8 == 0 and dh <= 256; `warps` 2 or 4 a block;
// `slices` blocks a kv head's ceil(G/16) row tiles, at most `warps` tiles
// a block (the wrapper's launch_plan). With n_split > 1 (at most 64):
// scratch part_* holds (n_split, B, H[, dh]) float32 and tickets
// (B*kvH*slices,) int32 zeros, which every launch leaves zero again.
// Called by repro_flash_decode.
cudaError_t flash_decode_bf16_mma(const void* q, const void* k, const void* v,
                                  const int32_t* length, const int32_t* start,
                                  int B, int S, int H, int kvH, int dh,
                                  int slices, int warps, float scale,
                                  float softcap, int n_split, float* pa,
                                  float* pm, float* pl, int32_t* tickets,
                                  float* oa, float* om, float* ol, float* out,
                                  cudaStream_t st) {
  if (slices < 1 || n_split < 1 || n_split > kMaxSplits || H % kvH)
    return cudaErrorInvalidValue;
  const int rt = (H / kvH + 15) / 16;
  // row tiles a block, rounded up to a divisor of the warps (3 -> 4)
  int rtb = (rt + slices - 1) / slices;
  if (rtb == 3) rtb = 4;
  if (warps == 2)
    return dispatch<2>(q, k, v, length, start, B, S, H, kvH, dh, slices, rtb,
                       scale, softcap, n_split, pa, pm, pl, tickets, oa, om,
                       ol, out, st);
  if (warps == 4)
    return dispatch<4>(q, k, v, length, start, B, S, H, kvH, dh, slices, rtb,
                       scale, softcap, n_split, pa, pm, pl, tickets, oa, om,
                       ol, out, st);
  return cudaErrorInvalidValue;
}
