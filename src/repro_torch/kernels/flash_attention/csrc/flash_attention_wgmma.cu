// Causal online-softmax attention forward (prefill) for Hopper (sm_90a),
// bfloat16 q/k/v on the tensor cores through warpgroup MMA (wgmma): GQA,
// optional sliding window, fused tanh logit softcap. float32 inputs take
// the CUDA-core kernel in flash_attention.cu; repro_flash_attention
// dispatches by dtype.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// `_kernel` / `flash_attention` (its (B, kvH, S/tq, S/tk) grid walks the
// KV tiles in order on one core with (m, l, acc) in VMEM scratch). Here
// the KV axis is a loop inside the block and (m, l, acc) live in
// registers. Block (tile, kvh, b) owns BR = 128 rows of the flattened
// (query position, group head) axis, row f = qpos * G + g, so one tile
// shape serves any group size G (q head kvh*G + g reads kv head kvh). Row
// tiles are taken heaviest first. Key tiles (BK = 128 keys at dh <= 128,
// 64 at dh = 256) run from the first key the window admits to the last
// the causal mask admits. Any S: ragged rows and keys are zero-filled and
// masked. Without a mask (causal = 0, no window) k/v may have a length
// Skv of their own, the reference's cross-attention: the key loop ends at
// Skv - 1 and keys kp >= Skv are masked. With a mask Skv == S (checked by
// the wrapper). One instance a head width (64, 128, 256) serves any dh up
// to it that is a multiple of 8.
//
// Bound: operations, 4*dh FLOP per valid (q head, key) pair at the bf16
// tensor-core rate. The design is FlashAttention-3's warp-specialised
// schedule:
// - Three warpgroups a block. Warpgroup 0 is the producer: it gives up
//   registers (setmaxnreg 24) and one thread issues TMA loads of the K and
//   V tiles into a ring of NSTAGE stages, each with a `full` mbarrier
//   (the TMA bytes land) and an `empty` one (every consumer warp has read
//   the stage). Warpgroups 1 and 2 are the consumers (setmaxnreg 240),
//   64 rows each: the M of wgmma.m64nNk16.
// - The tensor maps are 4-D over (dh, kvH, Skv, B), boxes of 64 columns
//   by BK keys with 128-byte swizzle, encoded on the host for each call
//   and passed as __grid_constant__ parameters (a CUDA-graph capture
//   keeps them). TMA zero-fills outside the map: ragged Skv, the next
//   batch's keys, and the columns of a dh below the instance's width.
// - Each consumer loads its 64 q rows once with cp.async into the same
//   swizzled layout (rows of a GQA group are not one strided box), zero
//   where a row or column lies outside.
// - S = q.k^T by wgmma with both operands in shared memory and float32
//   accumulators: a bf16 x bf16 product is exact in float32, so this is
//   the float32 einsum up to the order of the sums. The scale is applied
//   to the float32 sum (exact for a power-of-two scale such as gemma2's
//   1/16), then the softcap with accurate tanhf; the mask (on tiles that
//   straddle the diagonal, the window's edge or Skv only, through
//   compile-time variants of the score loop) and the online max and sum
//   stay float32, in base 2 (log2(e) folded into the scale).
// - P.V without rounding p to bf16: p = p_hi + p_lo, two bf16 terms
//   (p_lo = bf16(p - p_hi)), each multiplied with the exact bf16 V by
//   wgmma with A in registers (the m64nN accumulator layout is the A
//   fragment layout) and V read transposed from shared memory, summed in
//   float32: p keeps about 2^-17 relative error. Work: 1.5x the bound's
//   FLOP (2*dh for QK^T, 2*2*dh for P.V a pair).
// - The two consumers take turns at the tensor cores (named barriers
//   1 and 2): each issues its S product in one turn and its P.V in the
//   next, so one consumer's softmax runs while the other's products do
//   (FlashAttention-3's ping-pong). Issuing tile t+1's S product before
//   tile t's softmax as well spilled at dh 128 and 256 and was slower
//   on the card; a third ring stage gained nothing (PERF.md).
// - Registers: the float32 accumulator is DH/2 a thread (128 at dh 256),
//   the score tile BK/2, p_hi and p_lo BK/4 each; at dh 256 64-key tiles
//   keep them within the consumers' 240. Shared memory at dh 256: q 2 x
//   32 KB + 2 stages x (K, V) 2 x 32 KB = 192 KB, one block an SM.
// Masked scores get p = 0 (the TPU kernel's -1e30 masking), a row with no
// valid key gives 0, out = acc / max(l, 1e-30) rounded to bf16. No
// atomics and a fixed order of summation, so runs are bit-identical.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWg = 128;                 // threads a warpgroup
constexpr int kConsumers = 2;            // consumer warpgroups a block
constexpr int kThreads = kWg * (1 + kConsumers);
constexpr int BR = 64 * kConsumers;      // flattened rows a block
constexpr int NSTAGE = 2;                // K/V tiles in the ring
constexpr int kBox = 64;                 // columns a TMA box: 128 bytes
constexpr int kAtom = 1024;              // 8 rows of 128 B: a swizzle atom
// named barriers (0 is __syncthreads'): consumer c's turn at the tensor
// cores is kBarTurn + c, its own warpgroup's kBarWg + c
constexpr int kBarTurn = 1;
constexpr int kBarWg = 3;

// keys a tile: a multiple of 16 (the MMA's k) that is a valid wgmma N; at
// dh 256 small enough that the 128-register accumulator, the score tile
// and p's two bf16 terms fit the consumers' registers without spills
template <int DH>
__host__ __device__ constexpr int key_tile() {
  return DH > 128 ? 64 : 128;
}

// q rows of both consumers, then NSTAGE x (K, V) tiles, each as 64-column
// boxes of [rows][128 B]; 1 KB of slack to align the base to an atom
template <int DH>
constexpr int smem_bytes() {
  return kAtom + 2 * DH * (BR + NSTAGE * 2 * key_tile<DH>());
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

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and expect `bytes` of TMA transactions in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers an async
// wgmma owns across the issue or the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets (for K-major operands the stride is
// between 8-row groups; for the MN-major V the leading offset is between
// 64-column boxes and the stride between 8-key groups)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// byte offset of 16-byte chunk `ch` of row `r` in [boxes][rows][128 B]
// with 128-byte swizzle, `rows` rows a box
__device__ __forceinline__ uint32_t swz(int r, int ch, int rows) {
  return (ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
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

// d (64 x 64, float32) = [d +] a (64 x 16) * b (64 x 16)^T, both from
// shared memory, K-major, 128-byte swizzle; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, float32) = [d +] a (64 x 16) * b (128 x 16)^T, both from
// shared memory, K-major, 128-byte swizzle; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) += a (64 x 16, bf16 in registers) * b (16 x 64),
// b from shared memory MN-major (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, float32) += a (64 x 16, bf16 in registers) * b (16 x 128),
// b from shared memory MN-major (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, float32) += a (64 x 16, bf16 in registers) * b (16 x 256),
// b from shared memory MN-major (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// what an edge tile needs to mask: key of column 2*t4 of n-tile 0, the
// thread's two query positions, and the masking rule
struct Edge {
  int kp0, qp0, qp1, Skv, causal, window;
};

// score tile (the m64nBK accumulator: n-tile j's elements 4j..4j+3 are
// row g4, columns 8j + 2*t4 + {0, 1}, then row g4 + 8) -> base-2 scores
// (x = s*c1, or tanh(s*c1)*c2 with CAP), masked to -inf where MASK says
// so, and each row's max over the thread's columns. Compile-time flags
// keep the element loop free of branches.
template <bool CAP, bool MASK, int N>
__device__ __forceinline__ void scores(float (&s)[N], float c1, float c2,
                                       const Edge& edge, float& mx0,
                                       float& mx1) {
  mx0 = mx1 = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = i / 4, e = i % 4;
    float x = s[i] * c1;
    if (CAP) x = tanhf(x) * c2;
    if (MASK) {
      const int kp = edge.kp0 + j * 8 + (e & 1);
      const int qp = e < 2 ? edge.qp0 : edge.qp1;
      if (kp >= edge.Skv || (edge.causal && kp > qp) ||
          (edge.window > 0 && kp <= qp - edge.window))
        x = -CUDART_INF_F;
    }
    s[i] = x;
    if (e < 2) mx0 = fmaxf(mx0, x);
    else mx1 = fmaxf(mx1, x);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __nv_bfloat16* __restrict__ q,
                             __nv_bfloat16* __restrict__ out, int S, int H,
                             int kvH, int dh, float scale, float softcap,
                             int causal, int window, int Skv) {
  constexpr int BK = key_tile<DH>();
  constexpr int NB = DH / kBox;          // boxes a row
  constexpr int NCH = DH / 8;            // 16-byte chunks a row
  constexpr int Q_BYTES = 64 * DH * 2;   // one consumer's q rows
  constexpr int KV_BYTES = BK * DH * 2;  // one K (or V) tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NSTAGE];  // full[], empty[]

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtom - 1) & ~static_cast<uint32_t>(kAtom - 1);
  const uint32_t kv_s = base + kConsumers * Q_BYTES;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[NSTAGE]);

  const int G = H / kvH;
  const int nrows = S * G;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int f0 = tile * BR;
  const int last = min(f0 + BR, nrows) - 1;
  const int qlo = f0 / G, qhi = last / G;
  const int klo = window > 0 ? max(0, qlo - window + 1) : 0;
  const int khi = causal ? qhi : Skv - 1;
  const int ntiles = (khi - klo) / BK + 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kConsumers);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int stage = t % NSTAGE;
        if (t >= NSTAGE) mbar_wait(empty0 + 8 * stage, (t / NSTAGE - 1) & 1);
        const uint32_t full = full0 + 8 * stage;
        mbar_expect_tx(full, 2 * KV_BYTES);
        const uint32_t ks = kv_s + stage * 2 * KV_BYTES;
        const int k0 = klo + t * BK;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(ks + j * BK * 128, &tm_k, full, j * kBox, h, k0, b);
          tma_load_4d(ks + KV_BYTES + j * BK * 128, &tm_v, full, j * kBox, h,
                      k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / kWg - 1;  // consumer 0 or 1
    const int tid = threadIdx.x % kWg, warp = tid >> 5, lane = tid & 31;
    const int f0w = f0 + 64 * c;          // this consumer's first row
    const uint32_t qs = base + c * Q_BYTES;

    // q rows: row r of this consumer is flattened row f0w + r
#pragma unroll
    for (int it = 0; it < 64 * NCH / kWg; ++it) {
      const int idx = tid + it * kWg;
      const int r = idx / NCH, ch = idx % NCH;
      const int f = f0w + r;
      const bool ok = f < nrows && ch * 8 < dh;
      const __nv_bfloat16* src = q;
      if (ok) {
        const int qp = f / G, g = f - qp * G;
        src = q + ((static_cast<size_t>(b) * S + qp) * H + h * G + g) * dh +
              ch * 8;
      }
      cp_async16(qs + swz(r, ch, 64), src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // the q rows are read by wgmma (the async proxy) from here on
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(kBarWg + c, kWg);
    // consumer 0 takes the first turn at the tensor cores
    if (c == 1) bar_arrive(kBarTurn, 2 * kWg);

    // this thread's rows of the accumulator layout: g4 and g4 + 8 of the
    // warp's 16; the consumer's own query span decides interior tiles
    const int g4 = lane >> 2, t4 = lane & 3;
    const int qp0 = (f0w + warp * 16 + g4) / G;
    const int qp1 = (f0w + warp * 16 + g4 + 8) / G;
    const int lastw = min(f0w + 63, nrows - 1);
    const int qlo_w = min(f0w, lastw) / G, qhi_w = lastw / G;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

    // scores in base 2: x = s*scale*log2e, or tanh(s*scale/cap)*cap*log2e
    const float c1 = softcap > 0.f ? scale / softcap : scale * kLog2e;
    const float c2 = softcap * kLog2e;

    for (int t = 0; t < ntiles; ++t) {
      const int stage = t % NSTAGE;
      const int k0 = klo + t * BK;
      const uint32_t ks = kv_s + stage * 2 * KV_BYTES;
      const uint32_t vs = ks + KV_BYTES;
      mbar_wait(full0 + 8 * stage, (t / NSTAGE) & 1);

      // s = q . k^T: 64 rows x BK keys, DH/16 steps of 16 columns
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      bar_sync(kBarTurn + c, 2 * kWg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;  // 16 columns in a box
        wgmma_ss(s,
                 sw128_desc(qs + (kk / 4) * 64 * 128 + step, 16, kAtom),
                 sw128_desc(ks + (kk / 4) * BK * 128 + step, 16, kAtom),
                 kk > 0);
      }
      wgmma_commit();
      bar_arrive(kBarTurn + 1 - c, 2 * kWg);  // the other consumer's turn
      wgmma_wait();
      fence_regs(s);

      // scale, softcap, mask (edge tiles only), online softmax; the 4
      // threads of a quad share a row
      const bool interior = k0 + BK - 1 < Skv &&
                            (!causal || k0 + BK - 1 <= qlo_w) &&
                            (window <= 0 || k0 > qhi_w - window);
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
      for (int i = 0; i < BK / 2; i += 4) {
        s[i] = ex2(s[i] - mn0);
        s[i + 1] = ex2(s[i + 1] - mn0);
        s[i + 2] = ex2(s[i + 2] - mn1);
        s[i + 3] = ex2(s[i + 3] - mn1);
        rs0 += s[i] + s[i + 1];
        rs1 += s[i + 2] + s[i + 3];
      }
      // l holds this thread's columns only (alpha is the same across the
      // quad); the quad's partial sums are added once, after the loop
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
      // rescale only when some row's max moved (multiplying by 1 is exact)
      if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
        for (int i = 0; i < DH / 2; i += 4) {
          acc[i] *= al0;
          acc[i + 1] *= al0;
          acc[i + 2] *= al1;
          acc[i + 3] *= al1;
        }
      }

      // acc += p_hi . v + p_lo . v, 16 keys a step: the A fragment of
      // keys 16kc..16kc+15 is n-tiles 2kc and 2kc + 1 of the score tile
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        split_bf16(s[8 * kc], s[8 * kc + 1], ph[kc][0], pl[kc][0]);
        split_bf16(s[8 * kc + 2], s[8 * kc + 3], ph[kc][1], pl[kc][1]);
        split_bf16(s[8 * kc + 4], s[8 * kc + 5], ph[kc][2], pl[kc][2]);
        split_bf16(s[8 * kc + 6], s[8 * kc + 7], ph[kc][3], pl[kc][3]);
      }
      bar_sync(kBarTurn + c, 2 * kWg);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint64_t dv = sw128_desc(vs + kc * 2 * kAtom, BK * 128, kAtom);
        wgmma_rs(acc, ph[kc], dv);
        wgmma_rs(acc, pl[kc], dv);
      }
      wgmma_commit();
      // consumer 1's last turn is not passed on: consumer 0 has ended
      if (c == 0 || t + 1 < ntiles) bar_arrive(kBarTurn + 1 - c, 2 * kWg);
      wgmma_wait();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      // stage t is read: this warp's share of the release
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    }

    // out = acc / max(l, 1e-30) in bf16, staged through this consumer's
    // own q rows (every product that read them has completed) in the
    // same swizzled layout, then 16-byte stores
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    unsigned char* const os = smem_raw + (qs - raw);
    const int r = warp * 16 + g4;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const uint32_t off = swz(r, n, 64) + 4 * t4;
      *reinterpret_cast<__nv_bfloat162*>(os + off) =
          __floats2bfloat162_rn(acc[4 * n] / d0, acc[4 * n + 1] / d0);
      *reinterpret_cast<__nv_bfloat162*>(os + off + 8 * 128) =
          __floats2bfloat162_rn(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
    bar_sync(kBarWg + c, kWg);
#pragma unroll
    for (int it = 0; it < 64 * NCH / kWg; ++it) {
      const int idx = tid + it * kWg;
      const int rr = idx / NCH, ch = idx % NCH;
      const int f = f0w + rr;
      if (f < nrows && ch * 8 < dh) {
        const int qp = f / G, g = f - qp * G;
        *reinterpret_cast<uint4*>(
            out + ((static_cast<size_t>(b) * S + qp) * H + h * G + g) * dh +
            ch * 8) = *reinterpret_cast<const uint4*>(os + swz(rr, ch, 64));
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// k or v (B, Skv, kvH, dh) as a 4-D map over (dh, kvH, Skv, B): boxes of
// 64 columns by `keys` keys of one head, 128-byte swizzle, zero fill
bool kv_map(CUtensorMap* map, const void* t, int B, int Skv, int kvH, int dh,
            int keys) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(kvH),
                              static_cast<cuuint64_t>(Skv),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(dh) * 2;
  const cuuint64_t strides[3] = {row, row * kvH, row * kvH * Skv};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(keys), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Skv, int H, int kvH, int dh, float scale,
                   float softcap, int causal, int window, cudaStream_t st) {
  constexpr int smem = smem_bytes<DH>();
  // set once per instantiation, so a CUDA-graph capture never calls it
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap tm_k, tm_v;
  if (!kv_map(&tm_k, k, B, Skv, kvH, dh, key_tile<DH>()) ||
      !kv_map(&tm_v, v, B, Skv, kvH, dh, key_tile<DH>()))
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(S) * (H / kvH);
  const dim3 grid(static_cast<unsigned>((rows + BR - 1) / BR), kvH, B);
  flash_attention_wgmma_kernel<DH><<<grid, kThreads, smem, st>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), S, H, kvH, dh, scale, softcap, causal,
      window, Skv);
  return cudaGetLastError();
}

}  // namespace

// bfloat16 q (B,S,H,dh), k/v (B,Skv,kvH,dh), out like q; dh % 8 == 0 and
// dh <= 256, Skv == S unless there is no mask, 16-byte aligned (checked by
// the wrapper). Called by repro_flash_attention.
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
