// Tensor-core building blocks shared by the port's kernels (sgmv,
// flash_attention and its backward): cp.async with zero fill, ldmatrix,
// the m16n8k16 bf16 -> f32 and m16n8k8 tf32 -> f32 mma.sync, as inline
// PTX for sm_90a.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), for lane l with
// g = l / 4 and c = 2 * (l % 4):
//   A (16 x 16, row-major): a0 (g, c..c+1), a1 (g+8, c..c+1),
//                           a2 (g, c+8..c+9), a3 (g+8, c+8..c+9)
//   B (16 x 8, K x N):      b0 (k c..c+1, n g), b1 (k c+8..c+9, n g)
//   C (16 x 8, f32):        c0 c1 (g, c..c+1), c2 c3 (g+8, c..c+1)
// Each register of A and B holds two bf16 values, the lower column (or
// k) index in the low half. The C fragments of two neighbouring n-tiles
// are exactly the A fragment of one 16-wide k step, which is how a
// score tile becomes the left operand of the next product in registers.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32), one value a
// register, t = l % 4:
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
//                          a3 (g+8, t+4)
//   B (8 x 8, K x N):      b0 (k t, n g), b1 (k t+4, n g)
//   C as for m16n8k16.
// The C fragment of one n-tile holds columns 2t, 2t+1 where A wants t,
// t+4: with k permuted so that A's k t is column 2t and its k t+4 is
// column 2t+1, (c0, c2, c1, c3) is the A fragment of one 8-wide k step,
// and the B fragment takes rows 2t and 2t+1 (b0, b1) of the same step.
//
// Shared-memory tiles are row-major with a row stride of (16 k + 8)
// bf16 values for some k: an odd number of 16-byte units, so the eight
// 16-byte rows one ldmatrix phase reads fall in eight different bank
// groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared asynchronously; only the first
// `src_bytes` (0..16) are read, the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy 4 bytes global -> shared asynchronously, or 4 zero bytes when
// src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 16 bytes global -> shared by cp.async, or 16 zero bytes when !valid
// (`src` must still be a valid address; it is not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  cp_async16(dst, src, valid ? 16 : 0);
}

// Eight consecutive bf16 values of a row into shared memory by scalar
// loads, for rows that are not 16-byte aligned: `n_valid` of them from
// `src`, zeros after. A synchronous store, visible to the block after
// the barrier that follows.
__device__ __forceinline__ void copy8_scalar(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int n_valid) {
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = i < n_valid ? src[i] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
// (a shared-memory address, so a base plus a constant offset folds into
// the instruction).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Per-lane element offsets into a row-major tile of row stride ld.
// lane_off_rows16 (row l % 16, 8-column chunk l / 16) addresses the A
// fragment of 16 rows x k [k0, k0 + 16) with ldsm_x4 (add k0), and,
// with ldsm_x4_trans, the B fragments of two n-tiles n [n0, n0 + 16)
// of a K-major tile, where row k holds n contiguous: LoRA weights, V
// (add k0 * ld + n0). lane_off_b_nmajor addresses the same two n-tiles
// of an N-major tile, where row n holds k contiguous: K rows for Q·K^T
// (add n0 * ld + k0). Either way b[0], b[1] are n-tile n0's fragment
// and b[2], b[3] n0 + 8's.
__device__ __forceinline__ int lane_off_rows16(int ld, int lane) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int lane_off_b_nmajor(int ld, int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}

// The A fragment of rows [0, 16) x k [k0, k0 + 16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int k0, int lane) {
  ldsm_x4(a, smem_addr(tile + lane_off_rows16(ld, lane) + k0));
}
// The B fragments of n-tiles n0, n0 + 8 at k [k0, k0 + 16) of a K-major
// tile.
__device__ __forceinline__ void load_b_kmajor(uint32_t (&b)[4],
                                              const __nv_bfloat16* tile,
                                              int ld, int n0, int k0,
                                              int lane) {
  ldsm_x4_trans(b, smem_addr(tile + lane_off_rows16(ld, lane) + k0 * ld +
                             n0));
}

// d += a · b, bf16 operands, f32 accumulator. Registers only, so not
// volatile: the compiler may move it past the (volatile) shared-memory
// loads and interleave independent products, hiding their latencies.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b, tf32 operands (f32 bit patterns with the low 13 mantissa
// bits zero), f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as hi + lo for 3xTF32: hi = x with its low 13 mantissa bits
// cleared (a tf32 value), lo = x - hi (exact in f32). The tf32 mma reads
// the top 19 bits of a register, so lo enters truncated to tf32 as
// well: hi + lo keeps about 21 of f32's 24 significant bits, and hi·hi
// + hi·lo + lo·hi is an f32 product to about 2^-20 relative. One AND
// and one FADD a value, where cvt.rna.tf32.f32 would take the
// conversion unit twice.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Two f32 values as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), x0
// in the low halves: hi + lo keeps about 16 significant bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// 2^x in one MUFU.EX2 (relative error about 2^-22; results below the
// smallest normal f32 flush to zero).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as one register of bf16 (round to nearest even), lo
// in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc
