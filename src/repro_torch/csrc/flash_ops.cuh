// Building blocks of the flash_attention kernels on Hopper's tensor
// cores, shared by the forward's tf32x3 instance
// (csrc/flash_attention.cu) and the backward (csrc/flash_attention_bwd.cu):
// operand structs that load mma.sync fragments from shared-memory tiles
// (Bf16Ops: bf16 by ldmatrix; Tf32x3Ops: f32 as 3xTF32 by scalar loads
// from tiles of row stride DH + 4, 4 mod 32 words, which keeps the
// row-major, N-major and, with k permuted (mma.cuh), K-major loads free
// of bank conflicts), the tile copies, the stores of C fragments, and
// `accumulate`, which takes each product of a score tile with a K-major
// tile into fresh registers and adds it to the accumulator by FADD: the
// tensor cores add into their accumulator with truncation, which over a
// walk of many k-steps drifts a sum toward zero (see the note at the top
// of csrc/flash_attention_bwd.cu).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace flash {

using bf16 = __nv_bfloat16;

// An A fragment (16 x KS) and a B fragment (KS x 8), with the lo parts
// of split operands (unused for exact bf16 operands).
struct AFrag {
  uint32_t hi[4], lo[4];
};
struct BFrag {
  uint32_t hi[2], lo[2];
};

// bf16 operands, m16n8k16, fragments by ldmatrix.
struct Bf16Ops {
  using E = bf16;
  static constexpr int KS = 16;    // k step of one mma
  static constexpr int kPad = 8;   // row stride DH + 8: odd 16-byte units

  // Rows [0, 16) x k [k0, k0 + 16) of a row-major tile.
  __device__ static void load_a(AFrag& a, const E* t, int ld, int k0,
                                int lane) {
    tc::ldsm_x4(a.hi, tc::smem_addr(t + tc::lane_off_rows16(ld, lane) + k0));
  }
  // n-tiles n0 and n0 + 8 at k [k0, k0 + KS) of an N-major tile (row n
  // holds k contiguous).
  __device__ static void load_b_n(BFrag (&b)[2], const E* t, int ld, int n0,
                                  int k0, int lane) {
    uint32_t r[4];
    tc::ldsm_x4(r, tc::smem_addr(t + n0 * ld + tc::lane_off_b_nmajor(ld, lane) +
                                 k0));
    b[0].hi[0] = r[0], b[0].hi[1] = r[1], b[1].hi[0] = r[2], b[1].hi[1] = r[3];
  }
  // The same of a K-major tile (row k holds n contiguous).
  __device__ static void load_b_k(BFrag (&b)[2], const E* t, int ld, int n0,
                                  int k0, int lane) {
    uint32_t r[4];
    tc::ldsm_x4_trans(
        r, tc::smem_addr(t + tc::lane_off_rows16(ld, lane) + k0 * ld + n0));
    b[0].hi[0] = r[0], b[0].hi[1] = r[1], b[1].hi[0] = r[2], b[1].hi[1] = r[3];
  }
  // k step kk of an f32 score tile held as C fragments (n-tiles 2 kk and
  // 2 kk + 1), split into bf16 hi and lo.
  template <int NT>
  __device__ static void a_from_c(AFrag& a, const float (&c)[NT][4],
                                  int kk) {
    tc::split_bf16(c[2 * kk][0], c[2 * kk][1], a.hi[0], a.lo[0]);
    tc::split_bf16(c[2 * kk][2], c[2 * kk][3], a.hi[1], a.lo[1]);
    tc::split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], a.hi[2], a.lo[2]);
    tc::split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], a.hi[3], a.lo[3]);
  }
  // Exact operands (q, k, v, dO): one product.
  __device__ static void mma_exact(float (&d)[4], const AFrag& a,
                                   const BFrag& b) {
    tc::mma(d, a.hi, b.hi[0], b.hi[1]);
  }
  // A split (P, dS): hi and lo parts.
  __device__ static void mma_split(float (&d)[4], const AFrag& a,
                                   const BFrag& b) {
    tc::mma(d, a.hi, b.hi[0], b.hi[1]);
    tc::mma(d, a.lo, b.hi[0], b.hi[1]);
  }
};

// f32 operands as 3xTF32 on m16n8k8, fragments by scalar loads; each
// value splits into tf32 hi + lo by truncation (kRound false:
// tc::split_tf32) or to nearest (kRound true: tc::split_tf32_rn).
template <bool kRound>
struct Tf32x3Split {
  using E = float;
  static constexpr int KS = 8;
  static constexpr int kPad = 4;   // row stride DH + 4: 4 mod 32 words

  __device__ static void split(float x, uint32_t& hi, uint32_t& lo) {
    if constexpr (kRound)
      tc::split_tf32_rn(x, hi, lo);
    else
      tc::split_tf32(x, hi, lo);
  }

  __device__ static void load_a(AFrag& a, const E* t, int ld, int k0,
                                int lane) {
    const float* p = t + (lane >> 2) * ld + k0 + (lane & 3);
    split(p[0], a.hi[0], a.lo[0]);
    split(p[8 * ld], a.hi[1], a.lo[1]);
    split(p[4], a.hi[2], a.lo[2]);
    split(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  __device__ static void load_b_n(BFrag (&b)[2], const E* t, int ld, int n0,
                                  int k0, int lane) {
    const float* p = t + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      split(p[8 * j * ld], b[j].hi[0], b[j].lo[0]);
      split(p[8 * j * ld + 4], b[j].hi[1], b[j].lo[1]);
    }
  }
  // K-major, k permuted as a_from_c permutes it: b0 from row k0 + 2t,
  // b1 from row k0 + 2t + 1.
  __device__ static void load_b_k(BFrag (&b)[2], const E* t, int ld, int n0,
                                  int k0, int lane) {
    const float* p = t + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      split(p[8 * j], b[j].hi[0], b[j].lo[0]);
      split(p[ld + 8 * j], b[j].hi[1], b[j].lo[1]);
    }
  }
  // k step kk (n-tile kk): (c0, c2, c1, c3), see mma.cuh.
  template <int NT>
  __device__ static void a_from_c(AFrag& a, const float (&c)[NT][4],
                                  int kk) {
    split(c[kk][0], a.hi[0], a.lo[0]);
    split(c[kk][2], a.hi[1], a.lo[1]);
    split(c[kk][1], a.hi[2], a.lo[2]);
    split(c[kk][3], a.hi[3], a.lo[3]);
  }
  // The small terms first, then hi·hi.
  __device__ static void mma_split(float (&d)[4], const AFrag& a,
                                   const BFrag& b) {
    tc::mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
    tc::mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
    tc::mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
  }
  __device__ static void mma_exact(float (&d)[4], const AFrag& a,
                                   const BFrag& b) {
    mma_split(d, a, b);
  }
};
// The backward's operands: truncated splits, which meet its gate.
struct Tf32x3Ops : Tf32x3Split<false> {};
// The forward's: splits to nearest, unbiased and closer to f32. The
// forward's f32 output feeds the f32 serving paths, where attention that
// moves by 1e-6 relative can flip the bf16 rounding of a LoRA
// intermediate downstream (PERF.md, the flash_attention rows of §6).
struct Tf32x3RnOps : Tf32x3Split<true> {};

// Rows [s0, s0 + R) of one head, the first dh values of each, into a
// tile of row stride LD; rows past S are zero. One 16-byte column chunk
// a thread and pass: with `vec` (16-byte aligned rows) by cp.async,
// whose zero fill also covers a chunk that runs past dh, else by scalar
// loads.
template <class E, int DH, int LD, int R, int kThreads>
__device__ __forceinline__ void copy_rows(E* dst, const E* __restrict__ src,
                                          long long stride, int s0, int S,
                                          int dh, bool vec) {
  constexpr int CH = 16 / sizeof(E);
  constexpr int kChunks = DH / CH;
#pragma unroll
  for (int u = 0; u < (R * kChunks + kThreads - 1) / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * CH;
    if (r >= R || c >= dh) continue;
    const int s = s0 + r, n = min(CH, dh - c);
    E* d = dst + r * LD + c;
    const E* p = src + (long long)s * stride + c;
    if (vec) {
      tc::cp_async16(d, s < S ? p : src + c, s < S ? n * (int)sizeof(E) : 0);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e)
        d[e] = s < S && e < n ? p[e] : from_f32<E>(0.f);
    }
  }
}

// Zero the columns of `rows` rows that no copy writes (from dh rounded
// up to a chunk to DH), once: the products over the padded width then
// add zeros.
template <class E, int DH, int LD, int kThreads>
__device__ void zero_pad(E* tiles, int rows, int dh) {
  constexpr int CH = 16 / sizeof(E);
  const int first = (dh + CH - 1) / CH * CH;
  const int pad = (DH - first) / CH;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads)
    *reinterpret_cast<uint4*>(tiles + (i / pad) * LD + first +
                              (i % pad) * CH) = make_uint4(0, 0, 0, 0);
}

// Columns col, col + 1 of a row: one 8- or 4-byte store with `vec`.
__device__ __forceinline__ void store_pair(float* p, float a, float b,
                                           bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b,
                                           bool vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    p[1] = __float2bfloat16(b);
  }
}

// acc (16 rows from row0 x the n-tiles from col0) times mul into rows <
// S and columns < dh of dst.
template <class E, int NC>
__device__ __forceinline__ void store_rows(E* __restrict__ dst,
                                           long long stride, int row0,
                                           int col0, int S, int dh,
                                           const float (&acc)[NC][4],
                                           float mul, bool vec) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane >> 2), c = col0 + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (r + 8 * hh < S && c + 8 * n < dh)
        store_pair(dst + (long long)(r + 8 * hh) * stride + c + 8 * n,
                   acc[n][2 * hh] * mul, acc[n][2 * hh + 1] * mul, vec);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// acc[NC] += c · M[:, col0 .. col0 + 8 NC): c a 16 x (NT * 8) score
// tile in C fragments, M a K-major tile of NT * 8 rows. Each product
// goes into fresh registers, then to acc by FADD (see the note at the
// top).
template <class Op, int LD, int NT, int NC, int UNROLL>
__device__ __forceinline__ void accumulate(float (&acc)[NC][4],
                                           const float (&c)[NT][4],
                                           const typename Op::E* m,
                                           int col0, int lane) {
#pragma unroll(UNROLL)
  for (int kk = 0; kk < NT * 8 / Op::KS; ++kk) {
    AFrag a;
    Op::a_from_c(a, c, kk);
#pragma unroll
    for (int n = 0; n < NC / 2; ++n) {
      BFrag x[2];
      Op::load_b_k(x, m, LD, col0 + 16 * n, kk * Op::KS, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        Op::mma_split(p, a, x[h]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[2 * n + h][i] += p[i];
      }
    }
  }
}

}  // namespace flash
