// flash_attention_bwd — the gradient of flash_attention on Hopper's
// tensor cores.
//
// Given q (B, S, H, dh), k and v (B, S, Kh, dh), the forward's output
// o, its gradient dO (both (B, S, H, dh)) and the forward's per-row
// log-sum-exp lse (f32, (B, H, S)), writes dq, dk and dv in the inputs'
// dtype. The function is the gradient of the forward kernel's
// (csrc/flash_attention.cu, which replaces
// src/repro/kernels/flash_attention.py::flash_attention; the JAX package
// differentiates einsum attention with XLA, so no Pallas kernel has a
// backward): scores scaled by dh^-0.5, causal positions kpos > qpos and
// keys past S masked, GQA by h / G. With P = exp(scale q k^T - lse),
// dP = dO v^T and D = rowsum(dO * o):
//   dS = P * (dP - D),  dq = scale * dS k,  dk = scale * dS^T q,
//   dv = P^T dO,
// dk and dv summed over the G query heads of their kv head.
//
// Bound: the gradient does about 2.5 times the forward's
// 4 * B * H * S^2 * dh operations (halved when causal), against the
// bytes of q, k, v, o and dO read and dq, dk, dv written once: the
// operations bound it from S about 1500 and in f32, the bytes in bf16
// at S 256-512 (the training shapes). This design does 3.5 times the
// forward's products (Q K^T and dO V^T once in each kernel, then dS K,
// P^T dO and dS^T Q), 5 times in bf16 (P and dS split in two), all on
// tensor cores: bf16 against 989 TFLOP/s, f32 as 3xTF32 (three TF32
// products an f32 product) against 495.
//
// Design (FlashAttention-2's split, no atomics: dq, dk and dv are the
// same bits from run to run), two kernels on the caller's stream, each
// block 4 slabs of 16 rows (a warp each; two warps each in f32 up to
// DH 128, see Cfg::kSplit); every product is mma.sync, and a score
// tile's C fragments become the A fragment of the next product in
// registers (csrc/mma.cuh):
// * dq kernel, one block per (64 query rows, h, b).
//   Q and dO stay in shared memory for the whole walk; D comes from dO
//   and o once and goes to f32 scratch for the second kernel. One walk
//   over the key tiles (to the diagonal when causal, longest blocks
//   first): S = Q K^T and dP = dO V^T, P = exp2(S scale log2e - lse
//   log2e) from the forward's lse, dS = P (dP - D), dq += dS K. K and V
//   tiles come through a cp.async double buffer: tile t + 1's copies
//   are issued right after tile t's barrier.
// * dk/dv kernel, one block per (64 key rows, kv head, b). K and V stay
//   in shared memory for the whole walk over the G query heads of the
//   group and their query tiles (from the diagonal when causal); Q, dO,
//   lse and D tiles come through a cp.async double buffer. Per tile
//   S^T = K Q^T, dP^T = V dO^T, P^T, dS^T = P^T (dP^T - D), then
//   dv += P^T dO and dk += dS^T Q in registers, so the GQA sum stays
//   inside the block.
// Arithmetic by dtype (what holds the gradients within the f32 plain
// version's tolerance):
// * bf16: m16n8k16 with f32 accumulation, fragments by ldmatrix. q, k,
//   v and dO are exact in bf16, so S and dP take one product; P and dS
//   are f32 values, each split into bf16 hi + lo (about 16 significant
//   bits) and both parts multiplied, as the forward does for P.
// * f32: 3xTF32 on m16n8k8.tf32: every operand splits as hi = x with
//   13 mantissa bits cleared and lo = x - hi (tc::split_tf32: an AND
//   and an FADD, not the conversion unit), and each product is lo·hi +
//   hi·lo + hi·hi (about 2^-20 relative; one TF32 product keeps
//   2^-11, which misses the f32 gate). Fragments by scalar shared-memory
//   loads from f32 tiles whose row stride is 4 words past a multiple of
//   32, which keeps the row-major, N-major and (with k permuted,
//   mma.cuh) K-major fragment loads free of bank conflicts. Its k loops
//   unroll partly (Cfg::kUnroll): unrolled whole, the compiler hoisted
//   many steps' loads and splits and spilled (255 registers and
//   100-500 bytes of spills in every f32 instance).
// Tiles by head width DH (dh rounded up to 32, 64, 128 or 256 and
// zero-padded in shared memory): the dq kernel walks 64-key tiles up to
// DH 128, 32-key tiles at bf16 DH 256 and 16-key tiles at f32 DH 256;
// the dk/dv kernel holds 64 key rows up to DH 128 (4 slabs of 16 rows)
// and walks 64-query tiles, 32 at bf16 DH 128 (64 ran slower there, at
// 255 registers). At DH 256 its dk and dv accumulators would need 256
// registers a thread, and resident K/V plus double-buffered Q/dO would
// exceed 227 KB in f32: it holds 32 key rows, each warp pair splitting
// the 256 columns (both compute the same 16 x 32 score tile), and walks
// 32-query tiles. Any S: rows and keys past S are zero-filled and
// masked; rows past S are not stored.
//
// Strides in elements are passed for the batch, sequence and head axes
// of every tensor; the head_dim axis is contiguous.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;          // query rows of a dq block: 4 slabs
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

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

// f32 operands as 3xTF32 on m16n8k8, fragments by scalar loads.
struct Tf32x3Ops {
  using E = float;
  static constexpr int KS = 8;
  static constexpr int kPad = 4;   // row stride DH + 4: 4 mod 32 words

  __device__ static void load_a(AFrag& a, const E* t, int ld, int k0,
                                int lane) {
    const float* p = t + (lane >> 2) * ld + k0 + (lane & 3);
    tc::split_tf32(p[0], a.hi[0], a.lo[0]);
    tc::split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
    tc::split_tf32(p[4], a.hi[2], a.lo[2]);
    tc::split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  __device__ static void load_b_n(BFrag (&b)[2], const E* t, int ld, int n0,
                                  int k0, int lane) {
    const float* p = t + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tc::split_tf32(p[8 * j * ld], b[j].hi[0], b[j].lo[0]);
      tc::split_tf32(p[8 * j * ld + 4], b[j].hi[1], b[j].lo[1]);
    }
  }
  // K-major, k permuted as a_from_c permutes it: b0 from row k0 + 2t,
  // b1 from row k0 + 2t + 1.
  __device__ static void load_b_k(BFrag (&b)[2], const E* t, int ld, int n0,
                                  int k0, int lane) {
    const float* p = t + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tc::split_tf32(p[8 * j], b[j].hi[0], b[j].lo[0]);
      tc::split_tf32(p[ld + 8 * j], b[j].hi[1], b[j].lo[1]);
    }
  }
  // k step kk (n-tile kk): (c0, c2, c1, c3), see mma.cuh.
  template <int NT>
  __device__ static void a_from_c(AFrag& a, const float (&c)[NT][4],
                                  int kk) {
    tc::split_tf32(c[kk][0], a.hi[0], a.lo[0]);
    tc::split_tf32(c[kk][2], a.hi[1], a.lo[1]);
    tc::split_tf32(c[kk][1], a.hi[2], a.lo[2]);
    tc::split_tf32(c[kk][3], a.hi[3], a.lo[3]);
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

// Tile sizes of an instance (see the note at the top).
template <class Op, int DH>
struct Cfg {
  using E = typename Op::E;
  static constexpr bool kF32 = sizeof(E) == 4;
  static constexpr int LD = DH + Op::kPad;
  static constexpr int CH = 16 / sizeof(E);     // elements a 16-byte copy
  // dq kernel: keys a tile.
  static constexpr int BK = DH < 256 ? 64 : kF32 ? 16 : 32;
  // dk/dv kernel: key rows held, column groups of warps, queries a tile.
  static constexpr int KR = DH < 256 ? 64 : 32;
  static constexpr int WC = DH < 256 ? 1 : 2;
  static constexpr int NQ = DH <= 64 || (kF32 && DH == 128) ? 64 : 32;
  static_assert((KR / 16) * WC == 4, "4 slabs of 16 rows (x WC columns)");
  // Warps a slab: in f32 up to DH 128 two, each taking half of every
  // walked tile (keys in the dq kernel, queries in the dk/dv kernel)
  // with its own partial sums, added at the end (add_parts): one block
  // fills the SM's shared memory there, and 4 warps left each scheduler
  // one warp to hide its latencies with.
  static constexpr int kSplit = kF32 && DH <= 128 ? 2 : 1;
  static constexpr int kThreads = 128 * kSplit;
  // Unrolling of the k loops: whole in bf16; in f32 by 8 at DH <= 64, 4
  // at 128 and 1 at 256, where more hoisted the next steps' loads and
  // splits into spills.
  static constexpr int kUnroll = !kF32 ? 16 : DH <= 64 ? 8 : DH <= 128 ? 4 : 1;
  static constexpr size_t dq_smem() {
    return (size_t)(2 * kRows + 4 * BK) * LD * sizeof(E) +
           kRows * sizeof(float);
  }
  static constexpr size_t dkdv_smem() {
    return (size_t)(2 * KR + 4 * NQ) * LD * sizeof(E) +
           4 * NQ * sizeof(float);
  }
};

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

// Adds the partial sums of the warps of part 1 to those of part 0 of
// the same slab through shared memory (`buf`, 4 * NC * 128 floats), in
// fragment order: conflict-free, and a fixed order of the two sums.
template <int NC>
__device__ __forceinline__ void add_parts(float (&acc)[NC][4], float* buf,
                                          int slab, int part, int lane) {
  float* b = buf + slab * NC * 128 + lane;
  if (part == 1) {
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) b[(n * 4 + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (part == 0) {
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += b[(n * 4 + e) * 32];
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// sa[NT] = A_a · B_a^T and sb[NT] = A_b · B_b^T over DH: A_* 16
// row-major rows of this warp, B_* N-major tiles of NT * 8 rows (the
// score products Q K^T and dO V^T, or K Q^T and V dO^T).
template <class Op, int DH, int LD, int NT, int UNROLL>
__device__ __forceinline__ void scores(float (&sa)[NT][4],
                                       float (&sb)[NT][4],
                                       const typename Op::E* aa,
                                       const typename Op::E* ab,
                                       const typename Op::E* ba,
                                       const typename Op::E* bb, int lane) {
  zero(sa);
  zero(sb);
#pragma unroll(UNROLL)
  for (int kk = 0; kk < DH / Op::KS; ++kk) {
    AFrag fa, fb;
    Op::load_a(fa, aa, LD, kk * Op::KS, lane);
    Op::load_a(fb, ab, LD, kk * Op::KS, lane);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      BFrag xa[2], xb[2];
      Op::load_b_n(xa, ba, LD, 16 * j, kk * Op::KS, lane);
      Op::load_b_n(xb, bb, LD, 16 * j, kk * Op::KS, lane);
      Op::mma_exact(sa[2 * j], fa, xa[0]);
      Op::mma_exact(sa[2 * j + 1], fa, xa[1]);
      Op::mma_exact(sb[2 * j], fb, xb[0]);
      Op::mma_exact(sb[2 * j + 1], fb, xb[1]);
    }
  }
}

// acc[NC] += c · M[:, col0 .. col0 + 8 NC): c a 16 x (NT * 8) score
// tile in C fragments, M a K-major tile of NT * 8 rows.
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
      Op::mma_split(acc[2 * n], a, x[0]);
      Op::mma_split(acc[2 * n + 1], a, x[1]);
    }
  }
}

// ------------------------------------------------------------ dq kernel
// Grid (query tiles, H, B). Writes dq and, for rows < S, D into
// delta at ((b * H + h) * S + row).
template <class Op, int DH>
__global__ void __launch_bounds__(Cfg<Op, DH>::kThreads)
flash_bwd_dq(const typename Op::E* __restrict__ q,
             const typename Op::E* __restrict__ k,
             const typename Op::E* __restrict__ v,
             const typename Op::E* __restrict__ o,
             const typename Op::E* __restrict__ dout,
             const float* __restrict__ lse, typename Op::E* __restrict__ dq,
             float* __restrict__ delta, int S, int G, int dh, Strides qst,
             Strides kst, Strides vst, Strides ost, Strides dost,
             Strides dqst, int causal, float scale, int vec) {
  using E = typename Op::E;
  using C = Cfg<Op, DH>;
  constexpr int LD = C::LD, BK = C::BK, SP = C::kSplit, NTHR = C::kThreads;
  constexpr int NT = BK / 8 / SP;          // n-tiles of a warp's keys
  extern __shared__ uint4 smem_dq[];
  E* qs = reinterpret_cast<E*>(smem_dq);   // kRows x LD
  E* dos = qs + kRows * LD;                 // kRows x LD
  E* kv = dos + kRows * LD;                 // 2 x (K: BK rows, V: BK rows)
  float* dsm = reinterpret_cast<float*>(kv + 4 * BK * LD);   // kRows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int slab = warp % 4, part = SP > 1 ? warp / 4 : 0;  // rows; keys
  const int koff = part * (BK / SP);
  // Causal blocks take (query tile + 1) key tiles: the longest first.
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, hk = h / G;
  const E* kb = k + b * kst.b + hk * kst.h;
  const E* vb = v + b * vst.b + hk * vst.h;
  const int q_last = min(q0 + kRows, S) - 1;
  const int n_tiles = causal ? q_last / BK + 1 : (S + BK - 1) / BK;

  if (dh < DH) zero_pad<E, DH, LD, NTHR>(qs, 2 * kRows + 4 * BK, dh);
  copy_rows<E, DH, LD, kRows, NTHR>(qs, q + b * qst.b + h * qst.h, qst.s,
                                    q0, S, dh, vec);
  copy_rows<E, DH, LD, kRows, NTHR>(dos, dout + b * dost.b + h * dost.h,
                                    dost.s, q0, S, dh, vec);
  copy_rows<E, DH, LD, BK, NTHR>(kv, kb, kst.s, 0, S, dh, vec);
  copy_rows<E, DH, LD, BK, NTHR>(kv + BK * LD, vb, vst.s, 0, S, dh, vec);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // D = rowsum(dO * o), TPR neighbouring threads a row.
  {
    constexpr int TPR = NTHR / kRows;
    const int r = tid / TPR, sub = tid % TPR;
    float s = 0.f;
    if (q0 + r < S) {
      const E* orow = o + b * ost.b + h * ost.h + (long long)(q0 + r) * ost.s;
      const E* drow = dos + r * LD;
      for (int d = sub * C::CH; d < dh; d += TPR * C::CH)
#pragma unroll
        for (int e = 0; e < C::CH; ++e)
          if (d + e < dh) s = fmaf(to_f32(drow[d + e]), to_f32(orow[d + e]), s);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (sub == 0) {
      dsm[r] = s;
      if (q0 + r < S) delta[((long long)b * H + h) * S + q0 + r] = s;
    }
  }
  __syncthreads();
  const int r_lo = slab * 16 + g;     // this thread's rows: +0, +8
  float lse2[2], dd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r_lo + 8 * hh;
    lse2[hh] = row < S ? lse[((long long)b * H + h) * S + row] * kLog2e : 0.f;
    dd[hh] = dsm[r_lo + 8 * hh];
  }
  const float scale_log2 = scale * kLog2e;
  const E* qw = qs + slab * 16 * LD;
  const E* dow = dos + slab * 16 * LD;
  float acc[DH / 8][4];
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const E* ks = kv + (t & 1) * 2 * BK * LD;
    const E* vs = ks + BK * LD;
    if (t > 0) {                       // tile 0 came with Q
      tc::cp_async_wait<0>();
      __syncthreads();                 // also: tile t - 1's buffers free
    }
    if (t + 1 < n_tiles) {
      E* nk = kv + ((t + 1) & 1) * 2 * BK * LD;
      copy_rows<E, DH, LD, BK, NTHR>(nk, kb, kst.s, k0 + BK, S, dh, vec);
      copy_rows<E, DH, LD, BK, NTHR>(nk + BK * LD, vb, vst.s, k0 + BK, S, dh,
                                     vec);
    }
    tc::cp_async_commit();

    float sc[NT][4], dp[NT][4];
    scores<Op, DH, LD, NT, C::kUnroll>(sc, dp, qw, dow, ks + koff * LD,
                                       vs + koff * LD, lane);
    // dS = P (dP - D) with P from the forward's lse; only the diagonal
    // and the ragged last tile are masked.
    const bool mask = (causal && k0 + BK - 1 > q0) || k0 + BK > S;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = tc::exp2_fast(fmaf(sc[j][e], scale_log2, -lse2[e >> 1]));
        if (mask) {
          const int kpos = k0 + koff + 8 * j + c2 + (e & 1);
          if (kpos >= S || (causal && kpos > q0 + r_lo + 8 * (e >> 1)))
            p = 0.f;
        }
        sc[j][e] = p * (dp[j][e] - dd[e >> 1]);
      }
    accumulate<Op, LD, NT, DH / 8, C::kUnroll>(acc, sc, ks + koff * LD, 0,
                                               lane);
  }
  if (SP > 1) {                        // the two halves' sums, in Q's space
    tc::cp_async_wait<0>();
    __syncthreads();
    add_parts(acc, reinterpret_cast<float*>(qs), slab, part, lane);
  }
  if (part == 0)
    store_rows(dq + b * dqst.b + h * dqst.h, dqst.s, q0 + slab * 16, 0, S,
               dh, acc, scale, vec);
}

// --------------------------------------------------------- dk/dv kernel
// Grid (key tiles, Kh, B). Reads the forward's lse and the dq kernel's
// D.
template <class Op, int DH>
__global__ void __launch_bounds__(Cfg<Op, DH>::kThreads)
flash_bwd_dkdv(const typename Op::E* __restrict__ q,
               const typename Op::E* __restrict__ k,
               const typename Op::E* __restrict__ v,
               const typename Op::E* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               typename Op::E* __restrict__ dk,
               typename Op::E* __restrict__ dv, int S, int G, int dh,
               Strides qst, Strides kst, Strides vst, Strides dost,
               Strides dkst, Strides dvst, int causal, float scale,
               int vec) {
  using E = typename Op::E;
  using C = Cfg<Op, DH>;
  constexpr int LD = C::LD, KR = C::KR, NQ = C::NQ, SP = C::kSplit;
  constexpr int NTHR = C::kThreads, NT = NQ / 8 / SP;
  constexpr int NC = DH / C::WC / 8;   // output n-tiles of a warp
  extern __shared__ uint4 smem_dkdv[];
  E* ks = reinterpret_cast<E*>(smem_dkdv);  // KR x LD
  E* vs = ks + KR * LD;                      // KR x LD
  E* qd = vs + KR * LD;                      // 2 x (Q: NQ rows, dO: NQ rows)
  float* ld_s = reinterpret_cast<float*>(qd + 4 * NQ * LD);  // 2 x 2 x NQ
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int k0 = blockIdx.x * KR, hk = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * G;
  const int slab = warp % 4, part = SP > 1 ? warp / 4 : 0;  // rows; queries
  const int kr = (slab / C::WC) * 16;          // this warp's key rows,
  const int col0 = (slab % C::WC) * (DH / C::WC);  // columns
  const int qoff = part * (NQ / SP);           // and queries of a tile
  const int first = causal ? k0 / NQ : 0;
  const int per = (S + NQ - 1) / NQ - first;   // query tiles a head
  const int total = G * per;

  // Tile i of the walk (head hk * G + i / per) into buffer `buf`.
  auto load_tile = [&](int i, int buf) {
    const int h = hk * G + i / per, q0 = (first + i % per) * NQ;
    E* qt = qd + buf * 2 * NQ * LD;
    copy_rows<E, DH, LD, NQ, NTHR>(qt, q + b * qst.b + h * qst.h, qst.s, q0,
                                   S, dh, vec);
    copy_rows<E, DH, LD, NQ, NTHR>(qt + NQ * LD,
                                   dout + b * dost.b + h * dost.h, dost.s,
                                   q0, S, dh, vec);
    const long long at = ((long long)b * H + h) * S;
    for (int x = tid; x < 2 * NQ; x += NTHR) {
      const float* src = (x < NQ ? lse : delta) + at;
      const int qpos = q0 + x % NQ;
      tc::cp_async4(ld_s + buf * 2 * NQ + x, qpos < S ? src + qpos : src,
                    qpos < S ? 4 : 0);
    }
  };

  if (dh < DH) zero_pad<E, DH, LD, NTHR>(ks, 2 * KR + 4 * NQ, dh);
  copy_rows<E, DH, LD, KR, NTHR>(ks, k + b * kst.b + hk * kst.h, kst.s, k0,
                                 S, dh, vec);
  copy_rows<E, DH, LD, KR, NTHR>(vs, v + b * vst.b + hk * vst.h, vst.s, k0,
                                 S, dh, vec);
  load_tile(0, 0);
  tc::cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  float acc_k[NC][4], acc_v[NC][4];
  zero(acc_k);
  zero(acc_v);
  for (int i = 0; i < total; ++i) {
    const int buf = i & 1, q0 = (first + i % per) * NQ;
    tc::cp_async_wait<0>();
    __syncthreads();                   // tile i in; tile i - 1's buffer free
    if (i + 1 < total) load_tile(i + 1, buf ^ 1);
    tc::cp_async_commit();
    const E* qt = qd + buf * 2 * NQ * LD;
    const E* dot = qt + NQ * LD;
    const float* ls = ld_s + buf * 2 * NQ;   // lse, then D, of the tile

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x NQ queries.
    float st[NT][4], dpt[NT][4];
    scores<Op, DH, LD, NT, C::kUnroll>(st, dpt, ks + kr * LD, vs + kr * LD,
                                       qt + qoff * LD, dot + qoff * LD,
                                       lane);
    const bool mask = (causal && q0 < k0 + KR - 1) || q0 + NQ > S;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = qoff + 8 * j + c2 + (e & 1);
        float p = tc::exp2_fast(fmaf(st[j][e], scale_log2,
                                     -ls[col] * kLog2e));
        if (mask) {
          const int qpos = q0 + col, kpos = k0 + kr + g + 8 * (e >> 1);
          if (qpos >= S || (causal && kpos > qpos)) p = 0.f;
        }
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - ls[NQ + col]);
      }
    accumulate<Op, LD, NT, NC, C::kUnroll>(acc_v, st, dot + qoff * LD, col0,
                                           lane);
    accumulate<Op, LD, NT, NC, C::kUnroll>(acc_k, dpt, qt + qoff * LD, col0,
                                           lane);
  }
  if (SP > 1) {                        // the two halves' sums, in K/V's space
    tc::cp_async_wait<0>();
    __syncthreads();
    float* buf = reinterpret_cast<float*>(ks);
    add_parts(acc_k, buf, slab, part, lane);
    add_parts(acc_v, buf + 4 * NC * 128, slab, part, lane);
  }
  if (part == 0) {
    store_rows(dk + b * dkst.b + hk * dkst.h, dkst.s, k0 + kr, col0, S, dh,
               acc_k, scale, vec);
    store_rows(dv + b * dvst.b + hk * dvst.h, dvst.s, k0 + kr, col0, S, dh,
               acc_v, 1.f, vec);
  }
}

template <class E>
bool aligned16(const void* p, Strides st) {
  constexpr long long ch = 16 / sizeof(E);
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && st.b % ch == 0 &&
         st.s % ch == 0 && st.h % ch == 0;
}

template <class Op, int DH>
int launch(const void* const* ptrs, float* lse, float* delta, int B, int S,
           int H, int Kh, int dh, const Strides* st, int causal,
           cudaStream_t stream) {
  using E = typename Op::E;
  using C = Cfg<Op, DH>;
  auto kdq = flash_bwd_dq<Op, DH>;
  auto kdkdv = flash_bwd_dkdv<Op, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dq_smem());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kdkdv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::dkdv_smem());
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies and paired stores need 16-byte aligned rows in every
  // tensor.
  int vec = 1;
  for (int i = 0; i < 8; ++i) vec &= aligned16<E>(ptrs[i], st[i]);
  const E *q = static_cast<const E*>(ptrs[0]),
          *k = static_cast<const E*>(ptrs[1]),
          *v = static_cast<const E*>(ptrs[2]),
          *o = static_cast<const E*>(ptrs[3]),
          *dout = static_cast<const E*>(ptrs[4]);
  E *dq = static_cast<E*>(const_cast<void*>(ptrs[5])),
    *dk = static_cast<E*>(const_cast<void*>(ptrs[6])),
    *dv = static_cast<E*>(const_cast<void*>(ptrs[7]));
  const int G = H / Kh;
  const float scale = 1.0f / sqrtf((float)dh);
  kdq<<<dim3((S + kRows - 1) / kRows, H, B), C::kThreads, C::dq_smem(),
        stream>>>(q, k, v, o, dout, lse, dq, delta, S, G, dh, st[0], st[1],
                  st[2], st[3], st[4], st[5], causal, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kdkdv<<<dim3((S + C::KR - 1) / C::KR, Kh, B), C::kThreads,
          C::dkdv_smem(),
          stream>>>(q, k, v, dout, lse, delta, dk, dv, S, G, dh, st[0],
                    st[1], st[2], st[4], st[6], st[7], causal, scale, vec);
  return (int)cudaGetLastError();
}

// The instance width for head_dim dh.
int width(int dh) {
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

template <class Op>
int launch_dh(const void* const* ptrs, float* lse, float* delta, int B,
              int S, int H, int Kh, int dh, const Strides* st, int causal,
              cudaStream_t s) {
  switch (width(dh)) {
    case 32:
      return launch<Op, 32>(ptrs, lse, delta, B, S, H, Kh, dh, st, causal, s);
    case 64:
      return launch<Op, 64>(ptrs, lse, delta, B, S, H, Kh, dh, st, causal, s);
    case 128:
      return launch<Op, 128>(ptrs, lse, delta, B, S, H, Kh, dh, st, causal,
                             s);
    default:
      return launch<Op, 256>(ptrs, lse, delta, B, S, H, Kh, dh, st, causal,
                             s);
  }
}

template <class Op>
size_t smem_of(int dh, int kernel) {
  switch (width(dh)) {
    case 32:
      return kernel ? Cfg<Op, 32>::dkdv_smem() : Cfg<Op, 32>::dq_smem();
    case 64:
      return kernel ? Cfg<Op, 64>::dkdv_smem() : Cfg<Op, 64>::dq_smem();
    case 128:
      return kernel ? Cfg<Op, 128>::dkdv_smem() : Cfg<Op, 128>::dq_smem();
    default:
      return kernel ? Cfg<Op, 256>::dkdv_smem() : Cfg<Op, 256>::dq_smem();
  }
}

}  // namespace

// Strides are in elements, (batch, sequence, head) for q, k, v, o, dO,
// dq, dk and dv in that order (24 values); the head_dim axis of every
// tensor is contiguous and dh is a multiple of 4. lse is the forward's
// log-sum-exp (f32, B * H * S contiguous); delta is f32 scratch of
// B * H * S values, written by the first kernel and read by the second.
// dtype DTYPE_BF16 runs the bf16 instance, DTYPE_F32 the 3xTF32 one.
// Returns the CUDA error code of the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int S, int H, int Kh, int dh,
    const long long* strides, int causal, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Kh < 1 || H % Kh || dh < 4 || dh > 256 ||
      dh % 4 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(const_cast<void*>(lse));
  float* dl = static_cast<float*>(delta);
  if (dtype == DTYPE_F32)
    return launch_dh<Tf32x3Ops>(ptrs, l, dl, B, S, H, Kh, dh, st, causal, s);
  if (dtype == DTYPE_BF16)
    return launch_dh<Bf16Ops>(ptrs, l, dl, B, S, H, Kh, dh, st, causal, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the instance for (dh, dtype), in bytes:
// kernel 0 the dq kernel, 1 the dk/dv kernel.
extern "C" int flash_attention_bwd_smem_bytes(int dh, int dtype,
                                              int kernel) {
  return (int)(dtype == DTYPE_F32 ? smem_of<Tf32x3Ops>(dh, kernel)
                                  : smem_of<Bf16Ops>(dh, kernel));
}
