// flash_attention — causal or full GQA attention over a whole sequence
// on Hopper.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel): per (b, query head h), an online softmax over the
// keys of kv head h / G, scores scaled by dh^-0.5, causal positions
// kpos > qpos masked at -1e30, output acc / max(l, 1e-30) written in
// q's dtype. Scores, the running max and denominator and the
// accumulator are f32.
//
// Bound: bytes of q, k, v and the output at the engine's (8, 256)
// prefill bucket; operations (4 * B * H * S^2 * dh, halved when causal)
// once S reaches about a thousand positions, (1, 2048) for example.
//
// Two instances, picked by the wrapper from dtype and head_dim alone:
//
// * Tensor cores (bf16 with dh % 16 == 0, dh <= 256: the dense
//   prefill's case at full width), FlashAttention-2's layout. One block
//   of 4 warps per (64 query rows, h, b), each warp owning 16 query
//   rows; 4 warps rather than 8 keep 1024 blocks at both timed shapes.
//   Q is copied once into padded shared memory and, for dh <= 128, held
//   as mma fragments in registers (ldmatrix), so its tile becomes the
//   second V buffer: 68 KB at dh 128, three blocks an SM. K and V tiles
//   of 64 positions go through a cp.async double buffer (16-byte
//   copies): tile t + 1's copies are issued once tile t's Q·K^T
//   products are, and waited for at the top of tile t + 1, so each tile
//   has one wait and one barrier. S = Q·K^T by mma.sync m16n8k16 (bf16
//   products are exact in f32, so only the order of the f32 sums
//   differs from the Pallas kernel); the scale dh^-0.5 (with log2 e,
//   for exp2) is applied to the f32 scores. The online softmax runs in
//   registers with quad shuffles. The Pallas kernel keeps P in f32; a P
//   rounded once to bf16 would miss the all-f32 result by more than one
//   bf16 ulp, so each probability is split into p_hi = bf16(p) and
//   p_lo = bf16(p - p_hi) and O += P_hi·V + P_lo·V (V through
//   ldmatrix.trans): the error left is about 2^-16 of sum p|v|, for
//   half as many MMAs again. The score fragments are the A fragments of
//   P·V, so P never leaves registers. Causal blocks stop at the
//   diagonal tile, the only one masked (with the ragged last tile), and
//   start longest first. Rows and keys past S are zero-filled and
//   masked; query rows past S are not stored. The output goes through
//   shared memory to 16-byte stores. A dh below the instance's width
//   (32, 64, 128, 256) is zero-padded in shared memory.
// * CUDA cores (f32, or bf16 with dh % 16 != 0): one block of 256
//   threads per (64 query rows, h, b) looping over 64-position key
//   tiles staged as f32 in shared memory, each thread a 4 x 4 block of
//   scores from 16-byte shared-memory reads, row statistics by
//   half-warp shuffles, probabilities through shared memory, V in K's
//   buffer; q pre-scaled in f32 before the product. Tensor cores would
//   change f32's arithmetic.
//
// Both instances can also write each query row's log-sum-exp of the
// scaled, masked scores (m + log l of the online softmax, natural log,
// f32, (B, H, S)) for the backward kernel (csrc/flash_attention_bwd.cu):
// one f32 store a row when the caller passes the pointer, nothing when
// it passes null (the engine's prefill).
//
// Strides in elements are passed for the batch, sequence and head axes
// of every tensor; the head_dim axis is contiguous.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTile = 64;          // query rows / key positions per tile
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr int kPs = kTile + 4;     // row stride of the probability tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;
};

// Row stride of the staged Q/K/V tiles: a multiple of 4 floats (16-byte
// rows) whose quarter is odd, so 8 consecutive rows start in 8
// different 4-bank groups.
__host__ __device__ __forceinline__ int tile_ld(int dh) {
  return dh + ((dh / 4) % 2 == 0 ? 4 : 8);
}

// Stage rows [s0, s0 + kTile) of one head as f32 (zeros past S).
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      Strides st, int s0, int S, int dh,
                                      int ld, float mul) {
  for (int i = threadIdx.x; i < kTile * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    const int s = s0 + r;
    dst[r * ld + d] = s < S ? to_f32(src[(long long)s * st.s + d]) * mul : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Max / sum over the 16 threads of a half-warp (one query row).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NG: groups of 4 output columns per thread (dh <= 64 * NG).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int S, int G, int dh, Strides qst,
             Strides kst, Strides vst, Strides ost, int causal,
             float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = tile_ld(dh);
  float* qs = smem;                    // kTile x ld, pre-scaled
  float* kv = qs + kTile * ld;         // kTile x ld: K, then V, of a tile
  float* ps = kv + kTile * ld;         // kTile x kPs probabilities
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + hk * kst.h;
  const T* vb = v + b * vst.b + hk * vst.h;
  stage(qs, qb, qst, q0, S, dh, ld, scale);

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }
  const int q_last = min(q0 + kTile, S) - 1;
  const int n_tiles = causal ? q_last / kTile + 1 : (S + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                   // last tile's V reads are done
    stage(kv, kb, kst, k0, S, dh, ld, 1.f);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dh; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(qs + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ld4(kv + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc_s = sc[i][j];
          acc_s = fmaf(a[i].x, bk[j].x, acc_s);
          acc_s = fmaf(a[i].y, bk[j].y, acc_s);
          acc_s = fmaf(a[i].z, bk[j].z, acc_s);
          sc[i][j] = fmaf(a[i].w, bk[j].w, acc_s);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S)
          sc[i][j] = -INFINITY;        // no such key: probability 0
        else if (causal && kpos > qpos)
          sc[i][j] = kNegInf;          // the Pallas kernel's mask value
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * kPs + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }
    __syncthreads();                   // K reads done, probabilities out
    stage(kv, vb, vst, k0, S, dh, ld, 1.f);
    __syncthreads();
    // Keys past S have probability 0 and zero V rows: the whole tile
    // is summed.
#pragma unroll 2
    for (int s = 0; s < kTile; s += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 = ld4(ps + (ty + 16 * i) * kPs + s);
        p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int d0 = 4 * tx + 64 * g;
          if (d0 < dh) {
            const float4 vv = ld4(kv + (s + e) * ld + d0);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][g][0] = fmaf(p[i][e], vv.x, acc[i][g][0]);
              acc[i][g][1] = fmaf(p[i][e], vv.y, acc[i][g][1]);
              acc[i][g][2] = fmaf(p[i][e], vv.z, acc[i][g][2]);
              acc[i][g][3] = fmaf(p[i][e], vv.w, acc[i][g][3]);
            }
          }
        }
      }
    }
  }
  T* ob = out + b * ost.b + h * ost.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * S + qpos] = m[i] + logf(den);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d0 = 4 * tx + 64 * g;
      if (d0 >= dh) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[(long long)qpos * ost.s + d0 + e] = from_f32<T>(acc[i][g][e] / den);
    }
  }
}

size_t smem_bytes(int dh) {
  return sizeof(float) * (2 * kTile * tile_ld(dh) + kTile * kPs);
}

template <typename T, int NG>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int G, int dh, Strides qst,
           Strides kst, Strides vst, Strides ost, int causal,
           cudaStream_t stream) {
  auto kernel = flash_kernel<T, NG>;
  const size_t smem = smem_bytes(dh);
  // Above 48 KB a block needs the opt-in; the largest dh fits in 227 KB.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, G, dh, qst,
      kst, vst, ost, causal, 1.0f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int H, int G, int dh, Strides qst,
              Strides kst, Strides vst, Strides ost, int causal,
              cudaStream_t st) {
  if (dh <= 64)
    return launch<T, 1>(q, k, v, out, lse, B, S, H, G, dh, qst, kst, vst,
                        ost, causal, st);
  if (dh <= 128)
    return launch<T, 2>(q, k, v, out, lse, B, S, H, G, dh, qst, kst, vst,
                        ost, causal, st);
  return launch<T, 4>(q, k, v, out, lse, B, S, H, G, dh, qst, kst, vst, ost,
                      causal, st);
}

// ------------------------------------------------ tensor-core instance
using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;    // 4 warps x 16 query rows

// Up to DH 128 the Q fragments live in registers after the first tile,
// so Q's tile doubles as the second V buffer: four tiles, three blocks
// an SM. At DH 256 Q stays in shared memory: five tiles, one block.
__host__ __device__ constexpr bool tc_q_in_regs(int DH) {
  return DH <= 128;
}
constexpr size_t tc_smem_bytes(int DH) {
  return (size_t)(tc_q_in_regs(DH) ? 4 : 5) * kTile * (DH + 8) *
         sizeof(bf16);
}
// The instance width for head_dim dh: the products run over DH columns,
// those past dh zero-filled.
constexpr int tc_width(int dh) {
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

// Rows [s0, s0 + kTile) of one head, the first dh values of each, into
// a padded tile (row stride DH + 8); rows past S are zero. Each thread
// copies one 16-byte column chunk of every (kTcThreads / (DH / 8))-th
// row: with `vec` (16-byte aligned rows) by cp.async with zero fill and
// no branch, else by scalar loads.
template <int DH>
__device__ __forceinline__ void copy_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          long long stride, int s0, int S,
                                          int dh, bool vec) {
  constexpr int kChunks = DH / 8;               // 16-byte chunks a row
  constexpr int kStep = kTcThreads / kChunks;   // rows a pass
  const int c = (threadIdx.x % kChunks) * 8;
  const int r0 = threadIdx.x / kChunks;
  if (c >= dh) return;
  bf16* d = dst + r0 * (DH + 8) + c;
  if (vec) {
    const bf16* p = src + (long long)(s0 + r0) * stride + c;
#pragma unroll
    for (int u = 0; u < kTile / kStep; ++u) {
      const bool in = s0 + r0 + u * kStep < S;  // else row 0 is named
      tc::cp_async16_zfill(d + u * kStep * (DH + 8),
                           in ? p + u * kStep * stride : src + c, in);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kTile / kStep; ++u) {
      const int s = s0 + r0 + u * kStep;
      tc::copy8_scalar(d + u * kStep * (DH + 8),
                       src + (long long)s * stride + c, s < S ? 8 : 0);
    }
  }
}

// Zero columns [dh, DH) of n_tiles tiles, once: the copies never write
// there, so the products over the padded width add zeros.
template <int DH>
__device__ void zero_pad(bf16* tiles, int n_tiles, int dh) {
  const int pad = (DH - dh) / 8;     // 16-byte chunks per row
  for (int i = threadIdx.x; i < n_tiles * kTile * pad; i += kTcThreads)
    *reinterpret_cast<uint4*>(tiles + (i / pad) * (DH + 8) + dh +
                              (i % pad) * 8) = make_uint4(0, 0, 0, 0);
}

// Max and sum of a row's 16 values in this thread (s[j][2 h], s[j][2 h
// + 1] for j < 8) as trees, then over the quad.
__device__ __forceinline__ float row_max16(const float (&s)[8][4], int h) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = fmaxf(s[j][2 * h], s[j][2 * h + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = fmaxf(v[j], v[j + w]);
  v[0] = fmaxf(v[0], __shfl_xor_sync(0xffffffffu, v[0], 1));
  return fmaxf(v[0], __shfl_xor_sync(0xffffffffu, v[0], 2));
}
__device__ __forceinline__ float row_sum16(const float (&s)[8][4], int h) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = s[j][2 * h] + s[j][2 * h + 1];
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] += v[j + w];
  return v[0];
}

// DH: the instance width (32, 64, 128 or 256, from tc_width); the
// kernel takes any dh <= DH with dh % 16 == 0. Every loop below has
// compile-time bounds and no guard, so the compiler can issue the
// shared-memory loads of the next products ahead of this one's mma.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, tc_q_in_regs(DH) ? 3 : 1)
flash_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, bf16* __restrict__ out,
         float* __restrict__ lse, int S, int G, int dh, Strides qst,
         Strides kst, Strides vst, Strides ost, int causal,
         float scale_log2, int vec) {
  constexpr int LD = DH + 8;
  constexpr int NK = DH / 16;          // 16-wide steps over dh
  constexpr bool kQRegs = tc_q_in_regs(DH);
  constexpr uint32_t kTileBytes = kTile * LD * sizeof(bf16);
  extern __shared__ uint4 smem_fa[];
  bf16* ks = reinterpret_cast<bf16*>(smem_fa);   // 2 x kTile x LD
  bf16* vs = ks + 2 * kTile * LD;                 // 2 x kTile x LD
  bf16* qs = kQRegs ? vs + kTile * LD : vs + 2 * kTile * LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  // Causal blocks take (query tile + 1) key tiles: the longest start
  // first, so the short ones fill the last wave.
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * qst.b + h * qst.h;
  const bf16* kb = k + b * kst.b + (h / G) * kst.h;
  const bf16* vb = v + b * vst.b + (h / G) * vst.h;
  const int q_last = min(q0 + kTile, S) - 1;
  const int n_tiles = causal ? q_last / kTile + 1 : (S + kTile - 1) / kTile;

  if (dh < DH) zero_pad<DH>(ks, kQRegs ? 4 : 5, dh);
  copy_rows<DH>(qs, qb, qst.s, q0, S, dh, vec);
  copy_rows<DH>(ks, kb, kst.s, 0, S, dh, vec);
  copy_rows<DH>(vs, vb, vst.s, 0, S, dh, vec);
  tc::cp_async_commit();               // group: Q, K_0 and V_0

  // This lane's shared-memory addresses for the fragment loads of this
  // warp's 16 query rows, of K tile 0 and of V tile 0.
  const uint32_t q_addr = tc::smem_addr(qs) +
                          2 * (warp * 16 * LD + tc::lane_off_rows16(LD, lane));
  const uint32_t k_addr =
      tc::smem_addr(ks) + 2 * tc::lane_off_b_nmajor(LD, lane);
  const uint32_t v_addr =
      tc::smem_addr(vs) + 2 * tc::lane_off_rows16(LD, lane);
  const int row_lo = q0 + warp * 16 + g;  // this thread's rows: +0, +8
  uint32_t qf[kQRegs ? NK : 1][4];
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t * kTile;
    const uint32_t kt = k_addr + buf * kTileBytes;
    const uint32_t vt = v_addr + buf * kTileBytes;
    // K_t and V_t were copied during tile t - 1: one wait and one
    // barrier a tile, which also frees tile t - 1's buffers.
    tc::cp_async_wait<0>();
    __syncthreads();
    if (kQRegs && t == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        tc::ldsm_x4(qf[kQRegs ? kk : 0], q_addr + kk * 32);
      __syncthreads();                 // Q read: its tile takes V_1
    }

    // S = Q K^T for the 64 keys of the tile (the diagonal tile too: its
    // masked scores are overwritten below).
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      if (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kQRegs ? kk : 0][e];
      } else {
        tc::ldsm_x4(a, q_addr + kk * 32);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bk[4];
        tc::ldsm_x4(bk, kt + 2 * (j * 16 * LD + kk * 16));
        tc::mma(sc[2 * j], a, bk[0], bk[1]);
        tc::mma(sc[2 * j + 1], a, bk[2], bk[3]);
      }
    }
    // Prefetch tile t + 1 into the other buffers while the products
    // run: their last readers (tile t - 1) passed the barrier above.
    if (t + 1 < n_tiles) {
      copy_rows<DH>(ks + (buf ^ 1) * kTile * LD, kb, kst.s, k0 + kTile, S,
                    dh, vec);
      copy_rows<DH>(vs + (buf ^ 1) * kTile * LD, vb, vst.s, k0 + kTile, S,
                    dh, vec);
    }
    tc::cp_async_commit();

    // Mask (the diagonal and the ragged last tile only) and the online
    // softmax in the log2 domain: m is the running max of the scaled
    // scores, p = 2^(s * scale_log2 - m) in one FFMA and one EX2.
    if ((causal && t == n_tiles - 1) || k0 + kTile > S) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + c2 + (e & 1);
          if (kpos >= S)
            sc[j][e] = -INFINITY;      // no such key: probability 0
          else if (causal && kpos > row_lo + (e >> 1) * 8)
            sc[j][e] = kNegInf;        // the Pallas kernel's mask value
        }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], row_max16(sc, hh) * scale_log2);
      alpha[hh] = tc::exp2_fast(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = tc::exp2_fast(fmaf(sc[j][e], scale_log2, -m[e >> 1]));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      l[hh] = l[hh] * alpha[hh] + row_sum16(sc, hh);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P_hi·V + P_lo·V, 16 keys a step; the score fragments of keys
    // [16 kk, 16 kk + 16) are the A fragment of the step.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      tc::split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      tc::split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      tc::split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
      // The lo products follow all hi ones, so no accumulator waits on
      // the product just issued into it; at DH 256 the V fragments of a
      // step would not fit in registers and are loaded twice.
      constexpr int kHold = DH <= 128 ? NK : 1;
      uint32_t bv[kHold][4];
#pragma unroll
      for (int np = 0; np < NK; ++np) {
        uint32_t(&f)[4] = bv[kHold == 1 ? 0 : np];
        tc::ldsm_x4_trans(f, vt + 2 * (kk * 16 * LD + np * 16));
        tc::mma(o[2 * np], ph, f[0], f[1]);
        tc::mma(o[2 * np + 1], ph, f[2], f[3]);
        if (kHold == 1) {
          tc::mma(o[2 * np], pl, f[0], f[1]);
          tc::mma(o[2 * np + 1], pl, f[2], f[3]);
        }
      }
      if (kHold > 1) {
#pragma unroll
        for (int np = 0; np < NK; ++np) {
          const uint32_t(&f)[4] = bv[kHold == 1 ? 0 : np];
          tc::mma(o[2 * np], pl, f[0], f[1]);
          tc::mma(o[2 * np + 1], pl, f[2], f[3]);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = fmaxf(l[hh], 1e-30f);
    // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2.
    const int qpos = row_lo + 8 * hh;
    if (lse != nullptr && c2 == 0 && qpos < S)
      lse[((long long)b * gridDim.y + h) * S + qpos] =
          (m[hh] + log2f(l[hh])) * 0.6931471805599453f;
  }
  // The output goes through this warp's rows of the K buffer the last
  // tile did not use (read last in tile n_tiles - 2, before the last
  // barrier; nothing is copied into it since) to 16-byte stores.
  bf16* ow = ks + ((n_tiles & 1) * kTile + warp * 16) * LD;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(ow + (g + 8 * hh) * LD + n * 8 + c2) =
          tc::pack_bf16(o[n][2 * hh] / l[hh], o[n][2 * hh + 1] / l[hh]);
  __syncwarp();
  bf16* ob = out + b * ost.b + h * ost.h;
  constexpr int kChunks = DH / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int qpos = q0 + warp * 16 + r;
    if (qpos >= S || c >= dh) continue;
    const bf16* src = ow + r * LD + c;
    bf16* dst = ob + (long long)qpos * ost.s + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = src[e];
    }
  }
}

bool aligned16(const void* p, Strides st) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int H, int G, int dh, Strides qst,
              Strides kst, Strides vst, Strides ost, int causal,
              cudaStream_t stream) {
  auto kernel = flash_tc<DH>;
  const size_t smem = tc_smem_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need 16-byte aligned rows in every tensor.
  const int vec = aligned16(q, qst) && aligned16(k, kst) &&
                  aligned16(v, vst) && aligned16(out, ost);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)dh);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, G, dh,
      qst, kst, vst, ost, causal, scale_log2, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements; the head_dim axis of every tensor is
// contiguous and dh is a multiple of 4. tensor_cores = 1 takes the
// tensor-core instance, 0 the CUDA-core one: the wrapper's
// flash_instance owns that rule (bf16 with dh % 16 == 0). lse, when not
// null, receives each row's log-sum-exp (f32, B * H * S contiguous).
// Returns the CUDA error code of the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int Kh, int dh, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, int causal, int dtype, int tensor_cores, void* lse_out,
    void* stream) {
  if (B < 1 || S < 1 || H < 1 || Kh < 1 || H % Kh || dh < 4 || dh > 256 ||
      dh % 4 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qst{qsb, qss, qsh}, kst{ksb, kss, ksh}, vst{vsb, vss, vsh},
      ost{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  const int G = H / Kh;
  if (tensor_cores) {
    switch (tc_width(dh)) {
      case 32:
        return launch_tc<32>(q, k, v, out, lse, B, S, H, G, dh, qst, kst,
                             vst, ost, causal, st);
      case 64:
        return launch_tc<64>(q, k, v, out, lse, B, S, H, G, dh, qst, kst,
                             vst, ost, causal, st);
      case 128:
        return launch_tc<128>(q, k, v, out, lse, B, S, H, G, dh, qst, kst,
                              vst, ost, causal, st);
      default:
        return launch_tc<256>(q, k, v, out, lse, B, S, H, G, dh, qst, kst,
                              vst, ost, causal, st);
    }
  }
  if (dtype == DTYPE_F32)
    return launch_dh<float>(q, k, v, out, lse, B, S, H, G, dh, qst, kst, vst,
                            ost, causal, st);
  if (dtype == DTYPE_BF16)
    return launch_dh<__nv_bfloat16>(q, k, v, out, lse, B, S, H, G, dh, qst,
                                    kst, vst, ost, causal, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the tensor-core instance at head_dim dh, in
// bytes.
extern "C" int flash_attention_tc_smem_bytes(int dh) {
  return (int)tc_smem_bytes(tc_width(dh));
}
