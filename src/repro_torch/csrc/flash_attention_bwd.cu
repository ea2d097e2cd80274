// flash_attention_bwd — the gradient of flash_attention on Hopper.
//
// Given q (B, S, H, dh), k and v (B, S, Kh, dh), the forward's output
// o and its gradient dO (both (B, S, H, dh)), writes dq, dk and dv in
// the inputs' dtype. The function is the gradient of the forward
// kernel's (csrc/flash_attention.cu, which replaces
// src/repro/kernels/flash_attention.py::flash_attention): scores
// scaled by dh^-0.5, causal positions kpos > qpos and keys past S
// masked, GQA by h / G. Every product and sum is f32.
//
// With P = softmax(scale * q k^T) per row, dP = dO v^T and
// D = rowsum(dO * o):
//   dS = P * (dP - D),  dq = scale * dS k,  dk = scale * dS^T q,
//   dv = P^T dO,
// dk and dv summed over the G query heads of their kv head.
//
// Bound: operations. The gradient does about 2.5 times the forward's
// 4 * B * H * S^2 * dh (halved when causal): the products Q K^T and
// dO V^T once to rebuild P and dP for dq and once for dk and dv, then
// dS K, dS^T Q and P^T dO.
//
// Design (FlashAttention-2's split, no atomics), two kernels on the
// caller's stream, each a block of 256 threads over 64 x 64 tiles,
// every thread a 4 x 4 block of scores from 16-byte shared-memory
// reads (the forward's CUDA-core layout), operands staged as f32:
// * dq kernel, one block per (64 query rows, h, b). D from the staged
//   dO and o rows; a first walk over the key tiles (to the diagonal
//   when causal) rebuilds each row's log-sum-exp with the forward's
//   online max and sum; a second walk recomputes P = exp(s - lse) and
//   dP, forms dS in shared memory and accumulates dq = dS k in
//   registers. The log-sum-exp and D go to f32 scratch for the second
//   kernel. So the forward kernel, its ABI and its timing stay as they
//   are, and o is read once.
// * dk/dv kernel, one block per (64 key rows, kv head, b), walking the
//   G query heads of the group and their query tiles (from the
//   diagonal when causal): P^T and dS^T of the tile through shared
//   memory, dv += P^T dO and dk += dS^T q in registers, so the GQA sum
//   stays inside the block.
// Three 64-row tiles and one 64 x 68 tile of shared memory a block
// (217,088 bytes at dh 256, 118,784 at dh 128): the key tile is staged again
// for each query tile rather than held, which is what lets dh 256 fit.
// Rows and keys past S are staged as zeros and masked. Tensor cores
// are a later step.
//
// Strides in elements are passed for the batch, sequence and head axes
// of every tensor; the head_dim axis is contiguous.
#include "common.cuh"

namespace {

constexpr int kTile = 64;          // query rows / key positions per tile
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr int kPs = kTile + 4;     // row stride of the score tile
constexpr float kNegInf = -1e30f;  // the forward's causal mask value

struct Strides {
  long long b, s, h;
};

// Row stride of the staged tiles: a multiple of 4 floats (16-byte
// rows) whose quarter is odd, so 8 consecutive rows start in 8
// different 4-bank groups.
__host__ __device__ __forceinline__ int tile_ld(int dh) {
  return dh + ((dh / 4) % 2 == 0 ? 4 : 8);
}

// Stage rows [s0, s0 + kTile) of one head as f32 times mul (zeros past
// S).
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

// Max / sum over the 16 threads of a half-warp (one tile row).
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

// out[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over staged tiles.
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int dh, int ld, float (&out)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < dh; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(a + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(b + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = out[i][j];
        s = fmaf(x[i].x, y[j].x, s);
        s = fmaf(x[i].y, y[j].y, s);
        s = fmaf(x[i].z, y[j].z, s);
        out[i][j] = fmaf(x[i].w, y[j].w, s);
      }
  }
}

// acc[i][g][e] += sum_s p[ty + 16 i][s] * m[s][4 tx + 64 g + e] for the
// kTile rows s of the staged tile m (row stride ld) and the score tile
// p (row stride kPs).
template <int NG>
__device__ __forceinline__ void tile_acc(const float* p, const float* m,
                                         int dh, int ld,
                                         float (&acc)[4][NG][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int s = 0; s < kTile; s += 4) {
    float pr[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 p4 = ld4(p + (ty + 16 * i) * kPs + s);
      pr[i][0] = p4.x; pr[i][1] = p4.y; pr[i][2] = p4.z; pr[i][3] = p4.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int d0 = 4 * tx + 64 * g;
        if (d0 < dh) {
          const float4 mm = ld4(m + (s + e) * ld + d0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g][0] = fmaf(pr[i][e], mm.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(pr[i][e], mm.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(pr[i][e], mm.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(pr[i][e], mm.w, acc[i][g][3]);
          }
        }
      }
    }
  }
}

template <int NG>
__device__ __forceinline__ void zero(float (&acc)[4][NG][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
}

// Rows r0 + ty + 16 i (< S) of acc into dst, in dst's dtype.
template <typename T, int NG>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, Strides st,
                                           int r0, int S, int dh,
                                           const float (&acc)[4][NG][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d0 = 4 * tx + 64 * g;
      if (d0 >= dh) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[(long long)r * st.s + d0 + e] = from_f32<T>(acc[i][g][e]);
    }
  }
}

// Whether key kpos is visible from query qpos (keys past S are not).
__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int causal) {
  return kpos < S && !(causal && kpos > qpos);
}

// ------------------------------------------------------------ dq kernel
// Grid (query tiles, H, B). Writes dq and, for rows < S, the row's
// log-sum-exp of the scaled scores and D = rowsum(dO * o) into
// lse / delta at ((b * H + h) * S + row).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, T* __restrict__ dq,
             float* __restrict__ lse_out, float* __restrict__ delta_out,
             int S, int G, int dh, Strides qst, Strides kst, Strides vst,
             Strides ost, Strides dost, Strides dqst, int causal,
             float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = tile_ld(dh);
  float* qs = smem;                    // kTile x ld, q * scale
  float* dos = qs + kTile * ld;        // kTile x ld, dO
  float* kv = dos + kTile * ld;        // kTile x ld: o, then K or V
  float* ps = kv + kTile * ld;         // kTile x kPs: dS
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, hk = h / G;
  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + hk * kst.h;
  const T* vb = v + b * vst.b + hk * vst.h;
  stage(qs, qb, qst, q0, S, dh, ld, scale);
  stage(dos, dout + b * dost.b + h * dost.h, dost, q0, S, dh, ld, 1.f);
  stage(kv, o + b * ost.b + h * ost.h, ost, q0, S, dh, ld, 1.f);
  __syncthreads();

  float delta[4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float s = 0.f;
    for (int d = 4 * tx; d < dh; d += 64) {
      const float4 a = ld4(dos + r * ld + d), c = ld4(kv + r * ld + d);
      s = fmaf(a.x, c.x, fmaf(a.y, c.y, fmaf(a.z, c.z, fmaf(a.w, c.w, s))));
    }
    delta[i] = row_sum(s);
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int q_last = min(q0 + kTile, S) - 1;
  const int n_tiles = causal ? q_last / kTile + 1 : (S + kTile - 1) / kTile;
  float sc[4][4], dp[4][4];
  // Walk 1: each row's log-sum-exp, as the forward's online softmax.
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    stage(kv, kb, kst, k0, S, dh, ld, 1.f);
    __syncthreads();
    tile_dot(qs, kv, dh, ld, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S)
          sc[i][j] = -INFINITY;
        else if (causal && kpos > qpos)
          sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(sc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = m[i] + logf(l[i]);
    const int qpos = q0 + ty + 16 * i;
    if (tx == 0 && qpos < S) {
      const long long at = ((long long)b * H + h) * S + qpos;
      lse_out[at] = lse[i];
      delta_out[at] = delta[i];
    }
  }

  // Walk 2: dq = scale * dS k (q was staged times scale, so sc is the
  // scaled score and dq takes the scale once at the store).
  float acc[4][NG][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                   // last tile's K reads are done
    stage(kv, vb, vst, k0, S, dh, ld, 1.f);
    __syncthreads();
    tile_dot(dos, kv, dh, ld, dp);
    __syncthreads();
    stage(kv, kb, kst, k0, S, dh, ld, 1.f);
    __syncthreads();
    tile_dot(qs, kv, dh, ld, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p =
            visible(qpos, kpos, S, causal) ? expf(sc[i][j] - lse[i]) : 0.f;
        ps[(ty + 16 * i) * kPs + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
    tile_acc(ps, kv, dh, ld, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] *= scale;
  store_rows(dq + b * dqst.b + h * dqst.h, dqst, q0, S, dh, acc);
}

// --------------------------------------------------------- dk/dv kernel
// Grid (key tiles, Kh, B). Reads the dq kernel's lse / delta.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse_in,
               const float* __restrict__ delta_in, T* __restrict__ dk,
               T* __restrict__ dv, int S, int G, int dh, Strides qst,
               Strides kst, Strides vst, Strides dost, Strides dkst,
               Strides dvst, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = tile_ld(dh);
  float* kvs = smem;                   // kTile x ld: K, then V
  float* qs = kvs + kTile * ld;        // kTile x ld, q * scale
  float* dos = qs + kTile * ld;        // kTile x ld, dO
  float* ps = dos + kTile * ld;        // kTile x kPs: P^T, then dS^T
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * G;
  const T* kb = k + b * kst.b + hk * kst.h;
  const T* vb = v + b * vst.b + hk * vst.h;
  const int n_q = (S + kTile - 1) / kTile;
  const int first = causal ? k0 / kTile : 0;

  float acc_k[4][NG][4], acc_v[4][NG][4];
  zero(acc_k);
  zero(acc_v);
  float sc[4][4];                      // key ty + 16 i, query tx + 16 j
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const T* qb = q + b * qst.b + h * qst.h;
    const T* dob = dout + b * dost.b + h * dost.h;
    const float* lse_h = lse_in + ((long long)b * H + h) * S;
    const float* delta_h = delta_in + ((long long)b * H + h) * S;
    for (int qt = first; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();                 // last tile's dS^T / q reads done
      stage(kvs, kb, kst, k0, S, dh, ld, 1.f);
      stage(qs, qb, qst, q0, S, dh, ld, scale);
      __syncthreads();
      tile_dot(kvs, qs, dh, ld, sc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        const float lse_j = qpos < S ? lse_h[qpos] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + ty + 16 * i;
          ps[(ty + 16 * i) * kPs + tx + 16 * j] =
              qpos < S && visible(qpos, kpos, S, causal)
                  ? expf(sc[i][j] - lse_j)
                  : 0.f;
        }
      }
      __syncthreads();                 // K reads done, P^T out
      stage(kvs, vb, vst, k0, S, dh, ld, 1.f);
      stage(dos, dob, dost, q0, S, dh, ld, 1.f);
      __syncthreads();
      tile_dot(kvs, dos, dh, ld, sc);  // dP^T
      tile_acc(ps, dos, dh, ld, acc_v);
      __syncthreads();                 // P^T reads done
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        const float delta_j = qpos < S ? delta_h[qpos] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ps[(ty + 16 * i) * kPs + tx + 16 * j] *= sc[i][j] - delta_j;
      }
      __syncthreads();
      tile_acc(ps, qs, dh, ld, acc_k); // q staged times scale: dk's scale
    }
  }
  store_rows(dk + b * dkst.b + hk * dkst.h, dkst, k0, S, dh, acc_k);
  store_rows(dv + b * dvst.b + hk * dvst.h, dvst, k0, S, dh, acc_v);
}

size_t smem_bytes(int dh) {
  return sizeof(float) * (3 * kTile * tile_ld(dh) + kTile * kPs);
}

template <typename T, int NG>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int B, int S, int H, int Kh, int dh,
           const Strides* st, int causal, cudaStream_t stream) {
  auto kdq = flash_bwd_dq<T, NG>;
  auto kdkdv = flash_bwd_dkdv<T, NG>;
  const size_t smem = smem_bytes(dh);
  // Above 48 KB a block needs the opt-in; dh 256 takes 217,088 bytes of
  // the 232,448 a block may have.
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / Kh;
  const float scale = 1.0f / sqrtf((float)dh);
  const int n_tiles = (S + kTile - 1) / kTile;
  kdq<<<dim3(n_tiles, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq), lse, delta, S, G,
      dh, st[0], st[1], st[2], st[3], st[4], st[5], causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kdkdv<<<dim3(n_tiles, Kh, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, G, dh, st[0], st[1],
      st[2], st[4], st[6], st[7], causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* o,
              const void* dout, void* dq, void* dk, void* dv, float* lse,
              float* delta, int B, int S, int H, int Kh, int dh,
              const Strides* st, int causal, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 1>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                        Kh, dh, st, causal, stream);
  if (dh <= 128)
    return launch<T, 2>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                        Kh, dh, st, causal, stream);
  return launch<T, 4>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, Kh,
                      dh, st, causal, stream);
}

}  // namespace

// Strides are in elements, (batch, sequence, head) for q, k, v, o, dO,
// dq, dk and dv in that order (24 values); the head_dim axis of every
// tensor is contiguous and dh is a multiple of 4. lse and delta are f32
// scratch of B * H * S values each, written by the first kernel and
// read by the second. Returns the CUDA error code of the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int S, int H, int Kh, int dh, const long long* strides,
    int causal, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Kh < 1 || H % Kh || dh < 4 || dh > 256 ||
      dh % 4 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == DTYPE_F32)
    return launch_dh<float>(q, k, v, o, dout, dq, dk, dv, l, dl, B, S, H,
                            Kh, dh, st, causal, s);
  if (dtype == DTYPE_BF16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl, B,
                                    S, H, Kh, dh, st, causal, s);
  return (int)cudaErrorInvalidValue;
}
