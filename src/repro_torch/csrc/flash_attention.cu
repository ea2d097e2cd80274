// flash_attention — causal or full GQA attention over a whole sequence
// on Hopper.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel): per (b, query head h), an online softmax over the
// keys of kv head h / G, queries scaled by dh^-0.5 before the product,
// causal positions kpos > qpos masked at -1e30, output
// acc / max(l, 1e-30) written in q's dtype. Scores, the running max and
// denominator and the accumulator are f32.
//
// Bound: at the prefill shapes of the serving path the operations (4 *
// B * H * S^2 * dh, halved when causal) outweigh the bytes of q, k, v
// and o once S reaches a few hundred positions.
//
// Design: one block of 256 threads per (tile of 64 query rows, h, b).
// The Pallas grid's sequential KV axis, which carries m, l and acc in
// VMEM scratch, becomes a loop inside the block over tiles of 64 key
// positions. Per tile: K is staged in shared memory as f32, each
// thread computes a 4 x 4 block of scores (rows ty + 16 i, columns
// tx + 16 j) from 16-byte shared-memory reads along dh (the padded row
// stride puts the 8 rows a quarter-warp reads in distinct banks); the
// row max and sum come from shuffles over the 16 threads of a
// half-warp that share a row; the probabilities go to shared memory;
// V then replaces K in the same buffer and each thread accumulates the
// column groups 4 tx + 64 g .. + 3 of its 4 rows in registers, again
// from 16-byte reads. Causal blocks stop at the tile holding their
// last query row: later tiles would only add exp(-1e30 - m) = 0.
// Ragged edges are masked here: key columns past S get probability 0
// (and zero V rows), query rows past S are computed and not stored.
// Strides in elements are passed for the batch, sequence and head
// axes; the head_dim axis is contiguous and dh % 4 == 0. CUDA cores
// only: tensor cores, TMA and split-K are later work.
#include "common.cuh"

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
             const T* __restrict__ v, T* __restrict__ out, int S, int G,
             int dh, Strides qst, Strides kst, Strides vst, Strides ost,
             int causal, float scale) {
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
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int G, int dh, Strides qst, Strides kst,
           Strides vst, Strides ost, int causal, cudaStream_t stream) {
  auto kernel = flash_kernel<T, NG>;
  const size_t smem = smem_bytes(dh);
  // Above 48 KB a block needs the opt-in; the largest dh fits in 227 KB.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, G, dh, qst, kst,
      vst, ost, causal, 1.0f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int G, int dh, Strides qst, Strides kst,
              Strides vst, Strides ost, int causal, cudaStream_t st) {
  if (dh <= 64)
    return launch<T, 1>(q, k, v, out, B, S, H, G, dh, qst, kst, vst, ost,
                        causal, st);
  if (dh <= 128)
    return launch<T, 2>(q, k, v, out, B, S, H, G, dh, qst, kst, vst, ost,
                        causal, st);
  return launch<T, 4>(q, k, v, out, B, S, H, G, dh, qst, kst, vst, ost,
                      causal, st);
}

}  // namespace

// Strides are in elements; the head_dim axis of every tensor is
// contiguous and dh is a multiple of 4. Returns the CUDA error code of
// the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int Kh, int dh, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, int causal, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Kh < 1 || H % Kh || dh < 4 || dh > 256 ||
      dh % 4 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qst{qsb, qss, qsh}, kst{ksb, kss, ksh}, vst{vsb, vss, vsh},
      ost{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Kh;
  if (dtype == DTYPE_F32)
    return launch_dh<float>(q, k, v, out, B, S, H, G, dh, qst, kst, vst, ost,
                            causal, st);
  if (dtype == DTYPE_BF16)
    return launch_dh<__nv_bfloat16>(q, k, v, out, B, S, H, G, dh, qst, kst,
                                    vst, ost, causal, st);
  return (int)cudaErrorInvalidValue;
}
