// Shrink and expand kernels of sgmv's CUDA-core instance (prefill;
// bgmv has its own one-launch kernel in bgmv.cu).
//
// Both compute, for rows grouped into tiles of `tile` consecutive
// tokens where tile i uses adapter slot tile_slot[i],
//     y[m] = round_W(x[m] @ A[slot]) @ B[slot]
// with f32 accumulation and the rank-r intermediate rounded to the
// weights' dtype W, as the Pallas kernels do.
//
// Bound: bytes (x, the used adapters' A and B, y); at r <= 128 the
// 2·T·r·(din + dout) operations sit far below the bf16 ridge, so the
// design is about keeping many independent loads in flight:
//
// 1. lora_shrink, grid (row chunks, din splits): a block takes up to
//    M = 16 rows of one tile and one slice of din. Thread (g, c) walks
//    rows d = g, g + G, ... of its slice (G = 256 / r row groups), reading
//    A[slot, d, c] (a warp reads one contiguous A row) and x[m, d]
//    (a broadcast within the warp), keeping M running sums. The row
//    groups are summed through shared memory and each block writes its
//    (M, r) f32 partial sums to `part[split]`. Splitting din over
//    blocks is what fills the card when there are only 8 tokens.
// 2. lora_expand, grid (row chunks, 256-column tiles): a block sums
//    the partials of its rows in split order (a fixed order, so the
//    result does not change between runs), rounds them to W into
//    shared memory, and each thread produces one output column for the
//    chunk's rows, reading B[slot, c, col] once for all M rows.
//
// A slot outside [0, n_slots) reads nothing and yields zeros.
#pragma once

#include "common.cuh"

namespace lora {

constexpr int kThreads = 256;
constexpr int kMaxRank = 128;
// Rows per block: up to 16 rows of one tile share the slot's A and B
// reads.
constexpr int M = 16;

// Chunk `chunk` of `rows` rows: its tile, first row and row count (the
// tensor-core instance in sgmv.cu uses it with its own rows a block).
__device__ __forceinline__ void chunk_rows(int chunk, int tile, int rows,
                                           int* tile_i, int* row0,
                                           int* mt) {
  const int per_tile = (tile + rows - 1) / rows;
  *tile_i = chunk / per_tile;
  const int j = chunk - *tile_i * per_tile;
  *row0 = *tile_i * tile + j * rows;
  *mt = min(rows, tile - j * rows);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
lora_shrink(const TX* __restrict__ x, const TW* __restrict__ A,
            const int* __restrict__ tile_slot, float* __restrict__ part,
            int T, int tile, int din, int r, int n_slots, int split_len) {
  __shared__ float red[M * kThreads];
  int tile_i, row0, mt;
  chunk_rows(blockIdx.x, tile, M, &tile_i, &row0, &mt);
  const int tid = threadIdx.x;
  const int s = tile_slot[tile_i];
  const int G = kThreads / r;
  const int g = tid / r, c = tid - (tid / r) * r;
  const int d0 = blockIdx.y * split_len;
  const int d1 = min(din, d0 + split_len);
  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;
  if (s >= 0 && s < n_slots && g < G) {
    const TW* As = A + (size_t)s * din * r + c;
    const TX* xr = x + (size_t)row0 * din;
#pragma unroll 8
    for (int d = d0 + g; d < d1; d += G) {
      const float a = to_f32(As[(size_t)d * r]);
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (m < mt) acc[m] += to_f32(xr[(size_t)m * din + d]) * a;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) red[m * kThreads + tid] = acc[m];
  __syncthreads();
  float* out = part + ((size_t)blockIdx.y * T + row0) * r;
  for (int i = tid; i < mt * r; i += kThreads) {
    const int m = i / r, cc = i - (i / r) * r;
    float sum = 0.f;
    for (int gg = 0; gg < G; ++gg) sum += red[m * kThreads + gg * r + cc];
    out[(size_t)m * r + cc] = sum;
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
lora_expand(const float* __restrict__ part, const TW* __restrict__ B,
            const int* __restrict__ tile_slot, TX* __restrict__ y, int T,
            int tile, int r, int dout, int n_slots, int n_split) {
  __shared__ __align__(16) float t[M * kMaxRank];
  int tile_i, row0, mt;
  chunk_rows(blockIdx.x, tile, M, &tile_i, &row0, &mt);
  const int tid = threadIdx.x;
  const int s = tile_slot[tile_i];
  const bool valid = s >= 0 && s < n_slots;
  for (int i = tid; i < mt * r; i += kThreads) {
    float sum = 0.f;
    for (int k = 0; k < n_split; ++k)
      sum += part[((size_t)k * T + row0) * r + i];
    t[i] = round_to<TW>(sum);
  }
  __syncthreads();
  const int col = blockIdx.y * kThreads + tid;
  if (col >= dout) return;
  float out[M];
#pragma unroll
  for (int m = 0; m < M; ++m) out[m] = 0.f;
  if (valid) {
    const TW* Bs = B + (size_t)s * r * dout + col;
    int c = 0;
    if (r % 4 == 0) {    // four ranks a step: one 16-byte read of t per row
      for (; c < r; c += 4) {
        float bv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = to_f32(Bs[(size_t)(c + k) * dout]);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          if (m < mt) {
            const float4 tv = *reinterpret_cast<const float4*>(t + m * r + c);
            out[m] += tv.x * bv[0] + tv.y * bv[1] + tv.z * bv[2] +
                      tv.w * bv[3];
          }
        }
      }
    }
    for (; c < r; ++c) {
      const float bv = to_f32(Bs[(size_t)c * dout]);
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (m < mt) out[m] += t[m * r + c] * bv;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (m < mt) y[(size_t)(row0 + m) * dout + col] = from_f32<TX>(out[m]);
}

template <typename TX, typename TW>
int launch(const void* x, const void* A, const void* B, const void* ts,
           void* part, void* y, int T, int tile, int din, int r, int dout,
           int n_slots, int n_split, cudaStream_t stream) {
  const int n_chunks = (T / tile) * ((tile + M - 1) / M);
  const int split_len = (din + n_split - 1) / n_split;
  lora_shrink<TX, TW><<<dim3(n_chunks, n_split), kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(A),
      static_cast<const int*>(ts), static_cast<float*>(part), T, tile, din,
      r, n_slots, split_len);
  lora_expand<TX, TW>
      <<<dim3(n_chunks, (dout + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(static_cast<const float*>(part),
                   static_cast<const TW*>(B), static_cast<const int*>(ts),
                   static_cast<TX*>(y), T, tile, r, dout, n_slots, n_split);
  return (int)cudaGetLastError();
}

inline int dispatch_dtypes(const void* x, const void* A, const void* B,
                           const void* ts, void* part, void* y, int T,
                           int tile, int din, int r, int dout, int n_slots,
                           int n_split, int x_dtype, int w_dtype,
                           cudaStream_t st) {
  if (x_dtype == DTYPE_F32 && w_dtype == DTYPE_F32)
    return launch<float, float>(x, A, B, ts, part, y, T, tile, din, r, dout,
                                n_slots, n_split, st);
  if (x_dtype == DTYPE_F32 && w_dtype == DTYPE_BF16)
    return launch<float, __nv_bfloat16>(x, A, B, ts, part, y, T, tile, din,
                                        r, dout, n_slots, n_split, st);
  if (x_dtype == DTYPE_BF16 && w_dtype == DTYPE_F32)
    return launch<__nv_bfloat16, float>(x, A, B, ts, part, y, T, tile, din,
                                        r, dout, n_slots, n_split, st);
  if (x_dtype == DTYPE_BF16 && w_dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        x, A, B, ts, part, y, T, tile, din, r, dout, n_slots, n_split, st);
  return (int)cudaErrorInvalidValue;
}

// `part` holds n_split * T * r floats.
inline int dispatch(const void* x, const void* A, const void* B,
                    const void* ts, void* part, void* y, int T, int tile,
                    int din, int r, int dout, int n_slots, int n_split,
                    int x_dtype, int w_dtype, void* stream) {
  if (T < 1 || tile < 1 || T % tile || din < 1 || dout < 1 || r < 1 ||
      r > kMaxRank || n_split < 1 || n_split > din)
    return (int)cudaErrorInvalidValue;
  return dispatch_dtypes(x, A, B, ts, part, y, T, tile, din, r, dout,
                         n_slots, n_split, x_dtype, w_dtype,
                         static_cast<cudaStream_t>(stream));
}

}  // namespace lora
