// sgmv — prefill-time segmented LoRA on Hopper.
//
// Replaces src/repro/kernels/sgmv.py::sgmv (body _sgmv_kernel): for
// every tile of `tile` consecutive tokens with adapter tile_slot[t],
//     y_tile = round_W(x_tile @ A[slot]) @ B[slot]
// with f32 accumulation, the rank-r intermediate rounded to the
// weights' dtype, and the output written in x's dtype. A slot outside
// [0, n_slots) yields zeros.
//
// Bound: bytes at the engine's widths. Per call the card must read x
// (T x din), the used adapters' A and B and write y (T x dout); the
// 2 T r (din + dout) operations sit far below the bf16 ridge. So the
// design reads every byte of x once, in 16-byte copies, with many
// copies in flight.
//
// Two instances, picked by the wrapper from the dtypes alone:
//
// * Tensor cores (x, A and B all bf16: the engine's case at full
//   width). Two launches:
//   1. shrink, grid (row chunks, din splits): a block of 4 warps takes
//      up to 64 rows of one tile (rows of the next tile never enter:
//      they are zero-filled and not stored) and one slice of din. x
//      rows and the A[slot] slice stream through a 3-stage cp.async
//      ring, 64 din per stage, into padded shared memory; each warp
//      takes x·A for its 16 rows with mma.sync m16n8k16 (x through
//      ldmatrix, A through ldmatrix.trans) into f32 fragments, r
//      zero-padded to 32, 64 or 128. Each block writes its (rows, r)
//      f32 partial sums to part[split]. Splitting din over blocks gives
//      about two waves on 132 SMs even for small buckets, and each byte
//      of x is read once.
//   2. expand, grid (row chunks, 256-column tiles): a block of 8 warps
//      copies its B[slot] tile (cp.async) while it sums the partials of
//      its rows in split order (a fixed order, so results do not vary
//      between runs; 16-byte loads, several splits in flight) and
//      rounds them to bf16 in shared memory as the left operand; each
//      warp takes 16 rows x 128 columns by mma.sync; the bf16 result
//      goes through shared memory to 16-byte stores.
//   Ragged din, r and dout are masked in the kernels: copies past an
//   edge are zero-filled by cp.async itself, without a branch; a row
//   that is not 16-byte aligned is copied with scalar loads instead.
// * CUDA cores (any f32 operand): the shrink/expand pair of lora.cuh
//   with 16 rows of a tile per block. Tensor cores would round an f32
//   x to bf16 or TF32.
#include "lora.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;             // rows of one tile per block
constexpr int kKB = 64;               // din per pipeline stage
constexpr int kStages = 3;            // cp.async ring depth (shrink)
constexpr int kXld = kKB + 8;         // row stride of a staged x tile
constexpr int kShrinkThreads = 128;   // 4 warps x 16 rows
constexpr int kNB = 256;              // output columns per expand block
constexpr int kBld = kNB + 8;         // row stride of the B / y tile
constexpr int kExpandThreads = 256;   // 8 warps: 4 row groups x 2 halves

__host__ __device__ constexpr int shrink_smem(int RP) {
  return kStages * (kRows * kXld + kKB * (RP + 8)) * (int)sizeof(bf16);
}
__host__ __device__ constexpr int expand_smem(int RP) {
  return (kRows * (RP + 8) + (RP > kRows ? RP : kRows) * kBld) *
         (int)sizeof(bf16);
}

// RP: r zero-padded to 32, 64 or 128.
template <int RP>
__global__ void __launch_bounds__(kShrinkThreads)
shrink_tc(const bf16* __restrict__ x, const bf16* __restrict__ A,
          const int* __restrict__ tile_slot, float* __restrict__ part,
          int T, int tile, int din, int r, int n_slots, int split_len,
          int x_vec, int a_vec) {
  constexpr int ALD = RP + 8;
  extern __shared__ uint4 smem_tc[];
  bf16* xs = reinterpret_cast<bf16*>(smem_tc);   // kStages x kRows x kXld
  bf16* as = xs + kStages * kRows * kXld;         // kStages x kKB x ALD
  int tile_i, row0, mt;
  lora::chunk_rows(blockIdx.x, tile, kRows, &tile_i, &row0, &mt);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = tile_slot[tile_i];
  float* out = part + ((size_t)blockIdx.y * T + row0) * r;
  if (s < 0 || s >= n_slots) {
    for (int i = tid; i < mt * r; i += kShrinkThreads) out[i] = 0.f;
    return;
  }
  const int d0 = blockIdx.y * split_len;
  const int d1 = min(din, d0 + split_len);
  const int n_k = (d1 - d0 + kKB - 1) / kKB;
  const bf16* xb = x + (size_t)row0 * din;
  const bf16* Ab = A + (size_t)s * din * r;

  // One stage: 64 x rows by 64 din, 64 A rows by RP. Aligned rows go by
  // cp.async with zero fill past the tile, d1 or r (whole 16-byte
  // chunks there), others by scalar loads.
  auto load_stage = [&](int step) {
    const int buf = step % kStages, dk = d0 + step * kKB;
    bf16* xd = xs + buf * kRows * kXld;
#pragma unroll
    for (int i = tid; i < kRows * (kKB / 8); i += kShrinkThreads) {
      const int m = i / (kKB / 8), c = (i % (kKB / 8)) * 8;
      if (x_vec) {
        const bool in = m < mt && dk + c < d1;
        tc::cp_async16_zfill(xd + m * kXld + c,
                             in ? xb + (size_t)m * din + dk + c : xb, in);
      } else {
        tc::copy8_scalar(xd + m * kXld + c, xb + (size_t)m * din + dk + c,
                         m < mt ? d1 - dk - c : 0);
      }
    }
    bf16* ad = as + buf * kKB * ALD;
#pragma unroll
    for (int i = tid; i < kKB * (RP / 8); i += kShrinkThreads) {
      const int k = i / (RP / 8), c = (i % (RP / 8)) * 8;
      if (a_vec) {
        const bool in = dk + k < d1 && c < r;
        tc::cp_async16_zfill(ad + k * ALD + c,
                             in ? Ab + (size_t)(dk + k) * r + c : Ab, in);
      } else {
        tc::copy8_scalar(ad + k * ALD + c, Ab + (size_t)(dk + k) * r + c,
                         dk + k < d1 ? r - c : 0);
      }
    }
  };

  float acc[RP / 8][4];
#pragma unroll
  for (int j = 0; j < RP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load_stage(st);
    tc::cp_async_commit();
  }
  const bool active = warp * 16 < mt;  // a warp wholly past the tile idles
  for (int step = 0; step < n_k; ++step) {
    tc::cp_async_wait<kStages - 2>();  // this step's copies have landed
    __syncthreads();                   // ... for every thread; step - 1's
                                       // buffer is free for the prefetch
    if (step + kStages - 1 < n_k) load_stage(step + kStages - 1);
    tc::cp_async_commit();
    if (!active) continue;
    const int buf = step % kStages;
    const bf16* xt = xs + buf * kRows * kXld + warp * 16 * kXld;
    const bf16* at = as + buf * kKB * ALD;
#pragma unroll
    for (int kk = 0; kk < kKB; kk += 16) {
      uint32_t a[4];
      tc::load_a(a, xt, kXld, kk, lane);
#pragma unroll
      for (int j = 0; j < RP / 16; ++j) {
        uint32_t b[4];
        tc::load_b_kmajor(b, at, ALD, j * 16, kk, lane);
        tc::mma(acc[2 * j], a, b[0], b[1]);
        tc::mma(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < RP / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = warp * 16 + g + 8 * h, col = j * 8 + c2;
      if (m >= mt) continue;
      if (col < r) out[(size_t)m * r + col] = acc[j][2 * h];
      if (col + 1 < r) out[(size_t)m * r + col + 1] = acc[j][2 * h + 1];
    }
  }
}

template <int RP>
__global__ void __launch_bounds__(kExpandThreads)
expand_tc(const float* __restrict__ part, const bf16* __restrict__ B,
          const int* __restrict__ tile_slot, bf16* __restrict__ y, int T,
          int tile, int r, int dout, int n_slots, int n_split, int b_vec,
          int y_vec) {
  constexpr int TLD = RP + 8;
  extern __shared__ uint4 smem_tc[];
  bf16* ts = reinterpret_cast<bf16*>(smem_tc);  // kRows x TLD: round_W(t)
  bf16* bs = ts + kRows * TLD;  // RP x kBld: B tile, then the y tile
  int tile_i, row0, mt;
  lora::chunk_rows(blockIdx.x, tile, kRows, &tile_i, &row0, &mt);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = tile_slot[tile_i];
  const int col0 = blockIdx.y * kNB, ncol = min(kNB, dout - col0);
  bf16* yb = y + (size_t)row0 * dout + col0;
  if (s < 0 || s >= n_slots) {
    for (int i = tid; i < mt * ncol; i += kExpandThreads)
      yb[(size_t)(i / ncol) * dout + i % ncol] = __float2bfloat16(0.f);
    return;
  }
  const bf16* Bb = B + (size_t)s * r * dout + col0;
  for (int i = tid; i < RP * (kNB / 8); i += kExpandThreads) {
    const int k = i / (kNB / 8), c = (i % (kNB / 8)) * 8;
    if (b_vec) {
      const bool in = k < r && c < ncol;
      tc::cp_async16_zfill(bs + k * kBld + c,
                           in ? Bb + (size_t)k * dout + c : Bb, in);
    } else {
      tc::copy8_scalar(bs + k * kBld + c, Bb + (size_t)k * dout + c,
                       k < r ? ncol - c : 0);
    }
  }
  tc::cp_async_commit();
  // Each thread sums its elements split by split, with many loads in
  // flight instead of one chain: 16-byte loads of four ranks where r is
  // a multiple of 4 (rows of `part` are then 16-byte aligned), else
  // eight scalar loads at a time.
  const float* pb = part + (size_t)row0 * r;
  const size_t split_stride = (size_t)T * r;
  constexpr int kE4 = kRows * RP / 4 / kExpandThreads;
  if (r % 4 == 0) {
    float4 sum[kE4];
#pragma unroll
    for (int e = 0; e < kE4; ++e) sum[e] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < n_split; ++k) {
#pragma unroll
      for (int e = 0; e < kE4; ++e) {
        const int i = tid + e * kExpandThreads;
        const int m = i / (RP / 4), c = (i % (RP / 4)) * 4;
        if (m < mt && c < r) {
          const float4 v = *reinterpret_cast<const float4*>(
              pb + k * split_stride + m * r + c);
          sum[e].x += v.x;
          sum[e].y += v.y;
          sum[e].z += v.z;
          sum[e].w += v.w;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kE4; ++e) {
      const int i = tid + e * kExpandThreads;
      const int m = i / (RP / 4), c = (i % (RP / 4)) * 4;
      uint2 packed;   // round_W, W = bf16
      packed.x = tc::pack_bf16(sum[e].x, sum[e].y);
      packed.y = tc::pack_bf16(sum[e].z, sum[e].w);
      *reinterpret_cast<uint2*>(ts + m * TLD + c) = packed;
    }
  } else {
    constexpr int kE = kRows * RP / kExpandThreads;
#pragma unroll
    for (int e0 = 0; e0 < kE; e0 += 8) {
      float sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] = 0.f;
#pragma unroll 2
      for (int k = 0; k < n_split; ++k) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = tid + (e0 + e) * kExpandThreads;
          const int m = i / RP, c = i % RP;
          if (m < mt && c < r) sum[e] += pb[k * split_stride + m * r + c];
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = tid + (e0 + e) * kExpandThreads;
        ts[(i / RP) * TLD + i % RP] = __float2bfloat16(sum[e]);  // round_W
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  const int wr = warp & 3, wc = warp >> 2;   // rows 16 wr, columns 128 wc
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if (wr * 16 < mt) {
#pragma unroll
    for (int kk = 0; kk < RP; kk += 16) {
      uint32_t a[4];
      tc::load_a(a, ts + wr * 16 * TLD, TLD, kk, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b[4];
        tc::load_b_kmajor(b, bs, kBld, wc * 128 + j * 16, kk, lane);
        tc::mma(acc[2 * j], a, b[0], b[1]);
        tc::mma(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
  __syncthreads();                 // B reads done: its buffer takes y
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wr * 16 + g + 8 * h;
      *reinterpret_cast<uint32_t*>(bs + m * kBld + wc * 128 + j * 8 + c2) =
          tc::pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  __syncthreads();
  for (int i = tid; i < mt * (kNB / 8); i += kExpandThreads) {
    const int m = i / (kNB / 8), c = (i % (kNB / 8)) * 8;
    if (c >= ncol) continue;
    const bf16* src = bs + m * kBld + c;
    bf16* dst = yb + (size_t)m * dout + c;
    if (y_vec && c + 8 <= ncol) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < min(8, ncol - c); ++e) dst[e] = src[e];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int RP>
int launch_tc(const void* x, const void* A, const void* B, const void* ts,
              void* part, void* y, int T, int tile, int din, int r,
              int dout, int n_slots, int n_split, cudaStream_t stream) {
  const int n_chunks = (T / tile) * ((tile + kRows - 1) / kRows);
  // Splits are whole pipeline stages; the wrapper's count covers din
  // with every split non-empty at this length.
  const int split_len = ((din + n_split - 1) / n_split + kKB - 1) / kKB * kKB;
  auto shrink = shrink_tc<RP>;
  auto expand = expand_tc<RP>;
  cudaError_t err = cudaFuncSetAttribute(
      shrink, cudaFuncAttributeMaxDynamicSharedMemorySize, shrink_smem(RP));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(expand,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               expand_smem(RP));
  if (err != cudaSuccess) return (int)err;
  shrink<<<dim3(n_chunks, n_split), kShrinkThreads, shrink_smem(RP),
           stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(A),
                     static_cast<const int*>(ts), static_cast<float*>(part),
                     T, tile, din, r, n_slots, split_len,
                     din % 8 == 0 && aligned16(x),
                     r % 8 == 0 && aligned16(A));
  expand<<<dim3(n_chunks, (dout + kNB - 1) / kNB), kExpandThreads,
           expand_smem(RP), stream>>>(
      static_cast<const float*>(part), static_cast<const bf16*>(B),
      static_cast<const int*>(ts), static_cast<bf16*>(y), T, tile, r, dout,
      n_slots, n_split, dout % 8 == 0 && aligned16(B),
      dout % 8 == 0 && aligned16(y));
  return (int)cudaGetLastError();
}

}  // namespace

// tensor_cores = 1: the bf16 tensor-core instance (`part` holds
// n_split * T * r floats, n_split from the wrapper's tc_splits); 0: the
// CUDA-core instance of lora.cuh (any dtypes; n_split from
// lora_splits). The wrapper's sgmv_instance owns the rule that picks
// one (x, A and B all bf16). Returns the CUDA error code.
extern "C" int sgmv_launch(const void* x, const void* A, const void* B,
                           const void* tile_slot, void* part, void* y, int T,
                           int tile, int din, int r, int dout, int n_slots,
                           int n_split, int x_dtype, int w_dtype,
                           int tensor_cores, void* stream) {
  if (!tensor_cores)
    return lora::dispatch(x, A, B, tile_slot, part, y, T, tile, din, r, dout,
                          n_slots, n_split, x_dtype, w_dtype, stream);
  if (T < 1 || tile < 1 || T % tile || din < 1 || dout < 1 || r < 1 ||
      r > lora::kMaxRank || n_split < 1 || n_split > din)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r <= 32)
    return launch_tc<32>(x, A, B, tile_slot, part, y, T, tile, din, r, dout,
                         n_slots, n_split, st);
  if (r <= 64)
    return launch_tc<64>(x, A, B, tile_slot, part, y, T, tile, din, r, dout,
                         n_slots, n_split, st);
  return launch_tc<128>(x, A, B, tile_slot, part, y, T, tile, din, r, dout,
                        n_slots, n_split, st);
}

// Dynamic shared memory of the tensor-core shrink (expand = 0) or
// expand (expand = 1) at rank r, in bytes.
extern "C" int sgmv_tc_smem_bytes(int r, int expand) {
  const int rp = r <= 32 ? 32 : r <= 64 ? 64 : 128;
  return expand ? expand_smem(rp) : shrink_smem(rp);
}
