// bgmv — decode-time batched-gather LoRA on Hopper.
//
// Replaces src/repro/kernels/bgmv.py::bgmv (body _bgmv_kernel):
//     y[b] = round_W(x[b] @ A[idx[b]]) @ B[idx[b]]
// with the rank-r intermediate accumulated in f32, rounded to the
// weights' dtype, expanded in f32 and written in x's dtype. A slot
// outside [0, n_slots) reads nothing and yields zeros.
//
// Bound: bytes. Per call the card must read x, the distinct adapters'
// A and B and write y: at Llama-7B decode width (8 tokens, 4096 wide,
// r 32) about 4 MB, 1.3 us at 3.35 TB/s, so the call is bound by
// launch latency and by how many loads are in flight.
//
// Design: one launch, no scratch tensor. Grid (C, Bt), cluster (C, 1,
// 1): each token row gets a cluster of C blocks.
//  1. Block c shrinks its slice of din: a thread reads VA consecutive
//     ranks of one A row with one 16-byte load (r 32 in bf16: 4 lanes a
//     row, 8 rows per warp instruction) and the matching x element, and
//     the row groups are summed through shared memory in a fixed order.
//  2. After cluster.sync(), every block sums the C rank-r partials
//     through distributed shared memory in split order (block 0 first,
//     so the result never changes between runs) and rounds to W.
//  3. Block c expands its slice of dout: a thread reads VB consecutive
//     columns of B rows with 16-byte loads over a subset of the ranks
//     (rows asked into L2 at the start, so these loads overlap the
//     shrink), and the rank groups are summed in a fixed order. The
//     block arrives at the cluster barrier once its remote reads are
//     done and waits on it at the end: no block leaves while its
//     partial may still be read.
// Blocks whose din or dout slice is empty still reach every barrier:
// nothing returns early.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 128;
constexpr int kMaxSplits = 16;       // above 8: non-portable cluster size
constexpr int kMaxVec = 8;           // bf16 elements in 16 bytes

// N consecutive elements as floats: one 16-byte load for N = 16 /
// sizeof(T), a scalar for N = 1.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* o);
template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float* o) {
  o[0] = *p;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* o) {
  o[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float* o) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* o) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// VA: ranks per A load (16 / sizeof(TW) when r allows it, else 1);
// VB: columns per B load (the same when dout allows it, else 1).
template <typename TX, typename TW, int VA, int VB>
__global__ void __launch_bounds__(kThreads)
bgmv_cluster(const TX* __restrict__ x, const TW* __restrict__ A,
             const TW* __restrict__ B, const int* __restrict__ idx,
             TX* __restrict__ y, int din, int r, int dout, int n_slots) {
  __shared__ float red[kThreads * kMaxVec];  // row- / rank-group sums
  __shared__ float part[kMaxRank];           // this block's shrink partial
  __shared__ float t[kMaxRank];              // the rounded intermediate
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int s = idx[b];
  const bool valid = s >= 0 && s < n_slots;

  // This block's dout slice (a multiple of VB columns), and its B rows
  // asked into L2 now, so the expand does not wait on device memory.
  const int o_len = ((dout + C - 1) / C + VB - 1) / VB * VB;
  const int o0 = min(dout, c * o_len), o1 = min(dout, o0 + o_len);
  if (valid && o1 > o0) {
    const TW* Bs = B + (size_t)s * r * dout + o0;
    const int row_bytes = (o1 - o0) * (int)sizeof(TW);
    for (int i = tid; i < r * ((row_bytes + 127) / 128); i += kThreads) {
      const int j = i % r, line = i / r;
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          reinterpret_cast<const char*>(Bs + (size_t)j * dout) +
          line * 128));
    }
  }

  // 1. Shrink this block's slice of din.
  const int d_len = (din + C - 1) / C;
  const int d0 = min(din, c * d_len), d1 = min(din, d0 + d_len);
  const int lanes_per_row = r / VA;          // r % VA == 0
  const int groups = kThreads / lanes_per_row;
  const int chunk = tid % lanes_per_row, grp = tid / lanes_per_row;
  float acc[VA];
#pragma unroll
  for (int v = 0; v < VA; ++v) acc[v] = 0.f;
  if (valid && grp < groups) {
    const TW* As = A + (size_t)s * din * r + chunk * VA;
    const TX* xr = x + (size_t)b * din;
#pragma unroll 4
    for (int d = d0 + grp; d < d1; d += groups) {
      float a[VA];
      load_vec<TW, VA>(As + (size_t)d * r, a);
      const float xv = to_f32(xr[d]);
#pragma unroll
      for (int v = 0; v < VA; ++v) acc[v] += xv * a[v];
    }
  }
  if (32 % lanes_per_row == 0) {
    // The row groups of a warp meet by a fixed butterfly of shuffles,
    // then the warps' sums in warp order.
#pragma unroll
    for (int off = lanes_per_row; off < 32; off <<= 1)
#pragma unroll
      for (int v = 0; v < VA; ++v)
        acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
    if (lane < lanes_per_row)
#pragma unroll
      for (int v = 0; v < VA; ++v) red[warp * r + lane * VA + v] = acc[v];
    __syncthreads();
    for (int j = tid; j < r; j += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) sum += red[w * r + j];
      part[j] = sum;
    }
  } else {
    if (grp < groups)
#pragma unroll
      for (int v = 0; v < VA; ++v) red[grp * r + chunk * VA + v] = acc[v];
    __syncthreads();
    for (int j = tid; j < r; j += kThreads) {
      float sum = 0.f;
      for (int g = 0; g < groups; ++g) sum += red[g * r + j];
      part[j] = sum;
    }
  }
  cluster.sync();                            // every partial ready

  // 2. The cluster's sum in split order, rounded to W: all C remote
  // reads are started before the first add.
  for (int j = tid; j < r; j += kThreads) {
    float vals[kMaxSplits];
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k)
      vals[k] = k < C ? cluster.map_shared_rank(part, k)[j] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k)
      if (k < C) sum += vals[k];
    t[j] = round_to<TW>(sum);
  }
  // Arrive now (this block's remote reads are done), wait at the end:
  // no block leaves while its partial may still be read, and the
  // expand overlaps the wait.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();                           // t ready

  // 3. Expand this block's slice of dout.
  const int n_chunks = (o1 - o0) / VB;       // dout % VB == 0
  for (int base = 0; base < n_chunks; base += kThreads) {
    const int here = min(kThreads, n_chunks - base);
    const int rank_groups = kThreads / here;
    const int ch = tid % here, rg = tid / here;
    float out[VB];
#pragma unroll
    for (int v = 0; v < VB; ++v) out[v] = 0.f;
    if (valid && rg < rank_groups) {
      const TW* Bs = B + (size_t)s * r * dout + o0 + (size_t)(base + ch) * VB;
#pragma unroll 4
      for (int j = rg; j < r; j += rank_groups) {
        float bv[VB];
        load_vec<TW, VB>(Bs + (size_t)j * dout, bv);
        const float tj = t[j];
#pragma unroll
        for (int v = 0; v < VB; ++v) out[v] += tj * bv[v];
      }
    }
    __syncthreads();                         // red free from its last use
    if (rg < rank_groups)
#pragma unroll
      for (int v = 0; v < VB; ++v) red[(rg * here + ch) * VB + v] = out[v];
    __syncthreads();
    TX* yr = y + (size_t)b * dout + o0 + (size_t)base * VB;
    for (int k = tid; k < here * VB; k += kThreads) {
      float sum = 0.f;
      for (int g = 0; g < rank_groups; ++g) sum += red[g * here * VB + k];
      yr[k] = from_f32<TX>(sum);
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename TX, typename TW, int VA, int VB>
int launch_instance(const void* x, const void* A, const void* B,
                    const void* idx, void* y, int Bt, int din, int r,
                    int dout, int n_slots, int n_split, cudaStream_t st) {
  auto kernel = bgmv_cluster<TX, TW, VA, VB>;
  if (n_split > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Bt);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TX*>(x), static_cast<const TW*>(A),
      static_cast<const TW*>(B), static_cast<const int*>(idx),
      static_cast<TX*>(y), din, r, dout, n_slots);
}

template <typename TX, typename TW>
int launch(const void* x, const void* A, const void* B, const void* idx,
           void* y, int Bt, int din, int r, int dout, int n_slots,
           int n_split, cudaStream_t st) {
  constexpr int V = 16 / sizeof(TW);
  const bool va = r % V == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool vb = dout % V == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
#define BG_ARGS x, A, B, idx, y, Bt, din, r, dout, n_slots, n_split, st
  if (va && vb) return launch_instance<TX, TW, V, V>(BG_ARGS);
  if (va) return launch_instance<TX, TW, V, 1>(BG_ARGS);
  if (vb) return launch_instance<TX, TW, 1, V>(BG_ARGS);
  return launch_instance<TX, TW, 1, 1>(BG_ARGS);
#undef BG_ARGS
}

}  // namespace

extern "C" int bgmv_launch(const void* x, const void* A, const void* B,
                           const void* idx, void* y, int Bt, int din, int r,
                           int dout, int n_slots, int n_split, int x_dtype,
                           int w_dtype, void* stream) {
  if (Bt < 1 || Bt > 65535 || din < 1 || dout < 1 || r < 1 ||
      r > kMaxRank || n_split < 1 || n_split > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
#define BG_CALL(TX, TW) \
  launch<TX, TW>(x, A, B, idx, y, Bt, din, r, dout, n_slots, n_split, st)
  if (x_dtype == DTYPE_F32 && w_dtype == DTYPE_F32)
    err = BG_CALL(float, float);
  else if (x_dtype == DTYPE_F32 && w_dtype == DTYPE_BF16)
    err = BG_CALL(float, __nv_bfloat16);
  else if (x_dtype == DTYPE_BF16 && w_dtype == DTYPE_F32)
    err = BG_CALL(__nv_bfloat16, float);
  else if (x_dtype == DTYPE_BF16 && w_dtype == DTYPE_BF16)
    err = BG_CALL(__nv_bfloat16, __nv_bfloat16);
  else
    return (int)cudaErrorInvalidValue;
#undef BG_CALL
  if (err != cudaSuccess) return err;
  return (int)cudaGetLastError();
}
