// paged_attention — decode attention over the paged KV pool on Hopper.
//
// Replaces src/repro/kernels/paged_attention.py::paged_attention (body
// _paged_attn_kernel): per (batch row b, kv head h), an online softmax
// over the pages listed in page_table[b], queries scaled by dh^-0.5,
// positions >= lengths[b] masked at -1e30, output acc / max(l, 1e-30)
// written in q's dtype.
//
// Bound: bytes. The card must read each row's valid K and V once; at
// Llama-7B decode width (8 rows x 256 tokens x 32 heads x 128, f32 KV)
// that is 64 MB per call, against a few MFLOP.
//
// Design: one block of 128 threads per (b, h). The Pallas grid steps
// through one page at a time; here a block takes 128 positions (8
// pages of 16) per round, so a 256-token row is two rounds. Per round:
// thread j scores position j for every query row g with 16-byte loads
// along its K row (q sits in shared memory); a block reduction gives
// the round's max; each thread turns its scores into probabilities;
// then thread d accumulates the V column d (coalesced across threads)
// for the round's positions in registers, after rescaling by
// exp(m_old - m_new). The block walks only ceil(lengths[b] / page)
// pages: the fully masked pages the Pallas grid also visits add
// exactly nothing. A row with lengths[b] <= 0 visits every page fully
// masked, as the Pallas grid does (the output is then the mean of V).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;        // positions per round
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;            // query rows per kv head
constexpr int kMaxDh = 256;          // 2 V columns per thread
constexpr float kNegInf = -1e30f;

// Four consecutive elements as floats (16-byte aligned for f32,
// 8-byte aligned for bf16; dh % 4 == 0 keeps every row so).
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  o[0] = fa.x; o[1] = fa.y; o[2] = fb.x; o[3] = fb.y;
}

// Block-wide max / sum of one value per thread (every thread gets it).
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                       // scratch free from last use
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

// G_MAX sizes the per-thread arrays: 2 covers MHA and G = 2 models
// in few registers, 16 the rest.
template <typename TQ, typename TKV, int G_MAX>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                  const TKV* __restrict__ vp,
                  const int* __restrict__ page_table,
                  const int* __restrict__ lengths, TQ* __restrict__ out,
                  int Kh, int G, int dh, int page, int P, int n_pages,
                  float scale) {
  __shared__ float qs[G_MAX * kMaxDh];
  __shared__ float probs[G_MAX * kThreads];
  __shared__ size_t rowoff[kThreads];    // element offset of (pos, h)
  __shared__ float scratch[kWarps];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const size_t qbase = ((size_t)b * Kh + h) * G * dh;
  for (int i = tid; i < G * dh; i += kThreads)
    qs[i] = to_f32(q[qbase + i]) * scale;
  const int len = lengths[b];
  const int n_tok = (len > 0 ? min(P, (len + page - 1) / page) : P) * page;
  float m_run[G_MAX], l_run[G_MAX], acc[G_MAX][2];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
    acc[g][0] = acc[g][1] = 0.f;
  }
  __syncthreads();
  for (int t0 = 0; t0 < n_tok; t0 += kThreads) {
    // Scores: thread tid takes position t0 + tid.
    const int pos = t0 + tid;
    const bool present = pos < n_tok;
    const bool valid = present && pos < len;
    float s[G_MAX];
    size_t off = 0;
    if (present) {
      int pid = page_table[(size_t)b * P + pos / page];
      pid = min(max(pid, 0), n_pages - 1);  // never read outside the pool
      off = (((size_t)pid * page + pos % page) * Kh + h) * dh;
    }
    rowoff[tid] = off;
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) s[g] = 0.f;
    if (valid) {
      const TKV* krow = kp + off;
#pragma unroll 8
      for (int i = 0; i < dh; i += 4) {
        float k4[4];
        load4(krow + i, k4);
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) {
          if (g < G) {
            const float* qg = qs + g * dh + i;
            s[g] += qg[0] * k4[0] + qg[1] * k4[1] + qg[2] * k4[2] +
                    qg[3] * k4[3];
          }
        }
      }
    }
    // Online softmax over this round, one query row at a time.
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g >= G) break;
      const float sc = valid ? s[g] : kNegInf;
      const float m_new =
          fmaxf(m_run[g], block_reduce<true>(present ? sc : -INFINITY,
                                             scratch));
      const float p = present ? expf(sc - m_new) : 0.f;
      probs[g * kThreads + tid] = p;
      const float alpha = expf(m_run[g] - m_new);
      l_run[g] = l_run[g] * alpha + block_reduce<false>(p, scratch);
      m_run[g] = m_new;
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
    }
    __syncthreads();                     // probs and rowoff complete
    // P @ V: thread tid owns columns tid and tid + 128.
    const int n_here = min(kThreads, n_tok - t0);
#pragma unroll 16
    for (int j = 0; j < n_here; ++j) {
      const TKV* vrow = vp + rowoff[j];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int d = tid + k * kThreads;
        if (d < dh) {
          const float v = to_f32(vrow[d]);
#pragma unroll
          for (int g = 0; g < G_MAX; ++g)
            if (g < G) acc[g][k] += probs[g * kThreads + j] * v;
        }
      }
    }
    __syncthreads();                     // before the next round rewrites
  }
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g >= G) break;
    const float l = fmaxf(l_run[g], 1e-30f);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int d = tid + k * kThreads;
      if (d < dh) out[qbase + (size_t)g * dh + d] = from_f32<TQ>(acc[g][k] / l);
    }
  }
}

template <typename TQ, typename TKV>
void launch(const void* q, const void* kp, const void* vp, const void* pt,
            const void* lens, void* out, int B, int Kh, int G, int dh,
            int page, int P, int n_pages, float scale, cudaStream_t stream) {
  auto kernel = G <= 2 ? paged_attn_kernel<TQ, TKV, 2>
                       : paged_attn_kernel<TQ, TKV, kMaxG>;
  kernel<<<dim3(B, Kh), kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(lens), static_cast<TQ*>(out), Kh, G, dh, page,
      P, n_pages, scale);
}

}  // namespace

extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* lengths, void* out, int B,
                                      int Kh, int G, int dh, int page, int P,
                                      int n_pages, int q_dtype, int kv_dtype,
                                      void* stream) {
  if (B < 1 || Kh < 1 || G < 1 || G > kMaxG || dh < 4 || dh > kMaxDh ||
      dh % 4 || page < 1 || P < 1 || n_pages < 1)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == DTYPE_F32 && kv_dtype == DTYPE_F32)
    launch<float, float>(q, k_pages, v_pages, page_table, lengths, out, B, Kh,
                         G, dh, page, P, n_pages, scale, st);
  else if (q_dtype == DTYPE_F32 && kv_dtype == DTYPE_BF16)
    launch<float, __nv_bfloat16>(q, k_pages, v_pages, page_table, lengths, out,
                                 B, Kh, G, dh, page, P, n_pages, scale, st);
  else if (q_dtype == DTYPE_BF16 && kv_dtype == DTYPE_F32)
    launch<__nv_bfloat16, float>(q, k_pages, v_pages, page_table, lengths, out,
                                 B, Kh, G, dh, page, P, n_pages, scale, st);
  else if (q_dtype == DTYPE_BF16 && kv_dtype == DTYPE_BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, page_table,
                                         lengths, out, B, Kh, G, dh, page, P,
                                         n_pages, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
