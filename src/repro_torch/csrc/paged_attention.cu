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
// Design: split-K over a thread-block cluster, in one launch. Grid
// (C, Kh, B), cluster (C, 1, 1): the C blocks of one (b, h) split the
// row's visited pages into C runs of whole pages, so a decode batch of
// B * Kh heads spreads over C times as many blocks.
//  - Within a block, each of the 4 warps takes every 4th position of
//    the block's run. A warp scores whole K rows: lane i holds elements
//    4i..4i+3 (and 4i+128.. for dh > 128) of every query row of the
//    head in registers, pre-scaled, reads the same 4 elements of the K
//    row (16 bytes in f32, 8 in bf16: one coalesced row read per warp)
//    and a butterfly of shuffles sums the dot product. Each row read
//    serves all G query rows of the head (GQA).
//  - A warp scores four rows a step (one for GQA instances, whose G
//    query rows are independent already), reducing their dot products
//    together and rescaling its running sums once a step.
//  - K and V rows reach shared memory through a per-warp cp.async ring
//    of eight rows, the next step copied while one is scored. The
//    block's page ids are read into shared memory once, so no copy
//    waits on a page-table load for its address. A lane only reads back
//    the bytes it copied itself, so the ring needs cp.async.wait_group
//    and no barrier.
//  - The online softmax (m, l, acc) is per warp; the warps of a block
//    merge once through shared memory; then, after cluster.sync(), the
//    blocks of the cluster merge once through distributed shared
//    memory, in split order (so a result never changes between runs),
//    each block producing a slice of the output.
// An empty split (a run past ceil(lengths[b] / page) pages) or an idle
// warp carries m = -inf, l = 0, acc = 0, and merges with weight 0, never
// exp(-inf - -inf). Every block reaches both cluster barriers: nothing
// returns early. A row with lengths[b] <= 0 visits every page fully
// masked (scores -1e30, not -inf), as the Pallas grid does; its output
// is then the mean of V.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Rows a warp scores per step and steps in its cp.async ring: one
// query row gets four independent rows a step (GQA instances have G
// independent chains already), and the ring keeps eight rows in flight.
__host__ __device__ constexpr int rows_per_step(int g_max) {
  return g_max >= 4 ? 1 : 4;
}
__host__ __device__ constexpr int ring_steps(int g_max) {
  return 8 / rows_per_step(g_max);
}
constexpr int kMaxG = 16;            // query rows per kv head
constexpr int kMaxDh = 256;          // two 4-element chunks per lane
constexpr int kMaxSplits = 8;        // portable cluster size
constexpr float kMasked = -1e30f;

// Four consecutive elements as floats, from global or shared memory.
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

// cp.async of one 4-element chunk: 16 bytes of f32, 8 of bf16 (dh % 4
// == 0 keeps every chunk aligned to its size).
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Weight of a partial with running max m in a merge whose max is mx:
// 0 for an empty partial (m = -inf), never exp(-inf - -inf).
__device__ __forceinline__ float merge_weight(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// Floats of one partial (m[G], l[G], acc[G * dh]).
__host__ __device__ __forceinline__ int partial_floats(int G, int dh) {
  return G * (dh + 2);
}

// G_MAX sizes the per-lane arrays (1, 4 or 16 query rows); NC is the
// number of 4-element chunks a lane holds (1 for dh <= 128, else 2).
template <typename TQ, typename TKV, int G_MAX, int NC>
__global__ void __launch_bounds__(kThreads)
paged_attn_split(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                 const TKV* __restrict__ vp,
                 const int* __restrict__ page_table,
                 const int* __restrict__ lengths, TQ* __restrict__ out,
                 int Kh, int G, int dh, int page, int P, int n_pages,
                 float scale) {
  constexpr int kRowsG = rows_per_step(G_MAX);
  constexpr int kStagesG = ring_steps(G_MAX);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunk = dh / 4;
  const int pf = partial_floats(G, dh);
  // Layout: the block's merged partial (read by the whole cluster),
  // the block's page ids, then the warps' rings, later reused for the
  // warps' partials.
  float* blk = reinterpret_cast<float*>(smem);
  int* pids = reinterpret_cast<int*>(smem + ((pf * 4 + 15) / 16) * 16);
  unsigned char* work =
      reinterpret_cast<unsigned char*>(pids) + ((P * 4 + 15) / 16) * 16;
  TKV* ring = reinterpret_cast<TKV*>(work) +
              (size_t)warp * kStagesG * kRowsG * 2 * dh;
  float* wpart = reinterpret_cast<float*>(work);

  // This lane's slice of every query row, scaled once.
  const size_t qbase = ((size_t)b * Kh + h) * G * dh;
  float qr[G_MAX][NC][4];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g)
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qr[g][i][e] = (g < G && c < n_chunk)
                          ? to_f32(q[qbase + (size_t)g * dh + 4 * c + e]) *
                                scale
                          : 0.f;
    }

  // This block's run of whole pages.
  const int len = lengths[b];
  const int n_vis = len > 0 ? min(P, (len + page - 1) / page) : P;
  const int per_split = (n_vis + n_split - 1) / n_split;
  const int p0 = min(n_vis, split * per_split);
  const int p1 = min(n_vis, p0 + per_split);
  const int t0 = p0 * page, n_rows = (p1 - p0) * page;
  const int n_mine = n_rows > warp ? (n_rows - warp + kWarps - 1) / kWarps
                                   : 0;
  // The run's page ids, loaded once: the row copies below then need no
  // dependent global load for their addresses.
  for (int i = threadIdx.x; i < p1 - p0; i += kThreads)
    pids[i] = min(max(page_table[(size_t)b * P + p0 + i], 0),
                  n_pages - 1);            // never read outside the pool
  __syncthreads();

  // Rows are copied in order: (page, row in page) of this warp's next
  // row, advanced by kWarps rows per copy, with no division per row.
  int nx = 0, nx_pg = warp / page, nx_in = warp % page;
  auto copy_step = [&](int st) {
    TKV* base = ring + (size_t)(st % kStagesG) * kRowsG * 2 * dh;
#pragma unroll
    for (int rr = 0; rr < kRowsG; ++rr) {
      if (nx < n_mine) {
        const size_t off =
            (((size_t)pids[nx_pg] * page + nx_in) * Kh + h) * dh;
        TKV* ks = base + (size_t)rr * 2 * dh;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = lane + 32 * i;
          if (c < n_chunk) {
            copy4(ks + 4 * c, kp + off + 4 * c);
            copy4(ks + dh + 4 * c, vp + off + 4 * c);
          }
        }
        ++nx;
        nx_in += kWarps;
        while (nx_in >= page) {
          nx_in -= page;
          ++nx_pg;
        }
      }
    }
  };

  const int n_steps = (n_mine + kRowsG - 1) / kRowsG;
#pragma unroll
  for (int st = 0; st < kStagesG - 1; ++st) {
    if (st < n_steps) copy_step(st);
    cp_commit();
  }
  float m_run[G_MAX], l_run[G_MAX], acc[G_MAX][NC][4];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][i][e] = 0.f;
  }
  for (int st = 0; st < n_steps; ++st) {
    if (st + kStagesG - 1 < n_steps) copy_step(st + kStagesG - 1);
    cp_commit();
    cp_wait<kStagesG - 1>();               // step st's rows have landed
    const TKV* base = ring + (size_t)(st % kStagesG) * kRowsG * 2 * dh;
    float kv[kRowsG][NC][4], vv[kRowsG][NC][4];
    bool present[kRowsG], valid[kRowsG];     // warp-uniform
#pragma unroll
    for (int rr = 0; rr < kRowsG; ++rr) {
      const int j = st * kRowsG + rr;
      present[rr] = j < n_mine;
      valid[rr] = present[rr] && t0 + warp + j * kWarps < len;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        if (present[rr] && c < n_chunk) {
          load4(base + (size_t)rr * 2 * dh + 4 * c, kv[rr][i]);
          load4(base + (size_t)rr * 2 * dh + dh + 4 * c, vv[rr][i]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) kv[rr][i][e] = vv[rr][i][e] = 0.f;
        }
      }
    }
    // The step's dot products, reduced together so the shuffles of
    // different rows and query rows overlap.
    float sc[kRowsG][G_MAX];
#pragma unroll
    for (int rr = 0; rr < kRowsG; ++rr)
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        float d = 0.f;
        if (g < G)
#pragma unroll
          for (int i = 0; i < NC; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) d += qr[g][i][e] * kv[rr][i][e];
        sc[rr][g] = d;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int rr = 0; rr < kRowsG; ++rr)
#pragma unroll
        for (int g = 0; g < G_MAX; ++g)
          if (g < G) sc[rr][g] += __shfl_xor_sync(0xffffffffu, sc[rr][g], off);
    // Online softmax: one rescale per step. A masked row scores -1e30,
    // a row past the warp's last scores -inf (weight 0); every step has
    // at least one present row, so the step's max is finite.
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g >= G) break;
      float mx = m_run[g];
#pragma unroll
      for (int rr = 0; rr < kRowsG; ++rr) {
        sc[rr][g] = valid[rr] ? sc[rr][g] : (present[rr] ? kMasked
                                                          : -INFINITY);
        mx = fmaxf(mx, sc[rr][g]);
      }
      const float alpha = expf(m_run[g] - mx);   // 0 while m is -inf
      m_run[g] = mx;
      float p[kRowsG], psum = 0.f;
#pragma unroll
      for (int rr = 0; rr < kRowsG; ++rr) {
        p[rr] = expf(sc[rr][g] - mx);
        psum += p[rr];
      }
      l_run[g] = l_run[g] * alpha + psum;
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a = acc[g][i][e] * alpha;
#pragma unroll
          for (int rr = 0; rr < kRowsG; ++rr) a += p[rr] * vv[rr][i][e];
          acc[g][i][e] = a;
        }
    }
  }
  cp_wait<0>();
  __syncthreads();                         // rings free: reuse for partials

  // Warp partials, then one merge per block in warp order.
  float* mine = wpart + (size_t)warp * pf;
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      mine[g] = m_run[g];
      mine[G + g] = l_run[g];
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < n_chunk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[2 * G + g * dh + 4 * c + e] = acc[g][i][e];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < G * dh + G; k += kThreads) {
    const int g = k < G * dh ? k / dh : k - G * dh;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wpart[w * pf + g]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* wp = wpart + w * pf;
      const float wt = merge_weight(wp[g], mx);
      sum += wt * (k < G * dh ? wp[2 * G + k] : wp[G + g]);
    }
    if (k < G * dh) {
      blk[2 * G + k] = sum;
    } else {
      blk[g] = mx;
      blk[G + g] = sum;
    }
  }
  cluster.sync();                          // every block's partial ready

  // The cluster's merge, in split order; block `split` writes every
  // n_split-th slice of kThreads output elements.
  TQ* o = out + qbase;
  for (int k = split * kThreads + threadIdx.x; k < G * dh;
       k += n_split * kThreads) {
    const int g = k / dh;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, cluster.map_shared_rank(blk, s)[g]);
    float a = 0.f, l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* rb = cluster.map_shared_rank(blk, s);
      const float wt = merge_weight(rb[g], mx);
      a += wt * rb[2 * G + k];
      l += wt * rb[G + g];
    }
    o[k] = from_f32<TQ>(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();                          // no block leaves while read
}

template <typename TQ, typename TKV, int G_MAX, int NC>
int launch_instance(const void* q, const void* kp, const void* vp,
                    const void* pt, const void* lens, void* out, int B,
                    int Kh, int G, int dh, int page, int P, int n_pages,
                    int n_split, float scale, cudaStream_t stream) {
  auto kernel = paged_attn_split<TQ, TKV, G_MAX, NC>;
  const int pf_bytes = ((partial_floats(G, dh) * 4 + 15) / 16) * 16;
  const int pid_bytes = ((P * 4 + 15) / 16) * 16;
  const int ring = kWarps * ring_steps(G_MAX) * rows_per_step(G_MAX) * 2 *
                   dh * (int)sizeof(TKV);
  const int parts = kWarps * partial_floats(G, dh) * 4;
  const int smem = pf_bytes + pid_bytes + (ring > parts ? ring : parts);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Kh, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(lens), static_cast<TQ*>(out), Kh, G, dh, page,
      P, n_pages, scale);
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* lens, void* out, int B, int Kh, int G, int dh,
           int page, int P, int n_pages, int n_split, float scale,
           cudaStream_t st) {
#define PA_ARGS q, kp, vp, pt, lens, out, B, Kh, G, dh, page, P, n_pages, \
                n_split, scale, st
  if (dh <= 128) {
    if (G <= 1) return launch_instance<TQ, TKV, 1, 1>(PA_ARGS);
    if (G <= 4) return launch_instance<TQ, TKV, 4, 1>(PA_ARGS);
    return launch_instance<TQ, TKV, kMaxG, 1>(PA_ARGS);
  }
  if (G <= 1) return launch_instance<TQ, TKV, 1, 2>(PA_ARGS);
  if (G <= 4) return launch_instance<TQ, TKV, 4, 2>(PA_ARGS);
  return launch_instance<TQ, TKV, kMaxG, 2>(PA_ARGS);
#undef PA_ARGS
}

}  // namespace

extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* lengths, void* out, int B,
                                      int Kh, int G, int dh, int page, int P,
                                      int n_pages, int n_split, int q_dtype,
                                      int kv_dtype, void* stream) {
  if (B < 1 || B > 65535 || Kh < 1 || Kh > 65535 || G < 1 || G > kMaxG ||
      dh < 4 || dh > kMaxDh || dh % 4 || page < 1 || P < 1 || n_pages < 1 ||
      n_split < 1 || n_split > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
#define PA_CALL(TQ, TKV)                                                   \
  launch<TQ, TKV>(q, k_pages, v_pages, page_table, lengths, out, B, Kh, G, \
                  dh, page, P, n_pages, n_split, scale, st)
  if (q_dtype == DTYPE_F32 && kv_dtype == DTYPE_F32)
    err = PA_CALL(float, float);
  else if (q_dtype == DTYPE_F32 && kv_dtype == DTYPE_BF16)
    err = PA_CALL(float, __nv_bfloat16);
  else if (q_dtype == DTYPE_BF16 && kv_dtype == DTYPE_F32)
    err = PA_CALL(__nv_bfloat16, float);
  else if (q_dtype == DTYPE_BF16 && kv_dtype == DTYPE_BF16)
    err = PA_CALL(__nv_bfloat16, __nv_bfloat16);
  else
    return (int)cudaErrorInvalidValue;
#undef PA_CALL
  if (err != cudaSuccess) return err;
  return (int)cudaGetLastError();
}
