// Paged attention for Hopper (sm_90a): S query tokens per request over the
// serving engine's paged KV pool, read in place through the block table.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py, `paged_attention`
// (Pallas body `_paged_kernel`).
//
// Computes, for request b, query row j (logical position pos[b] + j) and
// query head h (KV head h / G):
//   softmax_kv( q . k * hd^-0.5, masked where kv position > query position )
//   . v
// over the first `n_vis` columns of the request's block table; kv position
// of (column kb, offset t) is kb * BS + t.  Stale table entries point at the
// trash block, whose positions are all in the future, so the one mask rule
// covers tail blocks, causality inside a chunk and stale rows.  Online
// softmax, masking and accumulation are in f32.
//
// Bound on this card: bytes.  Each visible KV block is read once from HBM
// (sum_b ctx_b * K * hd * 2 * sizeof(pool)); the arithmetic is ~2 flops a
// byte.  The TPU grid (B*H, n_vis) reads every block once per query head,
// G = 12 times for starcoder2's GQA.  Here one CTA serves one (request,
// KV head, tile of 16 query rows): it stages each K/V block in shared
// memory once and all G heads x S rows of the tile read it from there.
// The CTA reads its own table entries and stops at the block past its last
// query position, so blocks wholly in the future are never loaded.  Each
// warp owns 4 query rows; a lane holds hd/32 dims of q and of the
// accumulator, and a score is a warp-wide dot product.  No split over the
// KV axis yet: a decode tick of 8 requests x 2 KV heads launches 16 CTAs.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;

template <typename QT, typename PoolT, int HD, int BS>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const QT* __restrict__ q, const PoolT* __restrict__ k_pool,
                       const PoolT* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ pos, QT* __restrict__ out, int S, int H,
                       int K, int MB, int n_vis, float scale) {
  constexpr int D = HD / 32;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int rows = S * G;                       // (query token, head) pairs
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerCta;

  __shared__ float ks[BS][HD];
  __shared__ float vs[BS][HD];

  const int p0 = pos[b];
  const int last_row = min(row0 + kRowsPerCta, rows) - 1;
  const int n_blocks = min(n_vis, (p0 + last_row / G) / BS + 1);

  float qv[kRowsPerWarp][D], acc[kRowsPerWarp][D], m[kRowsPerWarp], l[kRowsPerWarp];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    const bool live = row < rows;
    const int s = live ? row / G : 0;
    const int h = kh * G + (live ? row % G : 0);
    const QT* qp = q + ((size_t)(b * S + s) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      qv[r][i] = live ? port::to_f32(qp[lane + 32 * i]) : 0.f;
      acc[r][i] = 0.f;
    }
    qpos[r] = p0 + s;
    m[r] = port::kMaskValue;
    l[r] = 0.f;
  }

  for (int kb = 0; kb < n_blocks; ++kb) {
    const size_t phys = (size_t)tables[b * MB + kb];
    __syncthreads();                            // previous block consumed
    for (int e = threadIdx.x; e < BS * HD; e += kWarps * 32) {
      const int t = e / HD, d = e % HD;
      const size_t off = ((phys * BS + t) * K + kh) * HD + d;
      ks[t][d] = port::to_f32(k_pool[off]);
      vs[t][d] = port::to_f32(v_pool[off]);
    }
    __syncthreads();

    float sc[kRowsPerWarp][BS];
#pragma unroll
    for (int t = 0; t < BS; ++t) {
      float kv[D];
#pragma unroll
      for (int i = 0; i < D; ++i) kv[i] = ks[t][lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) part += qv[r][i] * kv[i];
        part = port::warp_sum(part);
        sc[r][t] = (kb * BS + t <= qpos[r]) ? part * scale : port::kMaskValue;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float mx = m[r];
#pragma unroll
      for (int t = 0; t < BS; ++t) mx = fmaxf(mx, sc[r][t]);
      const float corr = expf(m[r] - mx);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < BS; ++t) {
        sc[r][t] = expf(sc[r][t] - mx);
        psum += sc[r][t];
      }
      l[r] = l[r] * corr + psum;
      m[r] = mx;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float pv = 0.f;
#pragma unroll
        for (int t = 0; t < BS; ++t) pv += sc[r][t] * vs[t][lane + 32 * i];
        acc[r][i] = acc[r][i] * corr + pv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= rows) continue;
    const int s = row / G, h = kh * G + row % G;
    QT* op = out + ((size_t)(b * S + s) * H + h) * HD;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < D; ++i) op[lane + 32 * i] = port::from_f32<QT>(acc[r][i] / denom);
  }
}

template <typename QT, typename PoolT, int HD, int BS>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                   const void* pos, void* out, int B, int S, int H, int K, int MB, int n_vis,
                   float scale, cudaStream_t stream) {
  const int rows = S * (H / K);
  dim3 grid((rows + kRowsPerCta - 1) / kRowsPerCta, K, B);
  paged_attention_kernel<QT, PoolT, HD, BS><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const PoolT*>(k_pool),
      static_cast<const PoolT*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<QT*>(out), S, H, K, MB, n_vis, scale);
  return cudaGetLastError();
}

template <typename QT, typename PoolT>
cudaError_t dispatch_shape(const void* q, const void* kp, const void* vp, const void* tables,
                           const void* pos, void* out, int B, int S, int H, int K, int hd,
                           int bs, int MB, int n_vis, float scale, cudaStream_t st) {
#define PORT_PAGED_CASE(HD_, BS_)                                                        \
  if (hd == HD_ && bs == BS_)                                                            \
    return launch<QT, PoolT, HD_, BS_>(q, kp, vp, tables, pos, out, B, S, H, K, MB, n_vis, \
                                       scale, st);
  PORT_PAGED_CASE(64, 8)
  PORT_PAGED_CASE(64, 16)
  PORT_PAGED_CASE(128, 8)
  PORT_PAGED_CASE(128, 16)
#undef PORT_PAGED_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, S, H, hd); k_pool, v_pool: (NB, bs, K, hd); tables: (B, MB) int32;
// pos: (B,) int32.  q/out are bf16 when q_bf16 else f32; the pools likewise.
extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* tables, const void* pos, void* out, int B, int S,
                               int H, int K, int hd, int bs, int MB, int n_vis, int q_bf16,
                               int pool_bf16, float scale, void* stream) {
  if (B == 0 || S == 0 || n_vis == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && pool_bf16)
    return dispatch_shape<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, tables, pos, out, B,
                                                        S, H, K, hd, bs, MB, n_vis, scale, st);
  if (q_bf16)
    return dispatch_shape<__nv_bfloat16, float>(q, k_pool, v_pool, tables, pos, out, B, S, H, K,
                                                hd, bs, MB, n_vis, scale, st);
  if (pool_bf16)
    return dispatch_shape<float, __nv_bfloat16>(q, k_pool, v_pool, tables, pos, out, B, S, H, K,
                                                hd, bs, MB, n_vis, scale, st);
  return dispatch_shape<float, float>(q, k_pool, v_pool, tables, pos, out, B, S, H, K, hd, bs,
                                      MB, n_vis, scale, st);
}
