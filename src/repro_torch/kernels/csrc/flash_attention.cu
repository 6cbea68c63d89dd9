// Flash attention (forward) for Hopper (sm_90a): GQA attention with a
// position-based causal mask and online softmax, the prefill attention of
// the serving path.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `flash_attention`
// (Pallas body `_flash_kernel`).
//
// Computes out[b, i, h] = softmax_j(q[b,i,h] . k[b,j,h/G] * hd^-0.5) . v[b,j,h/G]
// with scores masked to -1e30 where kv_pos[b,j] > q_pos[b,i] when causal.
// Unlike the Pallas version it keeps the position arguments, and it masks
// ragged tails (keys past Skv, query rows past Sq) instead of halving the
// block sizes until they divide the sequence.
//
// Bound on this card: at prefill lengths of a few hundred tokens, bytes
// (q and out dominate: 2 * Sq * H * hd * 2 bytes against ~Sq^2 * H * hd
// flops); the bf16 tensor-core rate bounds only far longer prompts.  This
// first version does the products with f32 FMAs, not tensor cores.  One CTA
// serves one (request, query head, tile of 64 query rows) and loops over KV
// tiles of `kc` keys (the k_chunk knob, 128 or 256: 64 or 128 KB of bf16
// K+V in dynamic shared memory), loaded once with 16-byte vector loads and
// read by all 8 warps.  A KV tile whose first position is past every query
// position of the CTA is skipped whole (causal).  Each warp owns 8 query
// rows; a lane holds hd/32 dims of q and of the accumulator.  Keys go in
// chunks of 32: a score is a warp-wide dot product, lane j keeps key j's
// score, and the chunk's max, exponentials and sum are then lane-parallel.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;                        // bf16 values in one 16-byte load

size_t smem_bytes(int hd, int kc) { return (size_t)kc * hd * 2 * sizeof(__nv_bfloat16) + kc * 4; }

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out, int Sq,
                       int Skv, int H, int K, int kc, int causal, float scale) {
  constexpr int D = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + (size_t)kc * HD;
  int* kps = reinterpret_cast<int*>(vs + (size_t)kc * HD);
  __shared__ int s_qmax, s_kmin;

  const int b = blockIdx.z, h = blockIdx.y, kh = h / (H / K);
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) s_qmax = INT_MIN;
  __syncthreads();

  float qv[kRowsPerWarp][D], acc[kRowsPerWarp][D], m[kRowsPerWarp], l[kRowsPerWarp];
  int qp[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    const bool live = row < Sq;
    qp[r] = live ? q_pos[(size_t)b * Sq + row] : INT_MIN;
    const __nv_bfloat16* src = q + (((size_t)b * Sq + (live ? row : 0)) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      qv[r][i] = live ? __bfloat162float(src[lane + 32 * i]) : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = port::kMaskValue;
    l[r] = 0.f;
    if (live && lane == 0) atomicMax(&s_qmax, qp[r]);
  }

  const int n_tiles = (Skv + kc - 1) / kc;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kc;
    const int n_keys = min(kc, Skv - t0);
    __syncthreads();                           // previous tile consumed
    if (threadIdx.x == 0) s_kmin = INT_MAX;
    __syncthreads();
    for (int t = threadIdx.x; t < n_keys; t += kThreads) {
      const int kp = kv_pos[(size_t)b * Skv + t0 + t];
      kps[t] = kp;
      atomicMin(&s_kmin, kp);
    }
    __syncthreads();
    if (causal && s_kmin > s_qmax) continue;   // wholly in the future
    for (int e = threadIdx.x; e < n_keys * (HD / kVec); e += kThreads) {
      const int t = e / (HD / kVec), c = e % (HD / kVec);
      const size_t off = (((size_t)b * Skv + t0 + t) * K + kh) * HD + c * kVec;
      *reinterpret_cast<uint4*>(ks + (size_t)t * HD + c * kVec) =
          *reinterpret_cast<const uint4*>(k + off);
      *reinterpret_cast<uint4*>(vs + (size_t)t * HD + c * kVec) =
          *reinterpret_cast<const uint4*>(v + off);
    }
    __syncthreads();

    for (int c0 = 0; c0 < n_keys; c0 += 32) {
      const int n_c = min(32, n_keys - c0);
      float sc[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = -INFINITY;   // absent keys: p = 0
      for (int j = 0; j < n_c; ++j) {
        const int t = c0 + j;
        float kv[D];
#pragma unroll
        for (int i = 0; i < D; ++i) kv[i] = __bfloat162float(ks[(size_t)t * HD + lane + 32 * i]);
        const int kp = kps[t];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < D; ++i) part += qv[r][i] * kv[i];
          part = port::warp_sum(part);
          const float s = (!causal || kp <= qp[r]) ? part * scale : port::kMaskValue;
          if (lane == j) sc[r] = s;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float mx = fmaxf(m[r], port::warp_max(sc[r]));
        const float corr = expf(m[r] - mx);
        sc[r] = expf(sc[r] - mx);
        l[r] = l[r] * corr + port::warp_sum(sc[r]);
        m[r] = mx;
#pragma unroll
        for (int i = 0; i < D; ++i) acc[r][i] *= corr;
      }
      for (int j = 0; j < n_c; ++j) {
        const int t = c0 + j;
        float vv[D];
#pragma unroll
        for (int i = 0; i < D; ++i) vv[i] = __bfloat162float(vs[(size_t)t * HD + lane + 32 * i]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float p = __shfl_sync(0xffffffffu, sc[r], j);
#pragma unroll
          for (int i = 0; i < D; ++i) acc[r][i] += p * vv[i];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= Sq) continue;
    __nv_bfloat16* dst = out + (((size_t)b * Sq + row) * H + h) * HD;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < D; ++i) dst[lane + 32 * i] = __float2bfloat16_rn(acc[r][i] / denom);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_pos, void* out, int B, int Sq, int Skv, int H, int K, int kc,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, kc);    // above 48 KB only after opting in
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<__nv_bfloat16*>(out), Sq, Skv, H, K, kc,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, Sq, H, hd) bf16; k, v: (B, Skv, K, hd) bf16; q_pos: (B, Sq) int32;
// kv_pos: (B, Skv) int32; kc: KV tile, 1..256 keys.
extern "C" int flash_attention(const void* q, const void* k, const void* v, const void* q_pos,
                               const void* kv_pos, void* out, int B, int Sq, int Skv, int H,
                               int K, int hd, int kc, int causal, float scale, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (kc < 1 || kc > 256 || Skv < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, K, kc, causal, scale, st);
  if (hd == 128)
    return launch<128>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, K, kc, causal, scale, st);
  return cudaErrorInvalidValue;
}
