// Flash attention (forward) for Hopper (sm_90a): GQA attention with a
// position-based causal mask and online softmax, the prefill attention of
// the serving path.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `flash_attention`
// (Pallas body `_flash_kernel`).
//
// Computes out[b, i, h] = softmax_j(q[b,i,h] . k[b,j,h/G] * hd^-0.5) . v[b,j,h/G]
// with scores masked to -1e30 where kv_pos[b,j] > q_pos[b,i] when causal,
// and where kv_pos[b,j] < 0 when not (as the model's chunked attention
// masks an encoder's keys).
// Unlike the Pallas version it keeps the position arguments, and it masks
// ragged tails (keys past Skv, query rows past Sq) instead of halving the
// block sizes until they divide the sequence.
//
// Bound on this card: at prefill lengths of a few hundred tokens, bytes
// (q and out dominate: 2 * Sq * H * hd * 2 bytes against ~Sq^2 * H * hd
// flops); the bf16 tensor-core rate bounds only far longer prompts.  At
// S <= 1024 the grid is 120-384 CTAs and the time goes to latency: the
// chain of dependent loads before the first product, and the serial walk
// over KV tiles of the CTA with the most of them.
//
// Design (the FlashAttention-2 shape on mma.sync.m16n8k16, bf16 -> f32):
// - One CTA of 4 warps serves 64 query rows of one (request, query head);
//   each warp owns 16 rows and loads their Q fragments straight from device
//   memory into registers.  The CTAs with the longest rows start first.
// - KV tiles of 64 keys are copied with cp.async (16-byte lines, zeroed
//   past Skv) into shared memory rows padded by 16 bytes, so ldmatrix hits
//   no bank conflicts, through a ring of two: tile i+1 loads while tile i
//   computes.  The first tile is in flight before the positions are read.
// - Head dims 64, 80, 96 and 128 are built.  At hd 96 (phi-3-vision) a row
//   is 12 lines and 6 k16 steps, its padded stride 208 bytes (13 lines: the
//   8 rows of an ldmatrix land on distinct banks, as at 144 and 272); at
//   hd 80 (hubert) 10 lines, 5 k16 steps and 10 n8 tiles of O, a stride of
//   176 bytes (11 lines), and a KV tile is 640 lines, 5 a thread.
// - A first pass takes the min and max kv position of every tile (in
//   shared memory, one warp reduction per 32 keys).  Tiles past the last
//   one any row of the CTA sees are never loaded; one that no row sees
//   (positions out of order) is not computed, as the JAX kernel skips it.
//   Only a tile that holds keys past Skv or keys in some row's future (not
//   causal: keys at a negative position) is masked, by position.  Without
//   causal every tile is loaded and computed.
// - S = Q.K^T accumulates in f32 fragments; the online max and sum are
//   taken on the fragments with a 4-lane shuffle per row, in base 2; P.V
//   takes P from the same registers (the accumulator layout of two n8 key
//   tiles is the A layout of one k16 step) and V through ldmatrix.trans.
//
// Numerics: scores, softmax, row sums and the accumulator are f32; P is
// rounded to bf16 for the P.V product (the FlashAttention-2 habit), where
// the JAX kernel keeps it in f32.  That adds one bf16 rounding of each
// probability, inside the bf16 output's own rounding (max abs error against
// the f32 plain version: PERF.md).  Masked scores are -1e30, the JAX
// kernel's NEG_INF, so a row whose keys are all masked averages V over the
// keys of the tiles its CTA computes, as the JAX kernel does at
// block_q = block_k = 64.
//
// With `lse` given (training), each row also writes its log-sum-exp of the
// scaled, masked scores, in natural-log units: (m + log2 l) * ln 2, where m
// is the row's running max and l its row sum in base 2.  The backward
// (flash_attention_bwd.cu) recomputes P from it.  Serving passes null and
// writes nothing more.
//
// The k_chunk knob (`block_k`) no longer changes the kernel: the tile is 64
// keys whatever it is, so the result does not depend on it.
//
// Left for a later PR: warp-specialised wgmma with TMA loads (a producer
// warp, consumer warpgroups), 128-row tiles with 32 rows a warp so each K/V
// fragment feeds two products, and a persistent grid.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;           // query rows of a CTA
constexpr int kBlockK = 64;                    // keys of a KV tile
constexpr int kStages = 2;                     // KV tiles in the cp.async ring
constexpr int kPad = 8;                        // bf16 of padding per smem row
constexpr float kLog2e = 1.4426950408889634f;

// The K/V ring, then the min and max kv position of every KV tile.
template <int HD> size_t smem_bytes(int n_tiles) {
  return (size_t)kStages * 2 * kBlockK * (HD + kPad) * sizeof(__nv_bfloat16) +
         (size_t)2 * n_tiles * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Skv, int H, int K, int causal,
                       float scale) {
  constexpr int LD = HD + kPad;                // smem row stride, in bf16
  constexpr int LINES = HD / 8;                // 16-byte lines per row
  constexpr int KSTEPS = HD / 16;              // k16 steps of Q.K^T
  constexpr int NT_S = kBlockK / 8;            // n8 tiles of S
  constexpr int NT_O = HD / 8;                 // n8 tiles of O
  constexpr int U = 8;                         // kv positions in flight a thread
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [kStages][kBlockK][LD]
  __nv_bfloat16* vs = ks + kStages * kBlockK * LD;              // [kStages][kBlockK][LD]
  const int n_tiles = (Skv + kBlockK - 1) / kBlockK;
  int* tmin = reinterpret_cast<int*>(vs + kStages * kBlockK * LD);   // [n_tiles]
  int* tmax = tmin + n_tiles;                                          // [n_tiles]
  __shared__ int s_qmax[kWarps], s_qmin[kWarps];

  const int b = blockIdx.z, h = blockIdx.y, kh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;   // the longest rows first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int* kvp = kv_pos + (size_t)b * Skv;

  for (int t = tid; t < n_tiles; t += kThreads) {
    tmin[t] = INT_MAX;
    tmax[t] = INT_MIN;
  }

  auto load_tile = [&](int j, int slot) {
    const int t0 = j * kBlockK;
#pragma unroll
    for (int i = 0; i < kBlockK * LINES / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int t = e / LINES, c = e % LINES;
      const bool ok = t0 + t < Skv;
      const size_t off = (((size_t)b * Skv + (ok ? t0 + t : 0)) * K + kh) * HD + c * 8;
      const int so = (slot * kBlockK + t) * LD + c * 8;
      port::cp_async16(port::smem_addr(ks + so), k + off, ok);
      port::cp_async16(port::smem_addr(vs + so), v + off, ok);
    }
  };
  // The first tiles load while the positions are read: with causal
  // positions in order, every tile up to the last one a row sees is needed.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    port::cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of its warp): Q fragments straight
  // from device memory (rows past Sq are zeros) and positions
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const bool live0 = row0 < Sq, live1 = row1 < Sq;
  const uint32_t* qr0 = reinterpret_cast<const uint32_t*>(
      q + (((size_t)b * Sq + (live0 ? row0 : 0)) * H + h) * HD);
  const uint32_t* qr1 = reinterpret_cast<const uint32_t*>(
      q + (((size_t)b * Sq + (live1 ? row1 : 0)) * H + h) * HD);
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 8 + tig;
    qf[kk][0] = live0 ? __ldg(qr0 + c) : 0u;
    qf[kk][1] = live1 ? __ldg(qr1 + c) : 0u;
    qf[kk][2] = live0 ? __ldg(qr0 + c + 4) : 0u;
    qf[kk][3] = live1 ? __ldg(qr1 + c + 4) : 0u;
  }
  const int qp0 = live0 ? q_pos[(size_t)b * Sq + row0] : INT_MIN;
  const int qp1 = live1 ? q_pos[(size_t)b * Sq + row1] : INT_MIN;
  const int wmax = __reduce_max_sync(0xffffffffu, max(qp0, qp1));
  const int wmin = __reduce_min_sync(0xffffffffu, min(live0 ? qp0 : INT_MAX,
                                                      live1 ? qp1 : INT_MAX));
  if (lane == 0) {
    s_qmax[warp] = wmax;
    s_qmin[warp] = wmin;
  }
  __syncthreads();                             // tmin / tmax initialised

  // min and max kv position of every tile: a warp reads 32 keys of one tile
  static_assert(kBlockK * (HD / 8) % kThreads == 0, "a KV tile's lines split over the threads");
  for (int base0 = warp * 32; base0 < Skv; base0 += kThreads * U) {
    int kv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base0 + u * kThreads + lane;
      kv[u] = key < Skv ? __ldg(kvp + key) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int base = base0 + u * kThreads;
      if (base >= Skv) break;
      const bool ok = base + lane < Skv;
      const int mn = __reduce_min_sync(0xffffffffu, ok ? kv[u] : INT_MAX);
      const int mx = __reduce_max_sync(0xffffffffu, ok ? kv[u] : INT_MIN);
      if (lane == 0) {
        atomicMin(tmin + base / kBlockK, mn);
        atomicMax(tmax + base / kBlockK, mx);
      }
    }
  }
  __syncthreads();
  const int qmax = max(max(s_qmax[0], s_qmax[1]), max(s_qmax[2], s_qmax[3]));
  const int qmin = min(min(s_qmin[0], s_qmin[1]), min(s_qmin[2], s_qmin[3]));

  // Tiles from j_end on are unseen by every row; one before it that no row
  // sees (positions out of order) is loaded but not computed.
  int j_end = n_tiles;
  while (causal && j_end > 0 && tmin[j_end - 1] > qmax) --j_end;
  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = port::kMaskValue, m1 = port::kMaskValue, l0 = 0.f, l1 = 0.f;
  const float scale2 = scale * kLog2e;         // softmax in base 2

  for (int j = 0; j < j_end; ++j) {
    const int slot = j % kStages;
    port::cp_async_wait<kStages - 2>();        // tile j has landed
    __syncthreads();                           // ... for every thread; slot - 1 is free
    if (j + kStages - 1 < j_end) load_tile(j + kStages - 1, (j + kStages - 1) % kStages);
    port::cp_async_commit();
    if (causal && tmin[j] > qmax) continue;
    const __nv_bfloat16* kt = ks + slot * kBlockK * LD;
    const __nv_bfloat16* vt = vs + slot * kBlockK * LD;

    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        port::ldsm_x4(port::smem_addr(kt + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                                ((lane / 8) % 2) * 8),
                b0, b1, b2, b3);
        port::mma_bf16(s[2 * np], qf[kk], b0, b1);
        port::mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
      }
    }

    // scale; mask unless every key exists and every row sees it: keys past
    // Skv get -inf (p = 0), keys in a row's future (not causal: at a
    // negative position) -1e30
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
    if ((j + 1) * kBlockK > Skv || (causal ? tmax[j] > qmin : tmin[j] < 0)) {
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * kBlockK + n * 8 + tig * 2 + e;
          if (key >= Skv) {
            s[n][e] = s[n][e + 2] = -INFINITY;
          } else {
            const int kp = __ldg(kvp + key);
            if (causal ? kp > qp0 : kp < 0) s[n][e] = port::kMaskValue;
            if (causal ? kp > qp1 : kp < 0) s[n][e + 2] = port::kMaskValue;
          }
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;                // this lane's share of the row sums
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      s[n][0] = exp2f(s[n][0] - mx0);
      s[n][1] = exp2f(s[n][1] - mx0);
      s[n][2] = exp2f(s[n][2] - mx1);
      s[n][3] = exp2f(s[n][3] - mx1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // O += P . V, P from the score registers, rounded to bf16
#pragma unroll
    for (int kt16 = 0; kt16 < kBlockK / 16; ++kt16) {
      const uint32_t a[4] = {port::pack_bf16(s[2 * kt16][0], s[2 * kt16][1]),
                             port::pack_bf16(s[2 * kt16][2], s[2 * kt16][3]),
                             port::pack_bf16(s[2 * kt16 + 1][0], s[2 * kt16 + 1][1]),
                             port::pack_bf16(s[2 * kt16 + 1][2], s[2 * kt16 + 1][3])};
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        port::ldsm_x4_trans(port::smem_addr(vt + (kt16 * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                      np * 16 + (lane / 16) * 8),
                      b0, b1, b2, b3);
        port::mma_bf16(o[2 * np], a, b0, b1);
        port::mma_bf16(o[2 * np + 1], a, b2, b3);
      }
    }
  }
  port::cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && tig == 0) {            // one lane of the four a row
    constexpr float kLn2 = 0.6931471805599453f;
    if (live0) lse[((size_t)b * H + h) * Sq + row0] = (m0 + log2f(l0)) * kLn2;
    if (live1) lse[((size_t)b * H + h) * Sq + row1] = (m1 + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + tig * 2;
    if (live0)
      *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * Sq + row0) * H + h) * HD + col) =
          __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    if (live1)
      *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * Sq + row1) * H + h) * HD + col) =
          __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_pos, void* out, float* lse, int B, int Sq, int Skv, int H,
                   int K, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>((Skv + kBlockK - 1) / kBlockK);
  if (smem > 232448) return cudaErrorInvalidValue;   // the most a block may opt into
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, K,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, Sq, H, hd) bf16; k, v: (B, Skv, K, hd) bf16; q_pos: (B, Sq) int32;
// kv_pos: (B, Skv) int32; lse: (B, H, Sq) f32, or null.
extern "C" int flash_attention(const void* q, const void* k, const void* v, const void* q_pos,
                               const void* kv_pos, void* out, void* lse, int B, int Sq, int Skv,
                               int H, int K, int hd, int causal, float scale, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (Skv < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 64)
    return launch<64>(q, k, v, q_pos, kv_pos, out, l, B, Sq, Skv, H, K, causal, scale, st);
  if (hd == 80)
    return launch<80>(q, k, v, q_pos, kv_pos, out, l, B, Sq, Skv, H, K, causal, scale, st);
  if (hd == 96)
    return launch<96>(q, k, v, q_pos, kv_pos, out, l, B, Sq, Skv, H, K, causal, scale, st);
  if (hd == 128)
    return launch<128>(q, k, v, q_pos, kv_pos, out, l, B, Sq, Skv, H, K, causal, scale, st);
  return cudaErrorInvalidValue;
}
