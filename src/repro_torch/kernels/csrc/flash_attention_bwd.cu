// Flash attention (backward) for Hopper (sm_90a): the gradients dq, dk and
// dv of flash_attention.cu's function, for the training path.
//
// Replaces: the gradient of src/repro/kernels/flash_attention/kernel.py,
// `flash_attention` — on the TPU, XLA's autodiff of the jnp attention
// (src/repro/models/attention.py:37 `chunked_attention`, whose kv block is
// jax.checkpoint-ed so reverse mode recomputes the probabilities).
//
// With s = q.k * scale (masked by position as the forward masks it: keys in
// a query's future when causal, keys at a negative position when not),
// P = exp(s - lse) from the forward's row log-sum-exp, and dO the output's
// gradient:
//   delta_i = sum_d dO[i, d] * O[i, d]
//   dV_j    = sum_i P_ij dO_i                  (P rounded to bf16, as the
//                                               forward's P.V rounds it)
//   dS_ij   = P_ij (dO_i . V_j - delta_i)     (f32 P)
//   dQ_i    = scale * sum_j dS_ij K_j          (dS rounded to bf16)
//   dK_j    = scale * sum_i dS_ij Q_i          (dS rounded to bf16, summed
//                                               over the G = H/K query heads
//                                               of kv head j's group)
// Accumulators are f32.  A masked score's P is set to exactly 0, whatever
// lse is, so a masked key contributes nothing (also to a row that sees no
// key at all, whose forward output is an average over masked keys: its
// gradient is 0).
//
// Bound on this card, at the training shape (B = 4, S = 512, H = 24, K = 2,
// hd 128, causal): 0.0163 ms, bytes and operations tied — five products
// (S, dP, dV, dK, dQ), 10 hd FLOP per visible (query, key) pair and head,
// 1.61e10 FLOP at 989 TFLOP/s; q, k, v, out, dout and lse read once and dq,
// dk, dv written once, 54.7 MB at 3.35 TB/s.
//
// Design: two launches, each a warpgroup of consumers (wgmma, bf16 -> f32)
// fed by one producer warp that keeps TMA loads in flight through an
// mbarrier ring of kStages tiles (128-byte swizzled 64 x 64 boxes, tensor
// maps encoded on the host; a tile's TMA goes out before the producer's
// loads of its row values).  The producer's warpgroup gives its registers
// to the consumers (setmaxnreg 32 / 224: two CTAs an SM, 128 registers a
// thread at launch), so dK and dV (128 f32 a thread at hd 128) stay in
// registers beside S^T and dP^T without spilling.  Each pass computes P
// while its dP product is still in flight; the CTA's first loads (Q and dO,
// or K and V) leave right after the barriers are set up, before the
// position bounds are known.
// - flash_bwd_dq_kernel, first: one CTA per (request, head, 64-query tile),
//   the longest rows first; Q and dO are loaded once.  Its prologue takes
//   delta = rowsum(dO * O) for its own rows (dO from shared memory, O from
//   device memory) and writes it for the second pass.  K and V tiles of 64
//   keys stream through the ring (only the tiles its rows see);
//   S = Q K^T and dP = dO V^T from shared memory, dS to bf16 A fragments
//   in registers, dQ += dS K with K as the MN-major B operand.
// - flash_bwd_dkdv_kernel: one CTA per (request, kv head, 64-key tile, rank
//   in a cluster of P): the G query heads of the kv head are split over the
//   P CTAs of a thread-block cluster (P the largest divisor of G up to
//   kMaxSplit), each summing its own G / P heads over the query tiles that
//   see its keys.  K and V are loaded once; Q and dO tiles (and their lse,
//   delta and positions) stream through the ring.  S^T = K Q^T and
//   dP^T = V dO^T take K and V from shared memory and Q, dO as K-major B;
//   P^T and dS^T go from their accumulators to bf16 A fragments in
//   registers (FlashAttention-3's layout trick), and dV += P^T dO,
//   dK += dS^T Q take dO and Q as MN-major B.  The cluster then sums its P
//   partials through distributed shared memory, rank 0 to P - 1, and each
//   CTA stores its share of the tile in bf16.  Key tiles go out in order,
//   tile 0 (the one most query tiles see under the causal mask) first.
// Tiles that no row sees are skipped by position, as the forward skips
// them (causal only); only tiles with keys or queries past the end, or keys
// in some row's future (not causal: at a negative position), are masked
// element by element.
//
// Head dims 64, 80, 96 and 128 are built.  A tile holds HDP = hd rounded up
// to 64 columns (tile_cols): hd / 64 boxes at 64 and 128, and at hd 96
// (phi-3-vision) and hd 80 (hubert) two boxes whose second is partly out
// of the tensor, since each tensor map's inner dimension is the true hd and
// TMA fills columns hd-127 with zeros (and counts their bytes, so every
// tile is 2 boxes of transaction).  Products over hd (S, dP) take only
// hd / 16 k16 steps (at hd 80 the fifth starts at the second box's base);
// the three whose width is hd (dQ, dV, dK) run at n = 128 with f32 columns
// hd-127 that are zeros and never stored: a third more work in those three
// at hd 96, 60% more at hd 80.  The delta prologue reads hd columns of O
// and dO (hd / 8 16-byte units a row, two threads a row), and dq, dk and dv
// are stored at their true hd.  (A 64 + 32 or 64 + 16 split, the second box
// with the 64- or 32-byte swizzle, would drop the padded columns: later
// work.)
//
// Products executed: 7 against the 5 the bound counts (the dK/dV pass
// recomputes S and dP, the dQ pass's products, since dQ sums over keys and
// dK/dV over queries), on 64 x 64 tiles that waste ~12% of the causal
// triangle at S = 512.  CTAs at the training shape: 768 in the dQ pass
// (8 query tiles x 24 heads x 4 requests) and 256 in the dK/dV pass (8 key
// tiles x 2 kv heads x 4 requests x P = 4) on 132 SMs, two CTAs an SM.
//
// Deterministic, with no float atomics: each dq element is summed by one
// CTA over its kv tiles in a fixed order; each dk / dv element is summed by
// one CTA of the cluster over its (head, query tile) items in a fixed
// order, and the cluster's partials are added in rank order 0 .. P - 1
// whichever CTA adds them.  (One pass that also produced dQ would need its
// partial dQ summed across key tiles: atomics, or an f32 scratch of
// Skv / 64 partials of dq; the second pass is the deterministic choice.)
#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockQ = 64;                    // query rows of a dq CTA, of a dk/dv query tile
constexpr int kBlockK = 64;                    // keys of a dk/dv CTA, of a dq KV tile
constexpr int kDkvWidth = 64;                  // queries of the dk/dv pass's S^T / dP^T at a time
constexpr int kStages = 2;                     // tiles in the TMA ring
constexpr int kMaxSplit = 4;                   // most CTAs (a cluster) that split a group's heads
constexpr int kConsumers = 128;                // one warpgroup computes
constexpr int kThreads = kConsumers + 128;     // one warpgroup loads (its first warp)
constexpr int kProducerRegs = 32;              // setmaxnreg: two CTAs an SM, 128 registers a
constexpr int kConsumerRegs = 224;             // thread at launch, moved to the consumers
constexpr int kBox = 64 * 64 * 2;              // one TMA box: 64 rows x 64 bf16, 128-byte swizzle
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// The number of CTAs that split a group of G query heads: the largest
// divisor of G up to kMaxSplit.
__host__ __device__ constexpr int head_split(int G) {
  int p = kMaxSplit < G ? kMaxSplit : G;
  while (G % p) --p;
  return p;
}

// The columns of a tile in shared memory: hd rounded up to whole 64-column
// TMA boxes (the 128-byte swizzle's row).
__host__ __device__ constexpr int tile_cols(int hd) { return (hd + 63) / 64 * 64; }

// 2^x by the SFU's ex2.approx alone (subnormal results flush to 0), in
// fewer instructions than exp2f; at the training shape the gradients are
// bit for bit those that exp2f gives.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (port::smem_addr(p) & 1023)) & 1023);
}

// K-major descriptor of rows [row0, row0 + N) and K columns [16 kk, 16 kk + 16)
// of a 64-row tile stored as tile_cols(hd) / 64 boxes of 64 columns.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int kk) {
  return port::wgmma_desc(tile + (kk / 4) * kBox + row0 * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major descriptor with rows [row0, row0 + 16) as K and every column as N.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int row0) {
  return port::wgmma_desc(tile + row0 * 128, kBox, 1024);
}

// Min and max of pos[0, n) over tiles of 64 (both tile sizes are 64): a
// warp a tile, two positions a lane.  The caller puts a barrier after.
__device__ void tile_bounds(const int* __restrict__ pos, int n, int* tmin, int* tmax) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t * 64 < n; t += kThreads / 32) {
    const int i = t * 64 + lane;
    const int a = i < n ? __ldg(pos + i) : INT_MAX, c = i + 32 < n ? __ldg(pos + i + 32) : INT_MAX;
    const int mn = __reduce_min_sync(0xffffffffu, min(a, c));
    const int mx = __reduce_max_sync(0xffffffffu, max(a == INT_MAX ? INT_MIN : a,
                                                      c == INT_MAX ? INT_MIN : c));
    if (lane == 0) {
      tmin[t] = mn;
      tmax[t] = mx;
    }
  }
}

// sum of the products of 8 bf16 pairs
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s += u.x * v.x + u.y * v.y;
  }
  return s;
}

// The A fragment of k16 step kt from a 64 x N accumulator (two n8 tiles
// are one k16 step), rounded to bf16.
template <int N>
__device__ __forceinline__ void to_afrag(const float (&d)[N], int kt, uint32_t (&a)[4]) {
  a[0] = port::pack_bf16(d[8 * kt + 0], d[8 * kt + 1]);
  a[1] = port::pack_bf16(d[8 * kt + 2], d[8 * kt + 3]);
  a[2] = port::pack_bf16(d[8 * kt + 4], d[8 * kt + 5]);
  a[3] = port::pack_bf16(d[8 * kt + 6], d[8 * kt + 7]);
}

// Q, dO, the ring of K and V tiles, the ring's key positions, delta, the
// barriers, then the kv tiles' position bounds and the visible list.
template <int HD> size_t dq_smem_bytes(int n_kt) {
  return 1024 + (size_t)(2 + 2 * kStages) * (tile_cols(HD) / 64) * kBox + kStages * kBlockK * 4 +
         kBlockQ * 4 + (1 + 2 * kStages) * 8 + (size_t)3 * n_kt * 4;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const bf16* __restrict__ out, const float* __restrict__ lse,
                    float* __restrict__ delta, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, bf16* __restrict__ dq, int Sq, int Skv, int H,
                    int K, int causal, float scale) {
  constexpr int HDP = tile_cols(HD);
  constexpr int TILE = (HDP / 64) * kBox;      // a 64-row tile of q, dO, k or v
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t qs = port::smem_addr(smem), dos = qs + TILE, ring = qs + 2 * TILE;  // ring: [stage][k, v]
  int* kpos = reinterpret_cast<int*>(smem + (2 + 2 * kStages) * TILE);   // [kStages][kBlockK]
  float* s_delta = reinterpret_cast<float*>(kpos + kStages * kBlockK);   // [kBlockQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_delta + kBlockQ);       // q, full[], empty[]
  const int n_kt = (Skv + kBlockK - 1) / kBlockK;
  int* tmin = reinterpret_cast<int*>(bars + 1 + 2 * kStages);
  int* tmax = tmin + n_kt;
  int* vis = tmax + n_kt;
  __shared__ int s_qmin[2], s_qmax[2], s_nvis;

  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / K);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;   // the longest rows first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* kvp = kv_pos + (size_t)b * Skv;
  const uint32_t bar_q = port::smem_addr(bars);
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };

  if (tid == 0) {                              // the barriers, and Q and dO on their way
    port::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      port::mbar_init(bar_full(s), 32);        // the producer warp's lanes
      port::mbar_init(bar_empty(s), kConsumers);
    }
    port::mbar_fence_init();
    port::mbar_arrive_expect_tx(bar_q, 2 * TILE);
#pragma unroll
    for (int c = 0; c < HDP / 64; ++c) {
      port::tma_load_4d(qs + c * kBox, &tm_q, bar_q, c * 64, h, q0, b);
      port::tma_load_4d(dos + c * kBox, &tm_do, bar_q, c * 64, h, q0, b);
    }
  }
  if (tid < kBlockQ) {                         // warps 0 and 1: the rows' position bounds
    const bool ok = q0 + tid < Sq;
    const int p = ok ? __ldg(q_pos + (size_t)b * Sq + q0 + tid) : 0;
    const int mn = __reduce_min_sync(0xffffffffu, ok ? p : INT_MAX);
    const int mx = __reduce_max_sync(0xffffffffu, ok ? p : INT_MIN);
    if (lane == 0) {
      s_qmin[warp] = mn;
      s_qmax[warp] = mx;
    }
  }
  tile_bounds(kvp, Skv, tmin, tmax);
  __syncthreads();
  const int qmin = min(s_qmin[0], s_qmin[1]), qmax = max(s_qmax[0], s_qmax[1]);
  if (tid == 0) {                              // kv tiles that some row sees
    int n = 0;
    for (int j = 0; j < n_kt; ++j)
      if (!(causal && tmin[j] > qmax)) vis[n++] = j;
    s_nvis = n;
  }
  __syncthreads();
  const int n_vis = s_nvis;

  if (warp >= kConsumers / 32) {
    // ---- producer warpgroup: its first warp loads the visible K / V tiles
    port::reg_dealloc<kProducerRegs>();
    if (warp > kConsumers / 32) return;
    for (int it = 0; it < n_vis; ++it) {
      const int s = it % kStages;
      if (it >= kStages) port::mbar_wait(bar_empty(s), ((it / kStages) & 1) ^ 1);
      const int k0 = vis[it] * kBlockK;
      if (lane == 0) {                         // the tiles first, so the two loads overlap
        const uint32_t kt = ring + s * 2 * TILE, vt = kt + TILE;
        port::mbar_expect_tx(bar_full(s), 2 * TILE);
#pragma unroll
        for (int c = 0; c < HDP / 64; ++c) {
          port::tma_load_4d(kt + c * kBox, &tm_k, bar_full(s), c * 64, kh, k0, b);
          port::tma_load_4d(vt + c * kBox, &tm_v, bar_full(s), c * 64, kh, k0, b);
        }
      }
#pragma unroll 1
      for (int i = lane; i < kBlockK; i += 32)
        kpos[s * kBlockK + i] = k0 + i < Skv ? __ldg(kvp + k0 + i) : INT_MAX;
      port::mbar_arrive(bar_full(s));
    }
    return;
  }

  // ---- consumer warpgroup: thread t holds rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8
  port::reg_alloc<kConsumerRegs>();
  const int g = lane / 4, t4 = lane % 4, r0 = warp * 16 + g;
  // the rows' lse and positions, and this thread's half of a row of O for
  // delta (two threads a row), loaded before Q and dO are waited for
  const size_t lrow = ((size_t)b * H + h) * Sq + q0;
  const bool live0 = q0 + r0 < Sq, live1 = q0 + r0 + 8 < Sq;
  // a row past Sq gets lse = +inf: every P of it is exp2(-inf) = 0
  const float lse0 = live0 ? __ldg(lse + lrow + r0) * kLog2e : INFINITY;
  const float lse1 = live1 ? __ldg(lse + lrow + r0 + 8) * kLog2e : INFINITY;
  const int qp0 = live0 ? __ldg(q_pos + (size_t)b * Sq + q0 + r0) : INT_MIN;
  const int qp1 = live1 ? __ldg(q_pos + (size_t)b * Sq + q0 + r0 + 8) : INT_MIN;
  const float scale2 = scale * kLog2e;
  const int orow = tid / 2, part = tid % 2;
  const bool ook = q0 + orow < Sq;
  uint4 o[HD / 16];
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        out + (((size_t)b * Sq + (ook ? q0 + orow : 0)) * H + h) * HD) + part * (HD / 16);
#pragma unroll
    for (int u = 0; u < HD / 16; ++u) o[u] = ook ? __ldg(src + u) : make_uint4(0, 0, 0, 0);
  }
  port::mbar_wait(bar_q, 0);
  {                                            // delta = rowsum(dO * O) for the tile's rows
    const unsigned char* drow = smem + TILE + orow * 128;
    float d = 0.f;
#pragma unroll
    for (int u = 0; u < HD / 16; ++u) {
      const int U = part * (HD / 16) + u;      // the 16-byte unit of the row, swizzled in smem
      d += dot8(*reinterpret_cast<const uint4*>(drow + (U / 8) * kBox + ((U % 8) ^ (orow % 8)) * 16),
                o[u]);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (part == 0) {
      s_delta[orow] = d;
      if (ook) delta[lrow + orow] = d;
    }
  }
  port::named_sync(1, kConsumers);
  const float dl0 = s_delta[r0], dl1 = s_delta[r0 + 8];

  float acc[HDP / 2];                          // columns hd .. HDP - 1 stay 0
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_vis; ++it) {
    const int s = it % kStages, j = vis[it];
    const uint32_t kt = ring + s * 2 * TILE, vt = kt + TILE;
    const int* kp = kpos + s * kBlockK;
    const bool need_mask = (j + 1) * kBlockK > Skv || (causal ? tmax[j] > qmin : tmin[j] < 0);
    port::mbar_wait(bar_full(s), (it / kStages) & 1);
    // S = Q K^T, then dP = dO V^T; P is taken while dP is still in flight
    float sc[kBlockK / 2], dp[kBlockK / 2];
    port::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      port::wgmma_ss(sc, kmajor(qs, 0, kk), kmajor(kt, 0, kk), kk > 0);
    port::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      port::wgmma_ss(dp, kmajor(dos, 0, kk), kmajor(vt, 0, kk), kk > 0);
    port::wgmma_commit();
    port::wgmma_wait<1>();
    port::reg_fence(sc);
    // P from lse, then dS = P (dP - delta), in place of S
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(sc[4 * n + e] * scale2 - (e < 2 ? lse0 : lse1));
        if (need_mask) {
          const int col = n * 8 + 2 * t4 + (e & 1);
          if (j * kBlockK + col >= Skv || (causal ? kp[col] > (e < 2 ? qp0 : qp1) : kp[col] < 0))
            p = 0.f;
        }
        sc[4 * n + e] = p;
      }
    }
    port::wgmma_wait<0>();
    port::reg_fence(dp);
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) sc[i] *= dp[i] - (i % 4 < 2 ? dl0 : dl1);
    // dQ += dS K: dS from registers, K MN-major
    uint32_t a[kBlockK / 16][4];
#pragma unroll
    for (int kt16 = 0; kt16 < kBlockK / 16; ++kt16) to_afrag(sc, kt16, a[kt16]);
    port::wgmma_fence();
#pragma unroll
    for (int kt16 = 0; kt16 < kBlockK / 16; ++kt16)
      port::wgmma_rs(acc, a[kt16], mnmajor(kt, 16 * kt16), 1);
    port::wgmma_commit();
    port::wgmma_wait<0>();
    port::reg_fence(acc);
#pragma unroll
    for (int kt16 = 0; kt16 < kBlockK / 16; ++kt16) port::reg_fence(a[kt16]);
    port::mbar_arrive(bar_empty(s));           // this thread is done with the slot
  }

  bf16* d0 = dq + (((size_t)b * Sq + q0 + r0) * H + h) * HD;
  bf16* d1 = d0 + (size_t)8 * H * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (live0)
      *reinterpret_cast<__nv_bfloat162*>(d0 + col) =
          __floats2bfloat162_rn(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    if (live1)
      *reinterpret_cast<__nv_bfloat162*>(d1 + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
  }
}

// K, V, the ring of Q and dO tiles, the ring's lse, delta and positions,
// the barriers, then the query tiles' position bounds and the visible list.
// After the products the K / V / ring area holds the CTA's f32 partial dK
// and dV (64 rows of HD + 4 each), which the cluster reads.
template <int HD> size_t dkdv_smem_bytes(int n_qt) {
  return 1024 + (size_t)(2 + 2 * kStages) * (tile_cols(HD) / 64) * kBox + 3 * kStages * kBlockQ * 4 +
         (1 + 2 * kStages) * 8 + (size_t)3 * n_qt * 4;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H, int K,
                      int causal, float scale) {
  constexpr int HDP = tile_cols(HD);
  constexpr int TILE = (HDP / 64) * kBox;
  constexpr int LDP = HD + 4;                  // f32 row of a partial (padded against bank conflicts)
  static_assert(2 * kBlockK * LDP * 4 <= (2 + 2 * kStages) * TILE, "partials overflow");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t ks = port::smem_addr(smem), vs = ks + TILE, ring = ks + 2 * TILE;  // ring: [stage][q, dO]
  float* rl = reinterpret_cast<float*>(smem + (2 + 2 * kStages) * TILE);   // [kStages][kBlockQ] lse * log2e
  float* rd = rl + kStages * kBlockQ;                                      // [kStages][kBlockQ] delta
  int* rp = reinterpret_cast<int*>(rd + kStages * kBlockQ);                // [kStages][kBlockQ] positions
  uint64_t* bars = reinterpret_cast<uint64_t*>(rp + kStages * kBlockQ);    // kv, full[], empty[]
  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  int* qtmin = reinterpret_cast<int*>(bars + 1 + 2 * kStages);
  int* qtmax = qtmin + n_qt;
  int* vis = qtmax + n_qt;
  __shared__ int s_kmin[2], s_kmax[2], s_nvis;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), P = (int)cluster.num_blocks();
  const int b = blockIdx.y / K, kh = blockIdx.y % K, k0 = blockIdx.z * kBlockK;
  const int hpc = H / K / P, h_first = kh * (H / K) + rank * hpc;   // this CTA's query heads
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* qpb = q_pos + (size_t)b * Sq;
  const int* kvp = kv_pos + (size_t)b * Skv;
  const uint32_t bar_kv = port::smem_addr(bars);
  auto bar_full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8 * (1 + kStages + s); };

  if (tid == 0) {                              // the barriers, and K and V on their way
    port::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      port::mbar_init(bar_full(s), 32);
      port::mbar_init(bar_empty(s), kConsumers);
    }
    port::mbar_fence_init();
    port::mbar_arrive_expect_tx(bar_kv, 2 * TILE);
#pragma unroll
    for (int c = 0; c < HDP / 64; ++c) {
      port::tma_load_4d(ks + c * kBox, &tm_k, bar_kv, c * 64, kh, k0, b);
      port::tma_load_4d(vs + c * kBox, &tm_v, bar_kv, c * 64, kh, k0, b);
    }
  }
  if (tid < kBlockK) {                         // warps 0 and 1: the keys' position bounds
    const bool ok = k0 + tid < Skv;
    const int p = ok ? __ldg(kvp + k0 + tid) : 0;
    const int mn = __reduce_min_sync(0xffffffffu, ok ? p : INT_MAX);
    const int mx = __reduce_max_sync(0xffffffffu, ok ? p : INT_MIN);
    if (lane == 0) {
      s_kmin[warp] = mn;
      s_kmax[warp] = mx;
    }
  }
  tile_bounds(qpb, Sq, qtmin, qtmax);
  __syncthreads();
  const int kmin = min(s_kmin[0], s_kmin[1]), kmax = max(s_kmax[0], s_kmax[1]);
  if (tid == 0) {                              // query tiles that see some key here
    int n = 0;
    for (int t = 0; t < n_qt; ++t)
      if (!(causal && qtmax[t] < kmin)) vis[n++] = t;
    s_nvis = n;
  }
  __syncthreads();
  const int n_vis = s_nvis, n_items = hpc * n_vis;   // (query head, query tile) pairs

  float* pk = reinterpret_cast<float*>(smem);  // partial dK [kBlockK][LDP], after the products
  float* pv = pk + kBlockK * LDP;              // partial dV
  if (warp >= kConsumers / 32) {
    // ---- producer warpgroup: its first warp loads the items' Q and dO
    //      tiles; the whole warpgroup joins the cluster's two barriers
    port::reg_dealloc<kProducerRegs>();
    int h = h_first, ti = 0;                   // item it = (head h, visible tile ti)
    for (int it = 0; it < (warp == kConsumers / 32 ? n_items : 0); ++it) {
      const int s = it % kStages;
      if (it >= kStages) port::mbar_wait(bar_empty(s), ((it / kStages) & 1) ^ 1);
      const int q0 = vis[ti] * kBlockQ;
      if (lane == 0) {                         // the tiles first, so the two loads overlap
        const uint32_t qt = ring + s * 2 * TILE, dt = qt + TILE;
        port::mbar_expect_tx(bar_full(s), 2 * TILE);
#pragma unroll
        for (int c = 0; c < HDP / 64; ++c) {
          port::tma_load_4d(qt + c * kBox, &tm_q, bar_full(s), c * 64, h, q0, b);
          port::tma_load_4d(dt + c * kBox, &tm_do, bar_full(s), c * 64, h, q0, b);
        }
      }
      const size_t ro = ((size_t)b * H + h) * Sq + q0;
#pragma unroll 1
      for (int i = lane; i < kBlockQ; i += 32) {
        const bool ok = q0 + i < Sq;
        rl[s * kBlockQ + i] = ok ? __ldg(lse + ro + i) * kLog2e : INFINITY;
        rd[s * kBlockQ + i] = ok ? __ldg(delta + ro + i) : 0.f;
        rp[s * kBlockQ + i] = ok ? __ldg(qpb + q0 + i) : INT_MIN;
      }
      port::mbar_arrive(bar_full(s));
      if (++ti == n_vis) {
        ti = 0;
        ++h;
      }
    }
    cluster.sync();
    cluster.sync();
    return;
  }

  {
    // ---- consumer warpgroup: thread t holds keys r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8
    port::reg_alloc<kConsumerRegs>();
    const int g = lane / 4, t4 = lane % 4, r0 = warp * 16 + g;
    const int kp0 = k0 + r0 < Skv ? __ldg(kvp + k0 + r0) : INT_MAX;
    const int kp1 = k0 + r0 + 8 < Skv ? __ldg(kvp + k0 + r0 + 8) : INT_MAX;
    const float scale2 = scale * kLog2e;
    float dka[HDP / 2], dva[HDP / 2];          // columns hd .. HDP - 1 stay 0
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dka[i] = dva[i] = 0.f;
    port::mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % kStages, t = vis[it % n_vis], q0 = t * kBlockQ;
      const uint32_t qt = ring + s * 2 * TILE, dt = qt + TILE;
      const float* ls = rl + s * kBlockQ;
      const float* dl = rd + s * kBlockQ;
      const int* ps = rp + s * kBlockQ;
      const bool need_mask = q0 + kBlockQ > Sq || (causal ? qtmin[t] < kmax : kmin < 0);
      port::mbar_wait(bar_full(s), (it / kStages) & 1);
#pragma unroll
      for (int hf = 0; hf < kBlockQ / kDkvWidth; ++hf) {
        // S^T = K Q^T and dP^T = V dO^T for the 64 keys and kDkvWidth
        // queries; P^T is taken while dP^T is still in flight
        constexpr int W = kDkvWidth;
        float st[W / 2], dpt[W / 2];
        port::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          port::wgmma_ss(st, kmajor(ks, 0, kk), kmajor(qt, hf * W, kk), kk > 0);
        port::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          port::wgmma_ss(dpt, kmajor(vs, 0, kk), kmajor(dt, hf * W, kk), kk > 0);
        port::wgmma_commit();
        port::wgmma_wait<1>();
        port::reg_fence(st);
        // P^T in st, then dS^T in dpt
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = hf * W + n * 8 + 2 * t4 + (e & 1);
            float p = exp2_approx(st[4 * n + e] * scale2 - ls[col]);
            const int kp = e < 2 ? kp0 : kp1;
            if (need_mask && (q0 + col >= Sq || (causal ? kp > ps[col] : kp < 0))) p = 0.f;
            st[4 * n + e] = p;
          }
        }
        port::wgmma_wait<0>();
        port::reg_fence(dpt);
#pragma unroll
        for (int i = 0; i < W / 2; ++i)
          dpt[i] = st[i] * (dpt[i] - dl[hf * W + (i / 4) * 8 + 2 * t4 + (i & 1)]);
        // dV += P^T dO and dK += dS^T Q over the same queries: P^T and dS^T
        // from registers, dO and Q MN-major
        uint32_t ap[W / 16][4], as[W / 16][4];
#pragma unroll
        for (int kt16 = 0; kt16 < W / 16; ++kt16) {
          to_afrag(st, kt16, ap[kt16]);
          to_afrag(dpt, kt16, as[kt16]);
        }
        port::wgmma_fence();
#pragma unroll
        for (int kt16 = 0; kt16 < W / 16; ++kt16)
          port::wgmma_rs(dva, ap[kt16], mnmajor(dt, hf * W + 16 * kt16), 1);
#pragma unroll
        for (int kt16 = 0; kt16 < W / 16; ++kt16)
          port::wgmma_rs(dka, as[kt16], mnmajor(qt, hf * W + 16 * kt16), 1);
        port::wgmma_commit();
        port::wgmma_wait<0>();
        port::reg_fence(dva);
        port::reg_fence(dka);
#pragma unroll
        for (int kt16 = 0; kt16 < W / 16; ++kt16) {
          port::reg_fence(ap[kt16]);
          port::reg_fence(as[kt16]);
        }
      }
      port::mbar_arrive(bar_empty(s));
    }
    // every product of the warpgroup has finished with K, V and the ring:
    // the partials go where they were
    port::named_sync(1, kConsumers);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<float2*>(pk + r0 * LDP + col) = make_float2(dka[4 * n], dka[4 * n + 1]);
      *reinterpret_cast<float2*>(pk + (r0 + 8) * LDP + col) = make_float2(dka[4 * n + 2], dka[4 * n + 3]);
      *reinterpret_cast<float2*>(pv + r0 * LDP + col) = make_float2(dva[4 * n], dva[4 * n + 1]);
      *reinterpret_cast<float2*>(pv + (r0 + 8) * LDP + col) = make_float2(dva[4 * n + 2], dva[4 * n + 3]);
    }
  }

  // The cluster's sum: this CTA's share of the tile's float4s, the P
  // partials added in rank order, stored once in bf16.
  cluster.sync();
  constexpr int N4 = kBlockK * HD / 4;
  for (int e = N4 * rank / P + tid; e < N4 * (rank + 1) / P; e += kConsumers) {
    const int row = e / (HD / 4), c4 = e % (HD / 4);
    if (k0 + row >= Skv) continue;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int r = 0; r < P; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pk, r) + row * LDP + c4 * 4);
      const float4 y = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pv, r) + row * LDP + c4 * 4);
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    const size_t o = (((size_t)b * Skv + k0 + row) * K + kh) * HD + c4 * 4;
    const uint2 wk = make_uint2(port::pack_bf16(sk.x * scale, sk.y * scale),
                                port::pack_bf16(sk.z * scale, sk.w * scale));
    const uint2 wv = make_uint2(port::pack_bf16(sv.x, sv.y), port::pack_bf16(sv.z, sv.w));
    *reinterpret_cast<uint2*>(dk + o) = wk;
    *reinterpret_cast<uint2*>(dv + o) = wv;
  }
  cluster.sync();                              // no CTA leaves while another reads its partials
}

template <typename Kernel> cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;   // the most a block may opt into
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A (B, S, heads, hd) bf16 tensor as a 4-D tensor map whose box is one
// 64-column chunk of one head over 64 consecutive rows (an 8 KB tile,
// 128-byte swizzle); rows past S and columns past hd read as zeros.
bool tile_map(CUtensorMap* map, const void* base, int B, int S, int heads, int hd) {
  const port::TensorMapEncoder encode = port::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* out, const bf16* dout,
                   const float* lse, const int* q_pos, const int* kv_pos, bf16* dq, bf16* dk,
                   bf16* dv, float* delta, int B, int Sq, int Skv, int H, int K, int causal,
                   float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  if (!tile_map(&tq, q, B, Sq, H, HD) || !tile_map(&tdo, dout, B, Sq, H, HD) ||
      !tile_map(&tk, k, B, Skv, K, HD) || !tile_map(&tv, v, B, Skv, K, HD))
    return cudaErrorInvalidValue;
  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ, n_kt = (Skv + kBlockK - 1) / kBlockK;
  cudaError_t e;

  const size_t smem_q = dq_smem_bytes<HD>(n_kt);
  if ((e = opt_in(flash_bwd_dq_kernel<HD>, smem_q)) != cudaSuccess) return e;
  flash_bwd_dq_kernel<HD><<<dim3(H, B, n_qt), kThreads, smem_q, st>>>(
      tq, tk, tv, tdo, out, lse, delta, q_pos, kv_pos, dq, Sq, Skv, H, K, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int P = head_split(H / K);
  const size_t smem_kv = dkdv_smem_bytes<HD>(n_qt);
  if ((e = opt_in(flash_bwd_dkdv_kernel<HD>, smem_kv)) != cudaSuccess) return e;
  if (P > 8 && (e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
                   cudaSuccess)
    return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P, B * K, n_kt);          // key tile slowest: tile 0 goes first
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_kv;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_kernel<HD>, tq, tk, tv, tdo, lse,
                              (const float*)delta, q_pos, kv_pos, dk, dv, Sq, Skv, H, K, causal,
                              scale)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: (B, Sq, H, hd) bf16; k, v, dk, dv: (B, Skv, K, hd) bf16;
// lse: (B, H, Sq) f32 from the forward; q_pos: (B, Sq), kv_pos: (B, Skv)
// int32; delta: (B, H, Sq) f32 scratch.  q, k, v, out and dout 16-byte
// aligned (TMA and 16-byte loads).  Two launches on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, const void* q_pos,
                                   const void* kv_pos, void* dq, void* dk, void* dv, void* delta,
                                   int B, int Sq, int Skv, int H, int K, int hd, int causal,
                                   float scale, void* stream) {
  if (B == 0 || Sq == 0 || Skv < 1 || K < 1 || H % K) return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, out, dout})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* ob = static_cast<const bf16*>(out);
  const auto* db = static_cast<const bf16*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* qp = static_cast<const int*>(q_pos);
  const auto* kp = static_cast<const int*>(kv_pos);
  auto* dqb = static_cast<bf16*>(dq);
  auto* dkb = static_cast<bf16*>(dk);
  auto* dvb = static_cast<bf16*>(dv);
  auto* dl = static_cast<float*>(delta);
  if (hd == 64)
    return launch<64>(qb, kb, vb, ob, db, lf, qp, kp, dqb, dkb, dvb, dl, B, Sq, Skv, H, K, causal,
                      scale, st);
  if (hd == 80)
    return launch<80>(qb, kb, vb, ob, db, lf, qp, kp, dqb, dkb, dvb, dl, B, Sq, Skv, H, K, causal,
                      scale, st);
  if (hd == 96)
    return launch<96>(qb, kb, vb, ob, db, lf, qp, kp, dqb, dkb, dvb, dl, B, Sq, Skv, H, K, causal,
                      scale, st);
  if (hd == 128)
    return launch<128>(qb, kb, vb, ob, db, lf, qp, kp, dqb, dkb, dvb, dl, B, Sq, Skv, H, K, causal,
                       scale, st);
  return cudaErrorInvalidValue;
}
