// Flash attention (backward) for Hopper (sm_90a): the gradients dq, dk and
// dv of flash_attention.cu's function, for the training path.
//
// Replaces: the gradient of src/repro/kernels/flash_attention/kernel.py,
// `flash_attention` — on the TPU, XLA's autodiff of the jnp attention
// (src/repro/models/attention.py `chunked_attention`, whose kv block is
// jax.checkpoint-ed so reverse mode recomputes the probabilities).
//
// With s = q.k * scale (masked by position as the forward masks it),
// P = exp(s - lse) from the forward's row log-sum-exp, and dO the output's
// gradient:
//   delta_i = sum_d dO[i, d] * O[i, d]
//   dV_j    = sum_i P_ij dO_i                  (P rounded to bf16, as the
//                                               forward's P.V rounds it)
//   dS_ij   = P_ij (dO_i . V_j - delta_i)     (f32 P)
//   dQ_i    = scale * sum_j dS_ij K_j
//   dK_j    = scale * sum_i dS_ij Q_i          (summed over the G = H/K query
//                                               heads of kv head j's group)
// A masked score's P is set to exactly 0, whatever lse is, so a masked key
// contributes nothing (also to a row that sees no key at all, whose
// forward output is an average over masked keys: its gradient is 0).
//
// Bound on this card: the tensor cores at training lengths (four
// products of Sq x Skv x hd, half of them skipped under the causal mask,
// against q, k, v, O, dO and the gradients read or written once).
//
// Design (FlashAttention-2's split, on mma.sync.m16n8k16, bf16 -> f32),
// with no float atomics, so a run is deterministic:
// - flash_bwd_delta_kernel: one warp a (request, row, head) takes
//   delta = rowsum(dO * O) in f32.
// - flash_bwd_dkdv_kernel: one CTA of 4 warps per (request, kv head,
//   64-key tile); each warp owns 16 keys and keeps their dK and dV in f32
//   registers while the CTA walks the G query heads of the group and, for
//   each, the 64-query tiles that can see its keys (a list built from the
//   tiles' position bounds).  Q and dO tiles (and their lse, delta and
//   positions) come through a ring of two with cp.async; K and V stay in
//   shared memory.  Each 64-query tile is computed in two halves of 32, so
//   S^T, dP^T, dK and dV fit in registers at hd 128.
// - flash_bwd_dq_kernel: one CTA per (request, head, 64-query tile), the
//   forward's shape: Q and dO fragments in registers, K and V tiles of 64
//   keys through the ring, dQ in f32 registers; each tile in two halves
//   of 32 keys.
// Tiles that no row sees are skipped by position, as the forward skips
// them; only tiles with keys or queries past the end, or keys in some
// row's future, are masked element by element.
//
// Left for a later PR: wgmma with TMA loads, and more CTAs for the dK/dV
// pass at few kv heads (at B = 4, S = 512, K = 2 it has 64 CTAs for 132
// SMs).
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 64;                    // query rows of a dq CTA, of a dk/dv query tile
constexpr int kBlockK = 64;                    // keys of a dk/dv CTA, of a dq KV tile
constexpr int kHalf = 32;                      // inner width computed at a time
constexpr int kStages = 2;                     // tiles in the cp.async ring
constexpr int kPad = 8;                        // bf16 of padding per smem row
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Min and max of pos[0, n) over tiles of 64 (both tile sizes are 64): a
// warp reads 32 positions at a time and one lane folds them in with a
// shared-memory atomic.  tmin / tmax hold INT_MAX / INT_MIN on entry; the
// caller puts a barrier before and after.
__device__ void tile_bounds(const int* __restrict__ pos, int n, int* tmin, int* tmax) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int base = warp * 32; base < n; base += kThreads) {
    const bool ok = base + lane < n;
    const int p = ok ? __ldg(pos + base + lane) : 0;
    const int mn = __reduce_min_sync(0xffffffffu, ok ? p : INT_MAX);
    const int mx = __reduce_max_sync(0xffffffffu, ok ? p : INT_MIN);
    if (lane == 0) {
      atomicMin(tmin + base / 64, mn);
      atomicMax(tmax + base / 64, mx);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H) {
  const int r = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;                       // whole warps leave together
  const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(out + (size_t)r * HD);
  const __nv_bfloat162* d = reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)r * HD);
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD / 2; c += 32) {
    const float2 a = __bfloat1622float2(o[c]), b = __bfloat1622float2(d[c]);
    acc += a.x * b.x + a.y * b.y;
  }
  acc = port::warp_sum(acc);
  if (lane == 0) {                             // row r = (b * Sq + i) * H + h
    const int h = r % H, i = (r / H) % Sq, b = r / (H * Sq);
    delta[((size_t)b * H + h) * Sq + i] = acc;
  }
}

template <int HD> size_t dq_smem_bytes(int n_tiles) {
  return (size_t)kStages * 2 * kBlockK * (HD + kPad) * sizeof(bf16) + (size_t)2 * n_tiles * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                    bf16* __restrict__ dq, int Sq, int Skv, int H, int K, int causal, float scale) {
  constexpr int LD = HD + kPad;
  constexpr int LINES = HD / 8;
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_O = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);                 // [kStages][kBlockK][LD]
  bf16* vs = ks + kStages * kBlockK * LD;                   // [kStages][kBlockK][LD]
  const int n_tiles = (Skv + kBlockK - 1) / kBlockK;
  int* tmin = reinterpret_cast<int*>(vs + kStages * kBlockK * LD);
  int* tmax = tmin + n_tiles;
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
  load_tile(0, 0);
  port::cp_async_commit();

  // this thread's rows g and g + 8 of its warp: Q and dO fragments from
  // device memory (rows past Sq are zeros), positions, lse and delta
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const bool live0 = row0 < Sq, live1 = row1 < Sq;
  const size_t o0 = (((size_t)b * Sq + (live0 ? row0 : 0)) * H + h) * HD;
  const size_t o1 = (((size_t)b * Sq + (live1 ? row1 : 0)) * H + h) * HD;
  const uint32_t* qr0 = reinterpret_cast<const uint32_t*>(q + o0);
  const uint32_t* qr1 = reinterpret_cast<const uint32_t*>(q + o1);
  const uint32_t* dr0 = reinterpret_cast<const uint32_t*>(dout + o0);
  const uint32_t* dr1 = reinterpret_cast<const uint32_t*>(dout + o1);
  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 8 + tig;
    qf[kk][0] = live0 ? __ldg(qr0 + c) : 0u;
    qf[kk][1] = live1 ? __ldg(qr1 + c) : 0u;
    qf[kk][2] = live0 ? __ldg(qr0 + c + 4) : 0u;
    qf[kk][3] = live1 ? __ldg(qr1 + c + 4) : 0u;
    df[kk][0] = live0 ? __ldg(dr0 + c) : 0u;
    df[kk][1] = live1 ? __ldg(dr1 + c) : 0u;
    df[kk][2] = live0 ? __ldg(dr0 + c + 4) : 0u;
    df[kk][3] = live1 ? __ldg(dr1 + c + 4) : 0u;
  }
  const size_t r0 = ((size_t)b * H + h) * Sq + row0;
  // a row past Sq gets lse = +inf: every P of it is exp2(-inf) = 0
  const float lse0 = live0 ? __ldg(lse + r0) * kLog2e : INFINITY;
  const float lse1 = live1 ? __ldg(lse + r0 + 8) * kLog2e : INFINITY;
  const float dl0 = live0 ? __ldg(delta + r0) : 0.f;
  const float dl1 = live1 ? __ldg(delta + r0 + 8) : 0.f;
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
  tile_bounds(kvp, Skv, tmin, tmax);
  __syncthreads();
  const int qmax = max(max(s_qmax[0], s_qmax[1]), max(s_qmax[2], s_qmax[3]));
  const int qmin = min(min(s_qmin[0], s_qmin[1]), min(s_qmin[2], s_qmin[3]));

  int j_end = n_tiles;
  while (causal && j_end > 0 && tmin[j_end - 1] > qmax) --j_end;
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int j = 0; j < j_end; ++j) {
    const int slot = j % kStages;
    port::cp_async_wait<kStages - 2>();        // tile j has landed
    __syncthreads();                           // ... for every thread; slot - 1 is free
    if (j + kStages - 1 < j_end) load_tile(j + kStages - 1, (j + kStages - 1) % kStages);
    port::cp_async_commit();
    if (causal && tmin[j] > qmax) continue;
    const bool need_mask = (j + 1) * kBlockK > Skv || (causal && tmax[j] > qmin);
    const bf16* kt = ks + slot * kBlockK * LD;
    const bf16* vt = vs + slot * kBlockK * LD;
#pragma unroll
    for (int hf = 0; hf < kBlockK / kHalf; ++hf) {
      float s[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int np = 0; np < kHalf / 16; ++np) {
          const int so = (hf * kHalf + np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8;
          uint32_t b0, b1, b2, b3;
          port::ldsm_x4(port::smem_addr(kt + so), b0, b1, b2, b3);
          port::mma_bf16(s[2 * np], qf[kk], b0, b1);
          port::mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
          port::ldsm_x4(port::smem_addr(vt + so), b0, b1, b2, b3);
          port::mma_bf16(dp[2 * np], df[kk], b0, b1);
          port::mma_bf16(dp[2 * np + 1], df[kk], b2, b3);
        }
      }
      // P from lse; dS = P (dP - delta), in place of s
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[n][e] * scale2 - (e < 2 ? lse0 : lse1));
          if (need_mask) {
            const int key = j * kBlockK + hf * kHalf + n * 8 + tig * 2 + (e & 1);
            if (key >= Skv || (causal && __ldg(kvp + key) > (e < 2 ? qp0 : qp1))) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1));
        }
      }
      // dQ += dS . K, dS from the registers (two n8 tiles are one k16 step)
#pragma unroll
      for (int kt16 = 0; kt16 < kHalf / 16; ++kt16) {
        const uint32_t a[4] = {port::pack_bf16(s[2 * kt16][0], s[2 * kt16][1]),
                               port::pack_bf16(s[2 * kt16][2], s[2 * kt16][3]),
                               port::pack_bf16(s[2 * kt16 + 1][0], s[2 * kt16 + 1][1]),
                               port::pack_bf16(s[2 * kt16 + 1][2], s[2 * kt16 + 1][3])};
#pragma unroll
        for (int np = 0; np < NT_O / 2; ++np) {
          uint32_t b0, b1, b2, b3;
          port::ldsm_x4_trans(
              port::smem_addr(kt + (hf * kHalf + kt16 * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                              np * 16 + (lane / 16) * 8),
              b0, b1, b2, b3);
          port::mma_bf16(acc[2 * np], a, b0, b1);
          port::mma_bf16(acc[2 * np + 1], a, b2, b3);
        }
      }
    }
  }
  port::cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + tig * 2;
    if (live0)
      *reinterpret_cast<__nv_bfloat162*>(dq + o0 + col) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (live1)
      *reinterpret_cast<__nv_bfloat162*>(dq + o1 + col) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// K and V tiles, the ring of Q and dO tiles, the ring's lse, delta and
// positions, then the query tiles' position bounds and the visible list.
template <int HD> size_t dkdv_smem_bytes(int n_qtiles) {
  return (size_t)(2 + 2 * kStages) * kBlockK * (HD + kPad) * sizeof(bf16) +
         (size_t)3 * kStages * kBlockQ * 4 + (size_t)3 * n_qtiles * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H, int K,
                      int causal, float scale) {
  constexpr int LD = HD + kPad;
  constexpr int LINES = HD / 8;
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_O = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);                 // [kBlockK][LD]
  bf16* vs = ks + kBlockK * LD;                             // [kBlockK][LD]
  bf16* qs = vs + kBlockK * LD;                             // [kStages][kBlockQ][LD]
  bf16* dos = qs + kStages * kBlockQ * LD;                  // [kStages][kBlockQ][LD]
  float* rl = reinterpret_cast<float*>(dos + kStages * kBlockQ * LD);   // [kStages][kBlockQ]
  float* rd = rl + kStages * kBlockQ;                       // [kStages][kBlockQ]
  int* rp = reinterpret_cast<int*>(rd + kStages * kBlockQ); // [kStages][kBlockQ]
  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  int* qtmin = rp + kStages * kBlockQ;
  int* qtmax = qtmin + n_qt;
  int* vis = qtmax + n_qt;
  __shared__ int s_kmin[2], s_kmax[2], s_nvis;

  const int b = blockIdx.z, kh = blockIdx.y, k0 = blockIdx.x * kBlockK;
  const int G = H / K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int* qpb = q_pos + (size_t)b * Sq;
  const int* kvp = kv_pos + (size_t)b * Skv;
  for (int t = tid; t < n_qt; t += kThreads) {
    qtmin[t] = INT_MAX;
    qtmax[t] = INT_MIN;
  }

  // the CTA's K and V tile, once (keys past Skv are zeros)
#pragma unroll
  for (int i = 0; i < kBlockK * LINES / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int t = e / LINES, c = e % LINES;
    const bool ok = k0 + t < Skv;
    const size_t off = (((size_t)b * Skv + (ok ? k0 + t : 0)) * K + kh) * HD + c * 8;
    port::cp_async16(port::smem_addr(ks + t * LD + c * 8), k + off, ok);
    port::cp_async16(port::smem_addr(vs + t * LD + c * 8), v + off, ok);
  }

  // the key positions' bounds (warps 0 and 1, a key a thread) and this
  // thread's two keys
  if (tid < kBlockK) {
    const bool ok = k0 + tid < Skv;
    const int p = ok ? __ldg(kvp + k0 + tid) : 0;
    const int mn = __reduce_min_sync(0xffffffffu, ok ? p : INT_MAX);
    const int mx = __reduce_max_sync(0xffffffffu, ok ? p : INT_MIN);
    if (lane == 0) {
      s_kmin[warp] = mn;
      s_kmax[warp] = mx;
    }
  }
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const int kp0 = key0 < Skv ? __ldg(kvp + key0) : INT_MAX;
  const int kp1 = key1 < Skv ? __ldg(kvp + key1) : INT_MAX;
  __syncthreads();                             // qtmin / qtmax initialised
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
  const int n_vis = s_nvis, n_items = G * n_vis;   // (query head, query tile) pairs

  auto load_item = [&](int it, int slot) {
    const int h = kh * G + it / n_vis, q0 = vis[it % n_vis] * kBlockQ;
#pragma unroll
    for (int i = 0; i < kBlockQ * LINES / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / LINES, c = e % LINES;
      const bool ok = q0 + r < Sq;
      const size_t off = (((size_t)b * Sq + (ok ? q0 + r : 0)) * H + h) * HD + c * 8;
      const int so = (slot * kBlockQ + r) * LD + c * 8;
      port::cp_async16(port::smem_addr(qs + so), q + off, ok);
      port::cp_async16(port::smem_addr(dos + so), dout + off, ok);
    }
    if (tid < kBlockQ) {
      const bool ok = q0 + tid < Sq;
      const size_t ro = ((size_t)b * H + h) * Sq + (ok ? q0 + tid : 0);
      port::cp_async4(port::smem_addr(rl + slot * kBlockQ + tid), lse + ro, ok);
      port::cp_async4(port::smem_addr(rd + slot * kBlockQ + tid), delta + ro, ok);
      port::cp_async4(port::smem_addr(rp + slot * kBlockQ + tid), qpb + (ok ? q0 + tid : 0), ok);
    }
  };
  if (n_items > 0) load_item(0, 0);
  port::cp_async_commit();                     // with the K and V tile

  float dka[NT_O][4], dva[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < n_items; ++it) {
    const int slot = it % kStages;
    port::cp_async_wait<kStages - 2>();        // item it has landed
    __syncthreads();                           // ... for every thread; slot - 1 is free
    if (it + kStages - 1 < n_items) load_item(it + kStages - 1, (it + kStages - 1) % kStages);
    port::cp_async_commit();
    const int t = vis[it % n_vis], q0 = t * kBlockQ;
    const bool need_mask = q0 + kBlockQ > Sq || (causal && qtmin[t] < kmax);
    const bf16* qt = qs + slot * kBlockQ * LD;
    const bf16* dot = dos + slot * kBlockQ * LD;
    const float* ls = rl + slot * kBlockQ;
    const float* dl = rd + slot * kBlockQ;
    const int* ps = rp + slot * kBlockQ;
#pragma unroll
    for (int hf = 0; hf < kBlockQ / kHalf; ++hf) {
      // S^T = K . Q^T and dP^T = V . dO^T for the warp's 16 keys and 32 queries
      float st[kHalf / 8][4], dpt[kHalf / 8][4];
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int ao = (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16 + (lane / 16) * 8;
        uint32_t ak[4], av[4];
        port::ldsm_x4(port::smem_addr(ks + ao), ak[0], ak[1], ak[2], ak[3]);
        port::ldsm_x4(port::smem_addr(vs + ao), av[0], av[1], av[2], av[3]);
#pragma unroll
        for (int np = 0; np < kHalf / 16; ++np) {
          const int bo = (hf * kHalf + np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8;
          uint32_t b0, b1, b2, b3;
          port::ldsm_x4(port::smem_addr(qt + bo), b0, b1, b2, b3);
          port::mma_bf16(st[2 * np], ak, b0, b1);
          port::mma_bf16(st[2 * np + 1], ak, b2, b3);
          port::ldsm_x4(port::smem_addr(dot + bo), b0, b1, b2, b3);
          port::mma_bf16(dpt[2 * np], av, b0, b1);
          port::mma_bf16(dpt[2 * np + 1], av, b2, b3);
        }
      }
      // P^T in st, dS^T in dpt
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = hf * kHalf + n * 8 + tig * 2 + (e & 1);
          float p = exp2f(st[n][e] * scale2 - ls[col] * kLog2e);
          if (need_mask && (q0 + col >= Sq || (causal && (e < 2 ? kp0 : kp1) > ps[col]))) p = 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl[col]);
        }
      }
      // dV += P^T . dO and dK += dS^T . Q over the 32 queries
#pragma unroll
      for (int kt16 = 0; kt16 < kHalf / 16; ++kt16) {
        const uint32_t ap[4] = {port::pack_bf16(st[2 * kt16][0], st[2 * kt16][1]),
                                port::pack_bf16(st[2 * kt16][2], st[2 * kt16][3]),
                                port::pack_bf16(st[2 * kt16 + 1][0], st[2 * kt16 + 1][1]),
                                port::pack_bf16(st[2 * kt16 + 1][2], st[2 * kt16 + 1][3])};
        const uint32_t as[4] = {port::pack_bf16(dpt[2 * kt16][0], dpt[2 * kt16][1]),
                                port::pack_bf16(dpt[2 * kt16][2], dpt[2 * kt16][3]),
                                port::pack_bf16(dpt[2 * kt16 + 1][0], dpt[2 * kt16 + 1][1]),
                                port::pack_bf16(dpt[2 * kt16 + 1][2], dpt[2 * kt16 + 1][3])};
#pragma unroll
        for (int np = 0; np < NT_O / 2; ++np) {
          const int bo = (hf * kHalf + kt16 * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + np * 16 +
                         (lane / 16) * 8;
          uint32_t b0, b1, b2, b3;
          port::ldsm_x4_trans(port::smem_addr(dot + bo), b0, b1, b2, b3);
          port::mma_bf16(dva[2 * np], ap, b0, b1);
          port::mma_bf16(dva[2 * np + 1], ap, b2, b3);
          port::ldsm_x4_trans(port::smem_addr(qt + bo), b0, b1, b2, b3);
          port::mma_bf16(dka[2 * np], as, b0, b1);
          port::mma_bf16(dka[2 * np + 1], as, b2, b3);
        }
      }
    }
  }
  port::cp_async_wait<0>();

  // the group's sums: rows key0 and key1 of (B, Skv, K, hd)
  const size_t w0 = (((size_t)b * Skv + key0) * K + kh) * HD;
  const size_t w1 = (((size_t)b * Skv + key1) * K + kh) * HD;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + tig * 2;
    if (key0 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + w0 + col) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + w0 + col) = __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (key1 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + w1 + col) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + w1 + col) = __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

template <typename Kernel> cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;   // the most a block may opt into
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* out, const bf16* dout,
                   const float* lse, const int* q_pos, const int* kv_pos, bf16* dq, bf16* dk,
                   bf16* dv, float* delta, int B, int Sq, int Skv, int H, int K, int causal,
                   float scale, cudaStream_t st) {
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<HD><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(out, dout, delta,
                                                                               rows, Sq, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_kv = dkdv_smem_bytes<HD>((Sq + kBlockQ - 1) / kBlockQ);
  if ((e = opt_in(flash_bwd_dkdv_kernel<HD>, smem_kv)) != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<HD><<<dim3((Skv + kBlockK - 1) / kBlockK, K, B), kThreads, smem_kv, st>>>(
      q, k, v, dout, lse, delta, q_pos, kv_pos, dk, dv, Sq, Skv, H, K, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t smem_q = dq_smem_bytes<HD>((Skv + kBlockK - 1) / kBlockK);
  if ((e = opt_in(flash_bwd_dq_kernel<HD>, smem_q)) != cudaSuccess) return e;
  flash_bwd_dq_kernel<HD><<<dim3((Sq + kBlockQ - 1) / kBlockQ, H, B), kThreads, smem_q, st>>>(
      q, k, v, dout, lse, delta, q_pos, kv_pos, dq, Sq, Skv, H, K, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: (B, Sq, H, hd) bf16; k, v, dk, dv: (B, Skv, K, hd) bf16;
// lse: (B, H, Sq) f32 from the forward; q_pos: (B, Sq), kv_pos: (B, Skv)
// int32; delta: (B, H, Sq) f32 scratch.  Three launches on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, const void* q_pos,
                                   const void* kv_pos, void* dq, void* dk, void* dv, void* delta,
                                   int B, int Sq, int Skv, int H, int K, int hd, int causal,
                                   float scale, void* stream) {
  if (B == 0 || Sq == 0 || Skv < 1 || K < 1 || H % K) return cudaErrorInvalidValue;
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
  if (hd == 128)
    return launch<128>(qb, kb, vb, ob, db, lf, qp, kp, dqb, dkb, dvb, dl, B, Sq, Skv, H, K, causal,
                       scale, st);
  return cudaErrorInvalidValue;
}
