// Backward of the selective scan (the mamba1 recurrence), for Hopper (sm_90a).
//
// Replaces: XLA's autodiff of the JAX package's jnp scan,
// src/repro/models/mamba.py:93 and :147 (`step`) under :18 `_scan_seq`,
// which on the TPU trains the ssm and hybrid families.  No Pallas kernel
// exists for it: the TPU kernel src/repro/kernels/mamba_scan/kernel.py:58
// has no gradient.  This is the gradient of csrc/mamba_scan.cu's forward.
//
//   h_t = a_t h_{t-1} + u_t B_t,  a_t = exp(dt_t A),  u_t = dt_t x_t,
//   y_t = <h_t, C_t>
//
// Given gy (B, S, D) f32 and the forward's inputs and h_chk (B, ceil(S / L),
// D, N) f32, the state before each interval of L steps, it walks the
// sequence from the last step to the first, carrying gh = dL/dh, and at each
// step t (in reverse):
//
//   gh   += gy_t C_t
//   gC_t += sum_d gy_t h_t             gB_t += sum_d gh u_t
//   gx_t  = dt_t sum_n gh B_t          gdt_t = x_t sum_n gh B_t + sum_n gh A a_t h_{t-1}
//   gA   += gh dt_t a_t h_{t-1}        gh   *= a_t
//
// and gh at the end is dL/dh0.  Outputs: gx, gdt (B, S, D) in x's and dt's
// dtypes; gB, gC (B, S, N) dense in Bm's dtype (the forward may have read
// strided views); gA (D, N) f32; gh0 (B, D, N) f32 or null.  A step with
// dt = 0 passes gh through (a = 1, u = 0), as the forward passes h.
//
// Design.  A block owns kDB d's (G = N / kNG lanes a d, each lane kNG
// states in registers; 1024 states a block from N = 16 on, 256 threads) and
// walks each batch row in turn, a row an interval of L <= kSeg steps at a
// time (a segment) from the last to the first; the grid is one block for
// each kDB d's, one an SM.
// - Staging.  A segment's dt, x, gy (its kDB columns) and its rows of B and
//   C are staged once, as f32, in shared memory, in a ring of two: the next
//   segment is fetched into registers a sub-interval at a time, each piece
//   issued before one sub-interval's recompute and stored after its walk
//   back, so its loads hide behind a sub-interval of compute.  Through
//   registers, as the forward's chunk ring: the inputs come in bf16 or f32
//   at any alignment and stride (views of the x_proj output, odd offsets
//   included), and every pass then reads f32 from shared memory alone.
//   cp.async straight into the f32 slots, where every input is f32 on 16
//   bytes (zamba2's), was no faster on an H100 (a build of its own: 1.5206
//   against 1.5219 ms at zamba2's training shape; chosen at run time inside
//   one build, it cost 11-16% at both training shapes).
// - Pass A walks the segment forward from its h_chk row and keeps the
//   state at each start of kSub steps in shared memory (each thread its
//   own); pass B recomputes one sub-interval's kSub states and a_t into
//   registers, and the walk back goes through them.  Both compute a state
//   as the forward does, fmaf(ex2(dt * A log2 e), h, (dt x) B), so the
//   states are the forward's bits.
// - Sums over n (gx, gdt) within a d's G lanes: the sub-interval's 2 kSub
//   values (s1, s2 of each step) are reduce-scattered over the lanes (at
//   most 2 kSub - 2 shuffles a lane where a butterfly of each value took
//   2 kSub log2 G), on the butterfly's tree, so with its bits.  gx and gdt
//   overwrite x and dt in the staged segment and go out as rows after it.
// - Sums over d (gB, gC): each step's per-thread terms go to shared memory
//   (red); after each sub-interval (two barriers for kSub = 8 steps) the
//   block adds them over its d's into its rows of the segment, P threads a
//   sum of kDB terms as eight interleaved running sums joined as a tree
//   (pairs j, j ^ 4, then j ^ 2, then j ^ 1; the threads' shares joined by
//   shuffles).  A cluster of kCluster blocks along d then adds its blocks'
//   rows in rank order through distributed shared memory, one write of each
//   row a cluster, and a second kernel, scan_bwd_reduce, adds the clusters'
//   rows (split_sum).  gA sums over t in each thread, a batch row at a
//   time, and the rows' sums in order; so no gA partials.  Every sum runs
//   in a fixed order, so two calls give the same bits (no atomics).
// Choices measured on an H100 (scripts/ab_scan_kernel.py, PERF.md):
// clusters of 4 or 8 blocks hold only 120 of the 132 SMs at once, which
// adds a wave at these grids (128 and 256 blocks), so kCluster is 2, kept
// for the scratch it halves rather than for time (0-3% faster than clusters
// of 1); 2 states a thread at 512 threads a block (twice the warps) was
// slower than 4 at 256 (--bwd-plans).  The time is not one bottleneck's
// (--bwd-phases): the core (passes A and B and the walk back) is about
// half, and the sums over d, the staging, the barriers and the lanes'
// reduce-scatter each take a smaller share.
//
// Bound on this card: the exponentials (S * D * N of them for each batch
// row) on the SFU, 16 per SM per clock, with the bytes of x, dt, gy, gx,
// gdt close behind; this kernel computes each exponential twice (passes A
// and B), and its sums over d move 16 bytes of shared memory a state-step.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNG = 4;          // states a thread
constexpr int kSub = 8;         // steps of a sub-interval, walked back in registers
constexpr int kSeg = 64;        // steps of an interval (a staged segment), at most
constexpr int kMaxDB = 64;      // d's of a block, at most
constexpr int kCluster = 2;     // blocks of a cluster along d, at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;
static_assert(kNG == 2 || kNG == 4, "a thread holds 2 or 4 states");

struct Inputs {
  const void* x;
  const void* dt;
  const void* bm;
  const void* cm;
  int b_sb, b_st, c_sb, c_st;   // batch and time strides of Bm and Cm
  int x_bf16, dt_bf16, bc_bf16;
};

// As in mamba_scan.cu: element i of a bf16 or f32 array as raw bits, and
// those bits widened exactly.
__device__ __forceinline__ uint32_t ld_bits(const void* p, size_t i, int bf16) {
  if (bf16) return static_cast<uint32_t>(__ldg(static_cast<const unsigned short*>(p) + i));
  return __float_as_uint(__ldg(static_cast<const float*>(p) + i));
}

__device__ __forceinline__ float as_f32(uint32_t bits, int bf16) {
  return __uint_as_float(bf16 ? bits << 16 : bits);
}

__device__ __forceinline__ void st(void* p, size_t i, float v, int bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kNG consecutive floats at p (8- or 16-byte aligned) into v, and back.
__device__ __forceinline__ void load_vec(float (&v)[kNG], const float* p) {
  if constexpr (kNG == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kNG]) {
  if constexpr (kNG == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int o) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, o), __shfl_xor_sync(0xffffffffu, v.y, o),
                     __shfl_xor_sync(0xffffffffu, v.z, o), __shfl_xor_sync(0xffffffffu, v.w, o));
}

// d's of a block (kDB), threads of a block, lanes of a d at state size N:
// 64 d's up to N = 16, then 1024 states a block (32 d's at N = 32, 16 at
// 64); kNG = 4 gives 64, 128, 256, 256, 256 threads at N = 4 .. 64.
__host__ __device__ constexpr int lanes(int N) { return N / kNG; }
__host__ __device__ constexpr int d_block(int N) { return kMaxDB < 1024 / N ? kMaxDB : 1024 / N; }
__host__ __device__ constexpr int threads(int N) { return d_block(N) * lanes(N); }
static_assert(threads(16) <= 512 && threads(64) <= 512, "a block holds at most 512 threads");

// Blocks of a cluster for nblk blocks along d: kCluster, or the least
// power of two that holds them all.
__host__ __device__ constexpr int cluster_size(int nblk) {
  int c = 1;
  while (c < kCluster && c < nblk) c *= 2;
  return c;
}

// Clusters of a batch row at state size N and D channels; the scratch is
// one gB and one gC row (S x N f32) for each of them and each batch row.
__host__ __device__ constexpr int n_clusters(int N, int D) {
  const int nblk = (D + d_block(N) - 1) / d_block(N), cl = cluster_size(nblk);
  return (nblk + cl - 1) / cl;
}

template <int N> struct Smem {
  static constexpr int kDB = d_block(N), kT = threads(N);
  struct Seg {                                 // one staged segment
    float dt[kSeg][kDB];                       // gdt, once its steps are walked back
    float x[kSeg][kDB];                        // gx, likewise
    float gy[kSeg][kDB];
    alignas(16) float b[kSeg][N];
    alignas(16) float c[kSeg][N];
  };
  Seg seg[2];
  alignas(16) float ck[kSeg / kSub][kT * kNG];   // sub-interval starts (pass A)
  alignas(16) float red[2][kSub][kT * kNG];      // a sub-interval's gB, gC terms
  alignas(16) float rows[2][kSeg][N];          // the block's gB, gC rows of the segment
};

// Reduce-scatter over the G lanes of a d (level O pairs lanes g and g ^ O,
// the lane with bit O set keeping the upper half of the C values), down to
// two values a lane; past that, both are summed over the remaining levels.
template <int O, int C, int M>
__device__ __forceinline__ void reduce_scatter(float (&v)[M], int g) {
  if constexpr (O > 0) {
    if constexpr (C > 2) {
      const bool hi = g & O;
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {
        const float send = hi ? v[i] : v[i + C / 2];
        const float keep = hi ? v[i + C / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<O / 2, C / 2>(v, g);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      v[1] += __shfl_xor_sync(0xffffffffu, v[1], O);
      reduce_scatter<O / 2, C>(v, g);
    }
  }
}

// Sum of the n terms p[0], p[stride], ...: term e goes to running sum e % 8,
// and the eight are joined pairwise.
__device__ __forceinline__ float split_sum(const float* p, size_t stride, int n) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int e = 0;
  for (; e + 8 <= n; e += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += p[(size_t)(e + j) * stride];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (e + j < n) acc[j] += p[(size_t)(e + j) * stride];
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

// Pass B: sub-interval j of a staged segment, from its start state c0: the
// kSub states after each step (hs[k + 1]) and each step's a_t (av[k]).
template <int N>
__device__ __forceinline__ void recompute(const typename Smem<N>::Seg& q, const float* c0, int j,
                                          int dl, int g, const float (&a2)[kNG],
                                          float (&hs)[kSub + 1][kNG], float (&av)[kSub][kNG]) {
  load_vec(hs[0], c0);
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    const int r = j * kSub + k;
    const float dtv = q.dt[r][dl], u = dtv * q.x[r][dl];
    float bv[kNG];
    load_vec(bv, &q.b[r][g * kNG]);
#pragma unroll
    for (int n = 0; n < kNG; ++n) {
      av[k][n] = ex2(dtv * a2[n]);
      hs[k + 1][n] = fmaf(av[k][n], hs[k][n], u * bv[n]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(threads(N), 1)
scan_bwd(Inputs in, const float* __restrict__ A, const float* __restrict__ h_chk,
         const float* __restrict__ gy, void* gx, void* gdt, float* __restrict__ gA_out,
         float* __restrict__ part, float* __restrict__ gh0, int B, int S, int D, int L) {
  constexpr int G = lanes(N), kDB = d_block(N), kT = threads(N);
  constexpr int kTD = (kSub * kDB + kT - 1) / kT;   // (t, d) elements of a piece a thread stages
  constexpr int kTN = (kSub * N + kT - 1) / kT;     // (t, n) elements, likewise
  constexpr int G4 = N / 4;                         // float4s of a d's states
  constexpr int NS = 2 * kSub * G4;                 // float4 sums over d a sub-interval
  constexpr int P = kT / NS;                        // threads a sum
  constexpr int M = 8 / P;                          // running sums a thread
  constexpr int kOut = 2 * kSub / G > 2 ? 2 * kSub / G : 2;   // values a lane keeps
  static_assert(NS * P == kT && P >= 1 && P <= 8 && kDB % 8 == 0,
                "the sums over d must tile the block");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), CL = (int)cluster.num_blocks();
  const int tid = threadIdx.x, dl = tid / G, g = tid % G;
  const int d0 = blockIdx.x * kDB, d = d0 + dl;
  const int nclu = gridDim.x / CL, clu = blockIdx.x / CL;
  const bool live = d < D;
  const int nseg = (S + L - 1) / L, npiece = L / kSub;
  const int nunit = B * nseg;   // unit u: segment nseg - 1 - u % nseg of batch row u / nseg

  float Ar[kNG], a2[kNG], gh[kNG], gA[kNG], gAt[kNG];
#pragma unroll
  for (int j = 0; j < kNG; ++j) Ar[j] = a2[j] = gh[j] = gA[j] = gAt[j] = 0.f;
  if (live) load_vec(Ar, A + (size_t)d * N + g * kNG);
#pragma unroll
  for (int j = 0; j < kNG; ++j) a2[j] = Ar[j] * kLog2e;   // the forward's A log2 e

  auto seg_start = [&](int b, int s, float (&h)[kNG]) {
#pragma unroll
    for (int n = 0; n < kNG; ++n) h[n] = 0.f;
    if (live) load_vec(h, h_chk + (((size_t)b * nseg + s) * D + d) * N + g * kNG);
  };

  // -- staging: piece p (kSub steps) of unit u, into registers and then,
  //    as f32, into ring slot `slot`; zeros past S or D (no-op steps)
  struct Piece {
    uint32_t dt[kTD], x[kTD], b[kTN], c[kTN];
    float gy[kTD];
  };
  auto fetch = [&](Piece& r, int u, int p) {
    const int b = u / nseg, t0 = (nseg - 1 - u % nseg) * L + p * kSub;
#pragma unroll
    for (int i = 0; i < kTD; ++i) {
      const int e = tid + i * kT, k = e / kDB, j = e % kDB;
      const bool ok = e < kSub * kDB && t0 + k < S && d0 + j < D;
      const size_t off = ((size_t)b * S + t0 + k) * D + d0 + j;
      r.dt[i] = ok ? ld_bits(in.dt, off, in.dt_bf16) : 0u;
      r.x[i] = ok ? ld_bits(in.x, off, in.x_bf16) : 0u;
      r.gy[i] = ok ? __ldg(gy + off) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kTN; ++i) {
      const int e = tid + i * kT, k = e / N, n = e % N;
      const bool ok = e < kSub * N && t0 + k < S;
      const size_t ts = t0 + k;
      r.b[i] = ok ? ld_bits(in.bm, (size_t)b * in.b_sb + ts * in.b_st + n, in.bc_bf16) : 0u;
      r.c[i] = ok ? ld_bits(in.cm, (size_t)b * in.c_sb + ts * in.c_st + n, in.bc_bf16) : 0u;
    }
  };
  auto stash = [&](const Piece& r, int slot, int p) {
    auto& q = sm.seg[slot];
#pragma unroll
    for (int i = 0; i < kTD; ++i) {
      const int e = tid + i * kT, k = p * kSub + e / kDB, j = e % kDB;
      if (e < kSub * kDB) {
        q.dt[k][j] = as_f32(r.dt[i], in.dt_bf16);
        q.x[k][j] = as_f32(r.x[i], in.x_bf16);
        q.gy[k][j] = r.gy[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kTN; ++i) {
      const int e = tid + i * kT, k = p * kSub + e / N, n = e % N;
      if (e < kSub * N) {
        q.b[k][n] = as_f32(r.b[i], in.bc_bf16);
        q.c[k][n] = as_f32(r.c[i], in.bc_bf16);
      }
    }
  };

  // -- the cluster's sum of its blocks' rows of unit u, in rank order:
  //    this block's share of the rows' float4s, one write each to `part`
  auto exchange = [&](int u) {
    const int b = u / nseg, t0 = (nseg - 1 - u % nseg) * L, len = min(L, S - t0);
    const int per = len * (N / 4), E4 = 2 * per, lo = E4 * rank / CL, hi = E4 * (rank + 1) / CL;
    auto own = [&](int e) {
      const int which = e / per, k = e % per / (N / 4), n4 = e % (N / 4);
      return &sm.rows[which][k][n4 * 4];
    };
    for (int e0 = lo + tid; e0 < hi; e0 += 4 * kT) {
      float4 v[4][kCluster];                      // every load first, then the sums
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          if (e0 + i * kT < hi && q < CL)
            v[i][q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(own(e0 + i * kT), q));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = e0 + i * kT;
        if (e >= hi) break;
        float4 acc = v[i][0];
#pragma unroll
        for (int q = 1; q < kCluster; ++q)
          if (q < CL) acc = add4(acc, v[i][q]);
        const int which = e / per, r = e % per;
        *reinterpret_cast<float4*>(
            part + ((((size_t)which * B + b) * nclu + clu) * S + t0 + r / (N / 4)) * N +
            r % (N / 4) * 4) = acc;
      }
    }
  };

  // the lane's share after the reduce-scatter: the first of its kOut
  // values' index (s1, s2 of step base / 2 on), and the lanes that hold
  // copies of it (all but the lowest write nothing)
  int base = 0;
#pragma unroll
  for (int o = G / 2, c = 2 * kSub; o > 0; o >>= 1)
    if (c > 2) {
      if (g & o) base += c / 2;
      c /= 2;
    }
  const int dup = G > kSub ? G / kSub - 1 : 0;

  float hs[kSub + 1][kNG], av[kSub][kNG];
  {                                                 // the first unit, staged whole
    for (int p = 0; p < npiece; p += 4) {
      Piece r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p + i < npiece) fetch(r[i], 0, p + i);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p + i < npiece) stash(r[i], 0, p + i);
    }
  }
  __syncthreads();
  Piece nxt;
  for (int u = 0; u < nunit; ++u) {
    const int b = u / nseg, s = nseg - 1 - u % nseg, cur = u & 1;
    const int t0 = s * L, len = min(L, S - t0), nsub = (len + kSub - 1) / kSub;
    const bool more = u + 1 < nunit;
    auto& q = sm.seg[cur];
    // -- bwd: staged
    // pass A: the state at each sub-interval's start
    float h[kNG];
    seg_start(b, s, h);
    for (int j = 0; j < nsub; ++j) {
      store_vec(&sm.ck[j][tid * kNG], h);
      if (j + 1 == nsub) break;
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const int r = j * kSub + k;
        const float dtv = q.dt[r][dl], u_ = dtv * q.x[r][dl];
        float bv[kNG];
        load_vec(bv, &q.b[r][g * kNG]);
#pragma unroll
        for (int n = 0; n < kNG; ++n) h[n] = fmaf(ex2(dtv * a2[n]), h[n], u_ * bv[n]);
      }
    }
    // -- bwd: pass A
    if (u > 0) {                  // the rows of the unit before, summed over the cluster
      cluster_wait();
      exchange(u - 1);
      cluster_arrive();
    }
    if (more) fetch(nxt, u + 1, 0);
    recompute<N>(q, &sm.ck[nsub - 1][tid * kNG], nsub - 1, dl, g, a2, hs, av);
    for (int j = nsub - 1; j >= 0; --j) {
      const int jj = nsub - 1 - j;               // walk-back order, the piece staged here
      float sv[2 * kSub];                        // s1, s2 of each step
#pragma unroll
      for (int k = kSub - 1; k >= 0; --k) {
        const int r = j * kSub + k;
        const float dtv = q.dt[r][dl], u_ = dtv * q.x[r][dl], gyv = q.gy[r][dl];
        float bv[kNG], cv[kNG];
        load_vec(bv, &q.b[r][g * kNG]);
        load_vec(cv, &q.c[r][g * kNG]);
        float s1 = 0.f, s2 = 0.f, gb[kNG], gc[kNG];
#pragma unroll
        for (int n = 0; n < kNG; ++n) {
          gh[n] = fmaf(gyv, cv[n], gh[n]);
          gc[n] = gyv * hs[k + 1][n];
          gb[n] = gh[n] * u_;
          s1 = fmaf(gh[n], bv[n], s1);
          const float w = gh[n] * av[k][n] * hs[k][n];     // dL/da_t times a_t
          s2 = fmaf(w, Ar[n], s2);
          gA[n] = fmaf(w, dtv, gA[n]);
          gh[n] *= av[k][n];
        }
        store_vec(&sm.red[0][k][tid * kNG], gb);
        store_vec(&sm.red[1][k][tid * kNG], gc);
        sv[2 * k] = s1;
        sv[2 * k + 1] = s2;
      }
      // gx and gdt of the lane's steps, over x and dt of the staged segment
      // (the G lanes of a d are one warp's: past the warp barrier, none
      // reads them again)
      __syncwarp();
      reduce_scatter<G / 2, 2 * kSub>(sv, g);
      if ((g & dup) == 0) {
#pragma unroll
        for (int i = 0; i < kOut; i += 2) {
          const int r = j * kSub + (base + i) / 2;
          const float xv = q.x[r][dl];
          q.x[r][dl] = q.dt[r][dl] * sv[i];
          q.dt[r][dl] = fmaf(xv, sv[i], sv[i + 1]);
        }
      }
      if (more) {
        stash(nxt, cur ^ 1, jj);
        for (int p = jj + 1; j == 0 && p < npiece; ++p) {   // pieces a short segment left
          fetch(nxt, u + 1, p);
          stash(nxt, cur ^ 1, p);
        }
      }
      __syncthreads();
      if (jj == 0 && u > 0) cluster_wait();      // the cluster is done with the rows
      {                                          // the terms summed over the block's d's
        // thread (sum si, share p): si's float4 gg = tid % G4, p the next
        // bits, so a quarter warp reads eight distinct float4 slots
        const int gg = tid % G4, p = tid / G4 % P, si = tid / (G4 * P) * G4 + gg;
        const int which = si / (kSub * G4), k = si / G4 % kSub;
        const float4* src = reinterpret_cast<const float4*>(&sm.red[which][k][0]) + gg;
        float4 acc[M];
#pragma unroll
        for (int i = 0; i < kDB / P; ++i) {      // term e = p + i P: running sum e % 8
          const float4 t = src[(p + i * P) * G4];
          acc[i % M] = i < M ? t : add4(acc[i % M], t);
        }
        // the eight joined: pairs j, j ^ 4, then j ^ 2, then j ^ 1 (this
        // thread holds j = p + P m; a pair across threads by a shuffle)
#pragma unroll
        for (int x = 4, c = M; x > 0; x >>= 1) {
          if (x >= P) {
            c /= 2;
#pragma unroll
            for (int m = 0; m < 4; ++m)
              if (m < c && m + c < M) acc[m] = add4(acc[m], acc[m + c]);
          } else {
            acc[0] = add4(acc[0], shfl_xor4(acc[0], x * G4));
          }
        }
        if (p == 0) *reinterpret_cast<float4*>(&sm.rows[which][j * kSub + k][gg * 4]) = acc[0];
      }
      if (j > 0) {
        if (more) fetch(nxt, u + 1, jj + 1);
        recompute<N>(q, &sm.ck[j - 1][tid * kNG], j - 1, dl, g, a2, hs, av);
      }
      __syncthreads();
    }
    // gx and gdt of the segment, as rows
    for (int e = tid; e < len * kDB; e += kT) {
      const int k = e / kDB, j = e % kDB;
      if (d0 + j < D) {
        const size_t off = ((size_t)b * S + t0 + k) * D + d0 + j;
        st(gx, off, q.x[k][j], in.x_bf16);
        st(gdt, off, q.dt[k][j], in.dt_bf16);
      }
    }
    if (s == 0) {                 // the batch row's end: gh is dL/dh0; gA over the rows in order
      if (live && gh0 != nullptr)
        store_vec(gh0 + ((size_t)b * D + d) * N + g * kNG, gh);
#pragma unroll
      for (int n = 0; n < kNG; ++n) {
        gAt[n] += gA[n];
        gA[n] = gh[n] = 0.f;
      }
    }
    cluster_arrive();             // this block's rows of unit u are complete
  }
  // -- bwd: tail
  cluster_wait();
  exchange(nunit - 1);
  cluster_arrive();
  cluster_wait();                 // no block leaves while another reads its rows
  if (live) store_vec(gA_out + (size_t)d * N + g * kNG, gAt);
}

// The clusters' rows added in a fixed order: gB and gC over the nclu
// clusters of a batch row (split_sum).
__global__ void scan_bwd_reduce(const float* __restrict__ part, void* gB, void* gC, int B,
                                int S, int N, int nclu, int bc_bf16) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per = (size_t)S * N, nbc = (size_t)B * per;
  if (i < nbc) {
    const size_t b = i / per, r = i % per;
    st(gB, i, split_sum(part + b * nclu * per + r, per, nclu), bc_bf16);
    st(gC, i, split_sum(part + ((size_t)B + b) * nclu * per + r, per, nclu), bc_bf16);
  }
}

template <int N>
cudaError_t launch(const Inputs& in, const float* A, const float* h_chk, const float* gy,
                   void* gx, void* gdt, void* gB, void* gC, float* gA, float* gh0, float* part,
                   int B, int S, int D, int L, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem<N>);
  static_assert(smem <= (size_t)kMaxSmem, "the backward's shared memory exceeds the opt-in limit");
  // once per process, on the first (eager) launch
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(scan_bwd<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return opt_in;
  const int nblk = (D + d_block(N) - 1) / d_block(N), CL = cluster_size(nblk);
  const int nclu = n_clusters(N, D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nclu * CL);
  cfg.blockDim = dim3(threads(N));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, scan_bwd<N>, in, A, h_chk, gy, gx, gdt, gA, part,
                                       gh0, B, S, D, L);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n = (size_t)B * S * N;
  scan_bwd_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, gB, gC, B, S, N, nclu,
                                                                    in.bc_bf16);
  return cudaGetLastError();
}

bool valid_n(int N) { return N == 4 || N == 8 || N == 16 || N == 32 || N == 64; }

}  // namespace

// f32 elements of the backward's scratch (`part`) at these sizes: each
// cluster's gB and gC rows; -1 for a state size without a build.
extern "C" long long selective_scan_bwd_scratch(int B, int S, int D, int N) {
  if (B < 1 || S < 1 || D < 1 || !valid_n(N)) return -1;
  return 2LL * B * n_clusters(N, D) * S * N;
}

// x, dt: (B, S, D) contiguous, bf16 where x_bf16 / dt_bf16 is nonzero, else
// f32; Bm, Cm: (B, S, N) as the forward reads them (strides b_sb, b_st, c_sb,
// c_st, last stride 1, any alignment); A: (D, N) f32; h_chk: (B, ceil(S /
// L), D, N) f32 from the forward with the same L (32 or kSeg); gy: (B, S, D)
// f32.  Outputs: gx, gdt (B, S, D) in x's and dt's dtypes; gB, gC (B, S, N)
// contiguous, bf16 where bc_bf16 is nonzero; gA (D, N) f32; gh0 (B, D, N)
// f32 or null; part: scratch of selective_scan_bwd_scratch(B, S, D, N) f32.
// A, h_chk, gA, gh0 and part 16-byte aligned.  N in {4, 8, 16, 32, 64}.
extern "C" int selective_scan_bwd(const void* x, const void* dt, const void* Bm, const void* Cm,
                                  const void* A, const void* h_chk, const void* gy, void* gx,
                                  void* gdt, void* gB, void* gC, void* gA, void* gh0,
                                  void* part, int B, int S, int D, int N, int L, int b_sb,
                                  int b_st, int c_sb, int c_st, int x_bf16, int dt_bf16,
                                  int bc_bf16, void* stream) {
  if (B < 1 || D < 1 || S < 1 || L < 32 || L > kSeg || L % 32 != 0) return cudaErrorInvalidValue;
  const Inputs in{x, dt, Bm, Cm, b_sb, b_st, c_sb, c_st, x_bf16, dt_bf16, bc_bf16};
  const auto* a = static_cast<const float*>(A);
  const auto* hc = static_cast<const float*>(h_chk);
  const auto* g = static_cast<const float*>(gy);
  auto* ga = static_cast<float*>(gA);
  auto* g0 = static_cast<float*>(gh0);
  auto* p = static_cast<float*>(part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, s);
    case 8: return launch<8>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, s);
    case 16: return launch<16>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, s);
    case 32: return launch<32>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, s);
    case 64: return launch<64>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, s);
    default: return cudaErrorInvalidValue;
  }
}
