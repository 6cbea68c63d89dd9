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
// intervals from the last to the first, carrying gh = dL/dh, and at each
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
// Design.  The forward's layout: a block owns kDB d's of one batch row, G =
// N / kNG lanes a d, each lane kNG states in registers.  An interval's
// states are recomputed, not read: from its h_chk row, pass A walks the
// interval forward and keeps the state at each start of kSub steps in
// shared memory (each thread its own, so no barrier); then, from the last
// such sub-interval to the first, pass B recomputes the kSub states into
// registers (a_t with them) and walks them back.  Both passes compute a
// state as the forward does, fmaf(ex2(dt * A log2 e), h, (dt x) B), so the
// states are the forward's bits.  Sums over n within a d's lanes are
// shuffles.  Sums over d (gB, gC) cross threads and blocks: each step's
// per-thread terms go to shared memory, and after each sub-interval the
// block adds them over its d's into its own partial row in `part`; over b
// (gA) each thread's sum goes to `part` too.  A second kernel,
// scan_bwd_reduce, adds the partials over blocks (gB, gC) and over b (gA).
// Every sum runs in a fixed order, so two calls give the same bits (no
// atomics); the long ones (kDB d's, up to 256 at N = 4, and the blocks)
// as eight interleaved running sums joined pairwise (split_sum), whose
// rounding grows with an eighth of the terms, not with all of them.
//
// Bound on this card: the exponentials (S * D * N of them for each batch
// row) on the SFU, 16 per SM per clock, with the bytes of x, dt, gy, gx,
// gdt close behind; this kernel computes each exponential twice (passes A
// and B) and writes and reads the partials (2 * B * (D / kDB) * S * N f32).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // a block
constexpr int kNG = 4;          // states a thread
constexpr int kSub = 4;         // steps of a sub-interval, held in registers
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;

struct Inputs {
  const void* x;
  const void* dt;
  const void* bm;
  const void* cm;
  int b_sb, b_st, c_sb, c_st;   // batch and time strides of Bm and Cm
  int x_bf16, dt_bf16, bc_bf16;
};

// As in mamba_scan.cu: element i of a bf16 or f32 array, widened exactly.
__device__ __forceinline__ float ld(const void* p, size_t i, int bf16) {
  if (bf16) return __uint_as_float(static_cast<uint32_t>(
                       __ldg(static_cast<const unsigned short*>(p) + i)) << 16);
  return __ldg(static_cast<const float*>(p) + i);
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

__host__ __device__ constexpr int d_block(int N) { return kThreads / (N / kNG); }

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

__host__ __device__ constexpr size_t smem_bytes(int L) {
  return (size_t)(2 * kSub + L / kSub) * kThreads * sizeof(float4);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
scan_bwd(Inputs in, const float* __restrict__ A, const float* __restrict__ h_chk,
         const float* __restrict__ gy, void* gx, void* gdt, float* __restrict__ part,
         float* __restrict__ gh0, int S, int D, int L) {
  constexpr int G = N / kNG, kDB = d_block(N);
  extern __shared__ float4 smem[];
  float4* red = smem;                          // [2][kSub][kThreads]: gB, gC terms
  float4* ck = smem + 2 * kSub * kThreads;     // [L / kSub][kThreads]: sub-interval starts
  const int tid = threadIdx.x, dl = tid / G, g = tid % G;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, B = gridDim.y;
  const int d = blk * kDB + dl;
  const bool live = d < D;
  const int n_chk = (S + L - 1) / L;

  float Ar[kNG], a2[kNG], gh[kNG], gA[kNG];
#pragma unroll
  for (int j = 0; j < kNG; ++j) Ar[j] = a2[j] = gh[j] = gA[j] = 0.f;
  if (live) {
    const float4 q = *reinterpret_cast<const float4*>(A + (size_t)d * N + g * kNG);
    Ar[0] = q.x; Ar[1] = q.y; Ar[2] = q.z; Ar[3] = q.w;
  }
#pragma unroll
  for (int j = 0; j < kNG; ++j) a2[j] = Ar[j] * kLog2e;   // the forward's A log2 e

  // dt, x and this lane's B of step t; zeros past S or D (a no-op step).
  auto inputs = [&](int t, float& dtv, float& xv, float (&bv)[kNG]) {
    dtv = xv = 0.f;
#pragma unroll
    for (int j = 0; j < kNG; ++j) bv[j] = 0.f;
    if (!live || t >= S) return;
    const size_t row = (size_t)b * S + t;
    dtv = ld(in.dt, row * D + d, in.dt_bf16);
    xv = ld(in.x, row * D + d, in.x_bf16);
    const size_t ob = (size_t)b * in.b_sb + (size_t)t * in.b_st + g * kNG;
#pragma unroll
    for (int j = 0; j < kNG; ++j) bv[j] = ld(in.bm, ob + j, in.bc_bf16);
  };

  for (int i = n_chk - 1; i >= 0; --i) {
    const int s0 = i * L, nsub = (min(L, S - s0) + kSub - 1) / kSub;
    float h[kNG] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const float4 q = *reinterpret_cast<const float4*>(
          h_chk + (((size_t)b * n_chk + i) * D + d) * N + g * kNG);
      h[0] = q.x; h[1] = q.y; h[2] = q.z; h[3] = q.w;
    }
    // pass A: the state at each sub-interval's start
    for (int j = 0; j < nsub; ++j) {
      ck[j * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
      if (j + 1 == nsub) break;
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        float dtv, xv, bv[kNG];
        inputs(s0 + j * kSub + k, dtv, xv, bv);
        const float u = dtv * xv;
#pragma unroll
        for (int n = 0; n < kNG; ++n) h[n] = fmaf(ex2(dtv * a2[n]), h[n], u * bv[n]);
      }
    }
    // pass B: each sub-interval recomputed into registers and walked back
    for (int j = nsub - 1; j >= 0; --j) {
      const int t0 = s0 + j * kSub;
      float hs[kSub + 1][kNG], as[kSub][kNG];
      {
        const float4 q = ck[j * kThreads + tid];
        hs[0][0] = q.x; hs[0][1] = q.y; hs[0][2] = q.z; hs[0][3] = q.w;
      }
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        float dtv, xv, bv[kNG];
        inputs(t0 + k, dtv, xv, bv);
        const float u = dtv * xv;
#pragma unroll
        for (int n = 0; n < kNG; ++n) {
          as[k][n] = ex2(dtv * a2[n]);
          hs[k + 1][n] = fmaf(as[k][n], hs[k][n], u * bv[n]);
        }
      }
#pragma unroll
      for (int k = kSub - 1; k >= 0; --k) {
        const int t = t0 + k;
        float dtv, xv, bv[kNG], cv[kNG] = {0.f, 0.f, 0.f, 0.f}, gyv = 0.f;
        inputs(t, dtv, xv, bv);
        if (live && t < S) {
          const size_t row = (size_t)b * S + t;
          gyv = gy[row * D + d];
          const size_t oc = (size_t)b * in.c_sb + (size_t)t * in.c_st + g * kNG;
#pragma unroll
          for (int n = 0; n < kNG; ++n) cv[n] = ld(in.cm, oc + n, in.bc_bf16);
        }
        const float u = dtv * xv;
        float s1 = 0.f, s2 = 0.f, gb[kNG], gc[kNG];
#pragma unroll
        for (int n = 0; n < kNG; ++n) {
          gh[n] = fmaf(gyv, cv[n], gh[n]);
          gc[n] = gyv * hs[k + 1][n];
          gb[n] = gh[n] * u;
          s1 = fmaf(gh[n], bv[n], s1);
          const float w = gh[n] * as[k][n] * hs[k][n];     // dL/da_t times a_t
          s2 = fmaf(w, Ar[n], s2);
          gA[n] = fmaf(w, dtv, gA[n]);
          gh[n] *= as[k][n];
        }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (live && g == 0 && t < S) {
          const size_t e = ((size_t)b * S + t) * D + d;
          st(gx, e, dtv * s1, in.x_bf16);
          st(gdt, e, fmaf(xv, s1, s2), in.dt_bf16);
        }
        red[k * kThreads + tid] = make_float4(gb[0], gb[1], gb[2], gb[3]);
        red[(kSub + k) * kThreads + tid] = make_float4(gc[0], gc[1], gc[2], gc[3]);
      }
      __syncthreads();
      // the sub-interval's gB and gC terms summed over the block's d's, in
      // order of d, into this block's partial rows
      const float* r = reinterpret_cast<const float*>(red);
      for (int o = tid; o < 2 * kSub * N; o += kThreads) {
        const int which = o / (kSub * N), k = (o / N) % kSub, n = o % N;
        const float* p = r + ((size_t)(which * kSub + k) * kThreads + n / kNG) * kNG + n % kNG;
        const float sum = split_sum(p, G * kNG, kDB);
        if (t0 + k < S)
          part[((((size_t)which * B + b) * nblk + blk) * S + t0 + k) * N + n] = sum;
      }
      __syncthreads();
    }
  }
  if (live) {
    float* pa = part + 2 * (size_t)B * nblk * S * N + ((size_t)b * D + d) * N + g * kNG;
    *reinterpret_cast<float4*>(pa) = make_float4(gA[0], gA[1], gA[2], gA[3]);
    if (gh0 != nullptr)
      *reinterpret_cast<float4*>(gh0 + ((size_t)b * D + d) * N + g * kNG) =
          make_float4(gh[0], gh[1], gh[2], gh[3]);
  }
}

// The partials added in a fixed order: gB and gC over the nblk blocks of a
// batch row (split_sum), gA over the batch rows in order.
__global__ void scan_bwd_reduce(const float* __restrict__ part, void* gB, void* gC,
                                float* __restrict__ gA, int B, int S, int N, int D, int nblk,
                                int bc_bf16) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per = (size_t)S * N, nbc = (size_t)B * per;
  if (i < nbc) {
    const size_t b = i / per, r = i % per;
    st(gB, i, split_sum(part + b * nblk * per + r, per, nblk), bc_bf16);
    st(gC, i, split_sum(part + ((size_t)B + b) * nblk * per + r, per, nblk), bc_bf16);
  } else if (i < nbc + (size_t)D * N) {
    const size_t j = i - nbc, dn = (size_t)D * N;
    const float* pa = part + 2 * nbc * nblk;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += pa[b * dn + j];
    gA[j] = s;
  }
}

template <int N>
cudaError_t launch(const Inputs& in, const float* A, const float* h_chk, const float* gy,
                   void* gx, void* gdt, void* gB, void* gC, float* gA, float* gh0, float* part,
                   int B, int S, int D, int L, int ng, int dblock, cudaStream_t stream) {
  if (ng != kNG || dblock != d_block(N)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  // once per process, on the first (eager) launch
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      scan_bwd<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return opt_in;
  const int nblk = (D + d_block(N) - 1) / d_block(N);
  scan_bwd<N><<<dim3(nblk, B), kThreads, smem, stream>>>(in, A, h_chk, gy, gx, gdt, part,
                                                          gh0, S, D, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)B * S * N + (size_t)D * N;
  scan_bwd_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, gB, gC, gA, B, S, N, D, nblk, in.bc_bf16);
  return cudaGetLastError();
}

}  // namespace

// x, dt: (B, S, D) contiguous, bf16 where x_bf16 / dt_bf16 is nonzero, else
// f32; Bm, Cm: (B, S, N) as the forward reads them (strides b_sb, b_st, c_sb,
// c_st, last stride 1); A: (D, N) f32; h_chk: (B, ceil(S / L), D, N) f32 from
// the forward with the same L (a positive multiple of kSub); gy: (B, S, D)
// f32.  Outputs: gx, gdt (B, S, D) in x's and dt's dtypes; gB, gC (B, S, N)
// contiguous, bf16 where bc_bf16 is nonzero; gA (D, N) f32; gh0 (B, D, N)
// f32 or null; part: scratch of 2 * B * nblk * S * N + B * D * N f32, nblk =
// ceil(D / dblock).  A, h_chk, gh0 and part 16-byte aligned.  N in {4, 8, 16,
// 32, 64}; ng and dblock from the wrapper's bwd_plan, which must match the
// build (kNG states a thread, kThreads / (N / kNG) d's a block).
extern "C" int selective_scan_bwd(const void* x, const void* dt, const void* Bm, const void* Cm,
                                  const void* A, const void* h_chk, const void* gy, void* gx,
                                  void* gdt, void* gB, void* gC, void* gA, void* gh0,
                                  void* part, int B, int S, int D, int N, int L, int ng,
                                  int dblock, int b_sb, int b_st, int c_sb, int c_st,
                                  int x_bf16, int dt_bf16, int bc_bf16, void* stream) {
  if (B < 1 || D < 1 || S < 1 || L < kSub || L % kSub != 0) return cudaErrorInvalidValue;
  const Inputs in{x, dt, Bm, Cm, b_sb, b_st, c_sb, c_st, x_bf16, dt_bf16, bc_bf16};
  const auto* a = static_cast<const float*>(A);
  const auto* hc = static_cast<const float*>(h_chk);
  const auto* g = static_cast<const float*>(gy);
  auto* ga = static_cast<float*>(gA);
  auto* g0 = static_cast<float*>(gh0);
  auto* p = static_cast<float*>(part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, ng, dblock, s);
    case 8: return launch<8>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, ng, dblock, s);
    case 16: return launch<16>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, ng, dblock, s);
    case 32: return launch<32>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, ng, dblock, s);
    case 64: return launch<64>(in, a, hc, g, gx, gdt, gB, gC, ga, g0, p, B, S, D, L, ng, dblock, s);
    default: return cudaErrorInvalidValue;
  }
}
