// Selective scan, the mamba1 recurrence, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py:58, `selective_scan`
// (Pallas body `_scan_kernel`), and adds the initial state h0 that decode
// continues from (the Pallas kernel always starts from zeros).
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,    y_t = <h_t, C_t>
//
// x, dt: (B, S, D) contiguous, f32 or bf16 each; Bm, Cm: (B, S, N), f32 or
// bf16 (both the same), any batch and time strides and last stride 1 (so
// views into the x_proj output are read where they lie); A: (D, N) f32;
// h0: (B, D, N) f32 or null (zeros).  Outputs y: (B, S, D) f32 and h_out:
// (B, D, N) f32, the state after the last step.  h_out may be h0 itself:
// each thread reads its part of h0 before its first step and writes the
// same part of h_out after its last, so decode updates the pool's state in
// place.  A step with dt = 0 passes the state through (exp2(0) = 1 and the
// update is 0), which the model's right padding relies on.
//
// Training adds h_chk: (B, ceil(S / L), D, N) f32, the state *before* each
// interval of L steps (L a multiple of kChunk), which the backward
// (mamba_scan_bwd.cu) reloads to recompute an interval instead of saving
// every step's state.  Each thread stores its NG states from registers when
// its step count reaches a multiple of L: in scan_chunked at the start of
// such a chunk (a build of its own, kChk), in scan_direct (S <= 8 < L) once,
// before its steps.  Serving passes a null h_chk, which changes nothing else
// (scripts/ab_scan_kernel.py --baseline times it against the source before
// h_chk).
//
// The mamba2 block (zamba2, N = 64) runs the same recurrence with channel
// d = (head, p): its dt and A are a head's, repeated over the head's P
// channels by the caller, and its one B/C group is shared by every d.
//
// What the TPU kernel keeps out of HBM, and what this one does instead.
// The Pallas grid (B, D / block_d, n_chunks) runs its chunk axis in order
// and carries h from chunk to chunk in VMEM scratch.  Blocks of a CUDA grid
// run in no order and share nothing, so a thread owns its states for the
// whole sequence and loops over all S itself: h stays in registers and
// crosses device memory twice (h0 in, h_out out), never once per step.
//
// Layout: G = N / NG lanes per (b, d), each holding NG consecutive states
// in registers (loaded and stored as float4/float2, and its row of A the
// same way).  y_t is summed in-thread over those NG states, then over the G
// lanes.  The wrapper's `launch_plan` picks NG and the kernel.  Why not one
// lane per state (the first port of this kernel): at G = N = 16 every step
// paid a 4-level shuffle butterfly per lane, 4 shuffles per state element,
// and a thread with one state has no independent work to overlap.  With NG
// states a thread has NG independent h chains, and the shuffles per state
// element fall by NG times or more (below).
//
// Two kernels:
// - scan_direct, for short S (decode: B = 8, S = 1).  No shared memory
//   and no barrier: each thread issues its loads of h0, A, x, dt, B and C
//   before their first use and writes y and h_out from registers.  At
//   B = 8, D = 8192 the launch is one wave, so the time is one round of
//   memory latency plus the state's bytes (the bound: 8 MiB of h in and
//   out), not a chain of staging phases repeated per wave.
// - scan_chunked, for longer S (prefill: B = 1, S = 16..512).  A block owns
//   kDBlock d's of one batch row (kDBlock * G threads) and walks the
//   sequence in chunks of kChunk steps, staged in shared memory in a ring
//   of two: each thread issues its loads of chunk c + 1 into registers
//   before it computes chunk c and stores them (as f32, with dt * x formed
//   once) into the other buffer after, so one barrier a chunk separates
//   the two and the loads' latency hides behind a chunk of compute.
//   Through registers rather than cp.async: the inputs arrive in bf16 or
//   f32 at any alignment and stride (views of the x_proj output), and
//   converting once at staging keeps the inner loop free of conversions,
//   which G lanes would otherwise repeat.  A cp.async ring of 2 to 8 raw
//   chunks, each unit converted by the thread that copied it, was no
//   faster in exploratory runs on an H100: the loads are not what bounds
//   a chunk, its instructions are (scripts/ab_scan_kernel.py --phases
//   times the kernel cut after its staging and after its compute).
//   kChunk = kDBlock = 32 was the fastest of 16 to 64 in those runs.  The
//   last chunk computes only its own steps, rounded up to G, so a 16-step
//   bucket does not pay for 32.  y of a chunk goes to shared memory and
//   back to device memory as whole rows.
//   The G lanes of a d reduce G consecutive steps together by recursive
//   halving (a reduce-scatter): G - 1 shuffles for G steps, after which
//   lane g holds y of step g.  Per (t, d) that is G - 1 lane-shuffles, 7
//   at G = 8, against 64 with one lane per state (16 lanes x 4 levels).
//   Padded steps are staged as dt = 0, x = 0: they leave h unchanged and
//   their y is not written.
//
// Bound on this card (the least time for the work): at decode, bytes (h0
// read and h_out written); at prefill, the S * D * N exponentials on the
// SFU (16 per SM per clock), with the bytes of x, dt and y close behind.
// What holds the kernel above it (scripts/ab_scan_kernel.py --phases): at
// decode, the launch and one round trip of memory; at prefill, the
// instructions of the staging and of the steps, not the SFU.  An
// exponential is ex2.approx of dt * (A log2 e), with A log2 e formed once
// per thread: one SFU operation and one multiply, where expf adds a range
// reduction of about six instructions.  Its relative error (about 2^-22)
// keeps y and h within 1e-4 of the plain version over 512 steps; no
// fast-math flag (the int8 quantizer's bit-exactness needs its absence).
//
// Not done: splitting the time axis over blocks (a carry between chunks by
// decoupled look-back) would fill more of the card at B = 1, but every
// state update and exponential of a chunk would then be computed twice,
// once for the chunk's local scan and once for its correction, and the
// instructions, not idle SMs, set the time.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // scan_direct's block
constexpr int kDBlock = 32;     // d's of one scan_chunked block
constexpr int kChunk = 32;      // steps of one staged chunk
constexpr float kLog2e = 1.4426950408889634f;

struct Inputs {
  const void* x;
  const void* dt;
  const void* bm;
  const void* cm;
  int b_sb, b_st, c_sb, c_st;   // batch and time strides of Bm and Cm
  int x_bf16, dt_bf16, bc_bf16;
};

// Element i of a bf16 or f32 array, as raw bits (a bf16 zero-extended):
// the load's result is not used until as_f32, so a prefetch does not stall.
__device__ __forceinline__ uint32_t ld_bits(const void* p, size_t i, int bf16) {
  if (bf16) return static_cast<uint32_t>(__ldg(static_cast<const unsigned short*>(p) + i));
  return __float_as_uint(__ldg(static_cast<const float*>(p) + i));
}

// bf16 -> f32 is exact: the bits move to the top half.
__device__ __forceinline__ float as_f32(uint32_t bits, int bf16) {
  return __uint_as_float(bf16 ? bits << 16 : bits);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// NG consecutive floats at p (16-byte aligned for NG >= 4, 8 for NG = 2).
template <int NG> __device__ __forceinline__ void load_vec(float (&v)[NG], const float* p) {
  if constexpr (NG % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NG; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
    static_assert(NG == 2, "NG is 2, 4 or 8");
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int NG> __device__ __forceinline__ void store_vec(float* p, const float (&v)[NG]) {
  if constexpr (NG % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NG; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// This thread's states and its row of A (times log2 e); zeros off the edge.
template <int N, int NG>
__device__ __forceinline__ void load_state(float (&a2)[NG], float (&h)[NG], const float* A,
                                           const float* h0, size_t bd, int d, int g, bool live) {
#pragma unroll
  for (int j = 0; j < NG; ++j) a2[j] = h[j] = 0.f;
  if (!live) return;
  load_vec<NG>(a2, A + (size_t)d * N + g * NG);
#pragma unroll
  for (int j = 0; j < NG; ++j) a2[j] *= kLog2e;
  if (h0 != nullptr) load_vec<NG>(h, h0 + bd * N + g * NG);
}

// One step of this thread's NG states; returns its part of y_t.
template <int NG>
__device__ __forceinline__ float step(float (&h)[NG], const float (&a2)[NG], float dtv, float u,
                                      const float (&bv)[NG], const float (&cv)[NG]) {
  float p = 0.f;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    h[j] = fmaf(ex2(dtv * a2[j]), h[j], u * bv[j]);
    p = fmaf(h[j], cv[j], p);
  }
  return p;
}

// Reduce-scatter over the G lanes of a d: v[k] is this lane's part of step
// k; afterwards v[0] of lane g is step g's sum.  Level o pairs lanes g and
// g ^ o, the lane with bit o clear keeping the lower half of the steps.
template <int G> __device__ __forceinline__ float reduce_scatter(float (&v)[G], int g) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const bool hi = g & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = hi ? v[i] : v[i + o];
      const float keep = hi ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0];
}

template <int N, int NG>
__global__ void __launch_bounds__(kThreads)
scan_direct(Inputs in, const float* __restrict__ A, const float* h0, float* __restrict__ y,
            float* h_out, float* __restrict__ h_chk, int B, int S, int D) {
  constexpr int G = N / NG;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const int g = i % G;
  const size_t bd = i / G;                        // b * D + d
  const bool live = bd < (size_t)B * D;
  const int b = live ? bd / D : 0, d = live ? bd % D : 0;
  float a2[NG], h[NG];
  load_state<N, NG>(a2, h, A, h0, bd, d, g, live);
  // S <= L here (the entry point refuses more): one interval, from h0
  if (h_chk != nullptr && live) store_vec<NG>(h_chk + bd * N + g * NG, h);
  for (int t = 0; t < S; ++t) {
    const size_t row = (size_t)b * S + t;
    const size_t ob = (size_t)b * in.b_sb + (size_t)t * in.b_st;   // row t of Bm, Cm
    const size_t oc = (size_t)b * in.c_sb + (size_t)t * in.c_st;
    float dtv = 0.f, u = 0.f, bv[NG], cv[NG];
#pragma unroll
    for (int j = 0; j < NG; ++j) bv[j] = cv[j] = 0.f;
    if (live) {
      dtv = as_f32(ld_bits(in.dt, row * D + d, in.dt_bf16), in.dt_bf16);
      u = dtv * as_f32(ld_bits(in.x, row * D + d, in.x_bf16), in.x_bf16);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        bv[j] = as_f32(ld_bits(in.bm, ob + g * NG + j, in.bc_bf16), in.bc_bf16);
        cv[j] = as_f32(ld_bits(in.cm, oc + g * NG + j, in.bc_bf16), in.bc_bf16);
      }
    }
    // -- direct: loaded
    float p = step<NG>(h, a2, dtv, u, bv, cv);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    // -- direct: computed
    if (live && g == 0) y[row * D + d] = p;
  }
  if (live && h_out != nullptr) store_vec<NG>(h_out + bd * N + g * NG, h);
}

// scan_chunked's ring of two staged chunks, in dynamic shared memory: at
// N = 64 it is 57 KB, past the 48 KB a static array may take.
template <int N, int G> struct ChunkRing {
  static constexpr int kYRow = kDBlock + 32 / G;           // padded: the G lanes of a warp's
                                                           // d's write G rows without conflict
  float dt[2][kChunk][kDBlock];
  float u[2][kChunk][kDBlock];                             // dt * x
  alignas(16) float b[2][kChunk][N];
  alignas(16) float c[2][kChunk][N];
  float y[2][kChunk][kYRow];
};

template <int N, int NG, bool kChk>
__global__ void __launch_bounds__(kDBlock * (N / NG))
scan_chunked(Inputs in, const float* __restrict__ A, const float* h0, float* __restrict__ y,
             float* h_out, float* __restrict__ h_chk, int S, int D, int L) {
  constexpr int G = N / NG;
  constexpr int kT = kDBlock * G;                          // threads
  constexpr int kXPer = kChunk * kDBlock / kT;             // x, dt elements a thread stages
  constexpr int kBCPer = (kChunk * N + kT - 1) / kT;       // B, C elements a thread stages
  static_assert(G <= kChunk && kChunk % G == 0 && kXPer >= 1, "G lanes must tile a chunk");
  extern __shared__ __align__(16) unsigned char smem[];
  auto& ring = *reinterpret_cast<ChunkRing<N, G>*>(smem);
  auto& s_dt = ring.dt;
  auto& s_u = ring.u;
  auto& s_b = ring.b;
  auto& s_c = ring.c;
  auto& s_y = ring.y;

  const int tid = threadIdx.x, dl = tid / G, g = tid % G;
  const int b = blockIdx.y, d0 = blockIdx.x * kDBlock, d = d0 + dl;
  const bool live = d < D;
  const size_t bd = (size_t)b * D + d;
  float a2[NG], h[NG];
  load_state<N, NG>(a2, h, A, h0, bd, d, g, live);

  uint32_t rx[kXPer], rdt[kXPer], rb[kBCPer], rc[kBCPer];
  // Loads of chunk c into registers (zeros past S or D).
  auto fetch = [&](int c) {
    const int t0 = c * kChunk;
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      const int e = tid + k * kT, t = e / kDBlock, j = e % kDBlock;
      const bool ok = t0 + t < S && d0 + j < D;
      const size_t off = ((size_t)b * S + t0 + t) * D + d0 + j;
      rx[k] = ok ? ld_bits(in.x, off, in.x_bf16) : 0u;
      rdt[k] = ok ? ld_bits(in.dt, off, in.dt_bf16) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kBCPer; ++k) {
      const int e = tid + k * kT, t = e / N, n = e % N;
      const bool ok = e < kChunk * N && t0 + t < S;
      const size_t ts = t0 + t;
      rb[k] = ok ? ld_bits(in.bm, (size_t)b * in.b_sb + ts * in.b_st + n, in.bc_bf16) : 0u;
      rc[k] = ok ? ld_bits(in.cm, (size_t)b * in.c_sb + ts * in.c_st + n, in.bc_bf16) : 0u;
    }
  };
  // Those registers into buffer `buf`, as f32, with dt * x formed once.
  auto stash = [&](int buf) {
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      const int e = tid + k * kT, t = e / kDBlock, j = e % kDBlock;
      const float dtv = as_f32(rdt[k], in.dt_bf16);
      s_dt[buf][t][j] = dtv;
      s_u[buf][t][j] = dtv * as_f32(rx[k], in.x_bf16);
    }
#pragma unroll
    for (int k = 0; k < kBCPer; ++k) {
      const int e = tid + k * kT;
      if (e < kChunk * N) {
        s_b[buf][e / N][e % N] = as_f32(rb[k], in.bc_bf16);
        s_c[buf][e / N][e % N] = as_f32(rc[k], in.bc_bf16);
      }
    }
  };
  // The steps of one chunk, `steps` of them rounded up to G (a constant
  // for a whole chunk, so that loop unrolls fully); y of lane g's step of
  // each group goes to s_y.
  auto compute = [&](int buf, int steps) {
#pragma unroll
    for (int t = 0; t < steps; t += G) {
      float part[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        float bv[NG], cv[NG];
        load_vec<NG>(bv, &s_b[buf][t + k][g * NG]);
        load_vec<NG>(cv, &s_c[buf][t + k][g * NG]);
        part[k] = step<NG>(h, a2, s_dt[buf][t + k][dl], s_u[buf][t + k][dl], bv, cv);
      }
      s_y[buf][t + g][dl] = reduce_scatter<G>(part, g);
    }
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int n_chk = kChk ? (S + L - 1) / L : 0;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, t0 = c * kChunk, T = min(kChunk, S - t0);
    if (c + 1 < n_chunks) fetch(c + 1);
    if constexpr (kChk) {
      if (live && t0 % L == 0)
        store_vec<NG>(h_chk + (((size_t)b * n_chk + t0 / L) * D + d) * N + g * NG, h);
    }
    // -- chunked: staged
    if (T == kChunk) compute(buf, kChunk);
    else compute(buf, T);                                  // the last chunk's own steps
    // -- chunked: computed
    if (c + 1 < n_chunks) stash(buf ^ 1);
    __syncthreads();
    // y of chunk c, as rows; buffer `buf` is next written two chunks on,
    // after the barrier that every thread reaches only once past here
    for (int e = tid; e < T * kDBlock; e += kT) {
      const int t = e / kDBlock, j = e % kDBlock;
      if (d0 + j < D) y[((size_t)b * S + t0 + t) * D + d0 + j] = s_y[buf][t][j];
    }
  }
  if (live && h_out != nullptr) store_vec<NG>(h_out + bd * N + g * NG, h);
}

// scan_chunked on its grid, with (kChk) or without h_chk: serving runs the
// build without, whose code has no trace of the checkpoints.  Its ring is
// opted in past 48 KB once per build, on the first (eager) launch.
template <int N, int NG, bool kChk>
cudaError_t launch_chunked(const Inputs& in, const float* A, const float* h0, float* y,
                           float* h_out, float* h_chk, int B, int S, int D, int L,
                           cudaStream_t stream) {
  constexpr size_t smem = sizeof(ChunkRing<N, N / NG>);
  if constexpr (smem > 48 * 1024) {
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        scan_chunked<N, NG, kChk>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (opt_in != cudaSuccess) return opt_in;
  }
  const dim3 grid((D + kDBlock - 1) / kDBlock, B);
  scan_chunked<N, NG, kChk><<<grid, kDBlock * (N / NG), smem, stream>>>(
      in, A, h0, y, h_out, h_chk, S, D, L);
  return cudaSuccess;
}

// The two builds for N states: NG of them a thread as the wrapper's
// launch_plan picks it (direct: min(8, N); chunked: G = min(8, N / 2) lanes
// a d, so NG = max(2, N / 8)).  Any other ng is refused, so the two sides
// cannot drift apart unnoticed.  (One lane a d in scan_chunked would stage
// 32 elements of x and dt a thread and unroll a chunk of all N states: past
// the register file.)
template <int N>
cudaError_t launch(const Inputs& in, const float* A, const float* h0, float* y, float* h_out,
                   float* h_chk, int B, int S, int D, int L, int ng, int chunked,
                   cudaStream_t stream) {
  constexpr int kDirectNG = N < 8 ? N : 8;
  constexpr int kChunkedNG = N / 8 > 2 ? N / 8 : 2;
  if (ng != (chunked ? kChunkedNG : kDirectNG)) return cudaErrorInvalidValue;
  if (chunked) {
    const cudaError_t err =
        h_chk != nullptr
            ? launch_chunked<N, kChunkedNG, true>(in, A, h0, y, h_out, h_chk, B, S, D, L, stream)
            : launch_chunked<N, kChunkedNG, false>(in, A, h0, y, h_out, h_chk, B, S, D, L,
                                                    stream);
    if (err != cudaSuccess) return err;
  } else {
    const size_t threads = (size_t)B * D * (N / kDirectNG);
    scan_direct<N, kDirectNG><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                                stream>>>(in, A, h0, y, h_out, h_chk, B, S, D);
  }
  return cudaGetLastError();
}

}  // namespace

// x, dt: (B, S, D) contiguous, bf16 where x_bf16 / dt_bf16 is nonzero, else
// f32; Bm, Cm: (B, S, N), bf16 where bc_bf16 is nonzero, else f32, element
// (b, t, n) at b * b_sb + t * b_st + n (c_sb, c_st for Cm);
// A: (D, N) f32; h0: (B, D, N) f32 or null; y: (B, S, D) f32; h_out:
// (B, D, N) f32 (may be h0); h_chk: (B, ceil(S / L), D, N) f32 or null, L a
// positive multiple of kChunk.  A, h0, h_out and h_chk 16-byte aligned.  N in
// {4, 8, 16, 32, 64}; ng (states a thread) and chunked (which kernel) from the
// wrapper's launch_plan, which the builds above must match.
extern "C" int selective_scan(const void* x, const void* dt, const void* Bm, const void* Cm,
                              const void* A, const void* h0, void* y, void* h_out,
                              void* h_chk, int B, int S, int D, int N, int ng, int chunked,
                              int b_sb, int b_st, int c_sb, int c_st, int x_bf16,
                              int dt_bf16, int bc_bf16, int L, void* stream) {
  if (B < 1 || D < 1 || S < 0) return cudaErrorInvalidValue;
  if (h_chk == nullptr) L = kChunk;                        // not read
  if (L < kChunk || L % kChunk != 0 || (!chunked && S > L)) return cudaErrorInvalidValue;
  const Inputs in{x, dt, Bm, Cm, b_sb, b_st, c_sb, c_st, x_bf16, dt_bf16, bc_bf16};
  const auto* a = static_cast<const float*>(A);
  const auto* h = static_cast<const float*>(h0);
  auto* yo = static_cast<float*>(y);
  auto* ho = static_cast<float*>(h_out);
  auto* hc = static_cast<float*>(h_chk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(in, a, h, yo, ho, hc, B, S, D, L, ng, chunked, st);
    case 8: return launch<8>(in, a, h, yo, ho, hc, B, S, D, L, ng, chunked, st);
    case 16: return launch<16>(in, a, h, yo, ho, hc, B, S, D, L, ng, chunked, st);
    case 32: return launch<32>(in, a, h, yo, ho, hc, B, S, D, L, ng, chunked, st);
    case 64: return launch<64>(in, a, h, yo, ho, hc, B, S, D, L, ng, chunked, st);
    default: return cudaErrorInvalidValue;
  }
}
