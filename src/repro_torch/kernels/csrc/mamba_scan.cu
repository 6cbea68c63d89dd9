// Selective scan, the mamba1 recurrence, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py:58, `selective_scan`
// (Pallas body `_scan_kernel`), and adds the initial state h0 that decode
// continues from (the Pallas kernel always starts from zeros).
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,    y_t = <h_t, C_t>
//
// x, dt: (B, S, D), f32 or bf16 each; Bm, Cm: (B, S, N) f32; A: (D, N) f32;
// h0: (B, D, N) f32 or null (zeros).  Outputs y: (B, S, D) f32 and
// h_out: (B, D, N) f32, the state after the last step.  h_out may be h0
// itself: each thread reads its element of h0 before the loop and writes
// the same element of h_out after it, so the decode step updates the
// pool's state in place.
//
// What the TPU kernel keeps out of HBM, and what this one does instead.
// The Pallas grid (B, D / block_d, n_chunks) runs its chunk axis in order
// and carries h from chunk to chunk in an (N, block_d) VMEM scratch.
// Blocks of a CUDA grid run in no order and share nothing, so one block
// owns a batch row and a run of d's and loops over all S itself: h stays
// in registers for the whole sequence and crosses device memory twice
// (h0 in, h_out out), never once per step.
//
// Layout: one lane per (b, d, n).  A group of N lanes (N a power of two,
// 4..32) owns one d, each lane one state element; a shuffle reduction
// over the group gives y_t.  Chosen over one thread per (b, d) because at
// the prefill shape (B = 1, D = 8192, N = 16) it gives 131,072 threads,
// 512 blocks of 256 that fill all 132 SMs, where a thread per d gives
// 8,192 threads, 64 blocks of 128, half the card; and lane n touching
// h0[b, d, n] makes every state load and store coalesced, which is what
// decode (B = 8, S = 1: the state is nearly all of its bytes) needs.
// Every d of a block reads the same B_t and C_t, and neighbouring d's read
// neighbouring x_t and dt_t, so each chunk of kChunk time steps of all
// four is staged in shared memory by coalesced loads; y of the chunk is
// staged there too and written back in rows.
//
// Bound on this card: at decode, bytes (h0 read and h_out written, 8 MiB
// at B = 8); at prefill, the S * D * N exponentials on the SFU (16 per SM
// per clock) and the bytes of x, dt and y are within a factor of two of
// each other.  expf, not __expf, and no fast-math flag: the kernel stays
// within f32 rounding of its plain version.  A simple kernel first: no
// double buffering of the chunk, and the exponentials are not shared.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;

template <typename TX, typename TD, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ A, const float* h0, float* __restrict__ y,
                      float* h_out, int S, int D) {
  constexpr int kD = kThreads / N;             // d's of one block
  __shared__ float xs[kChunk][kD];
  __shared__ float dts[kChunk][kD];
  __shared__ float ys[kChunk][kD];
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kD;
  const int dl = threadIdx.x / N;
  const int n = threadIdx.x % N;
  const int d = d0 + dl;
  const bool live = d < D;
  const size_t state = ((size_t)b * D + d) * N + n;

  const float a = live ? A[(size_t)d * N + n] : 0.f;
  float h = (live && h0 != nullptr) ? h0[state] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int T = min(kChunk, S - t0);
    for (int i = threadIdx.x; i < kChunk * kD; i += kThreads) {
      const int t = i / kD, j = i % kD;
      float xv = 0.f, dv = 0.f;
      if (t < T && d0 + j < D) {
        const size_t off = ((size_t)b * S + t0 + t) * D + d0 + j;
        xv = port::to_f32(x[off]);
        dv = port::to_f32(dt[off]);
      }
      xs[t][j] = xv;
      dts[t][j] = dv;
    }
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const int t = i / N, j = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < T) {
        const size_t off = ((size_t)b * S + t0 + t) * N + j;
        bv = Bm[off];
        cv = Cm[off];
      }
      bs[t][j] = bv;
      cs[t][j] = cv;
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      const float dtv = dts[t][dl];
      const float dA = expf(dtv * a);
      h = dA * h + (dtv * xs[t][dl]) * bs[t][n];
      float p = h * cs[t][n];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (n == 0) ys[t][dl] = p;
    }
    __syncthreads();
    // the next chunk's staging writes only xs, dts, bs and cs, and the
    // barrier after it orders these reads of ys before the next writes
    for (int i = threadIdx.x; i < T * kD; i += kThreads) {
      const int t = i / kD, j = i % kD;
      if (d0 + j < D) y[((size_t)b * S + t0 + t) * D + d0 + j] = ys[t][j];
    }
  }
  if (live && h_out != nullptr) h_out[state] = h;
}

template <typename TX, typename TD, int N>
cudaError_t launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
                   const void* h0, void* y, void* h_out, int B, int S, int D,
                   cudaStream_t stream) {
  constexpr int kD = kThreads / N;
  const dim3 grid((D + kD - 1) / kD, B);
  selective_scan_kernel<TX, TD, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dt), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(A),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(h_out), S, D);
  return cudaGetLastError();
}

template <typename TX, typename TD>
cudaError_t launch_n(const void* x, const void* dt, const void* Bm, const void* Cm,
                     const void* A, const void* h0, void* y, void* h_out, int B, int S, int D,
                     int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<TX, TD, 4>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, D, stream);
    case 8: return launch<TX, TD, 8>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, D, stream);
    case 16: return launch<TX, TD, 16>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, D, stream);
    case 32: return launch<TX, TD, 32>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, D, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dt: (B, S, D), bf16 where x_bf16 / dt_bf16 is nonzero, else f32;
// Bm, Cm: (B, S, N) f32; A: (D, N) f32; h0: (B, D, N) f32 or null;
// y: (B, S, D) f32; h_out: (B, D, N) f32 (may be h0).  N in {4, 8, 16, 32}.
extern "C" int selective_scan(const void* x, const void* dt, const void* Bm, const void* Cm,
                              const void* A, const void* h0, void* y, void* h_out, int B,
                              int S, int D, int N, int x_bf16, int dt_bf16, void* stream) {
  if (B < 1 || D < 1 || S < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16 && dt_bf16) return launch_n<bf16, bf16>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, D, N, st);
  if (x_bf16) return launch_n<bf16, float>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, D, N, st);
  if (dt_bf16) return launch_n<float, bf16>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, D, N, st);
  return launch_n<float, float>(x, dt, Bm, Cm, A, h0, y, h_out, B, S, D, N, st);
}
