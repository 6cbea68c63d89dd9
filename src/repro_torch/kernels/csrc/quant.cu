// Blockwise symmetric int8 quantization for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant/kernel.py, `quantize` (Pallas body
// `_quant_kernel`) and `dequantize` (body `_dequant_kernel`).
//
// quantize: per block of `block` values,
//   scale = max(max|x|, 1e-12) / 127,  s = x / scale,  lo = floor(s),
//   q = clip(lo + (u < s - lo), -127, 127)
// with the uniforms u supplied by the caller (the serving engine passes 0.5).
// dequantize: x = q * scale.
//
// Bit-exact against the plain version: the division is an IEEE division
// (__fdiv_rn), never a multiply by the reciprocal, and the build passes no
// fast-math flag; max, floor, compare and clip are exact in any order.
//
// Bound on this card: bytes (x and u read once, 4 + 4 bytes a value; q and
// the scales written once), a handful of operations a value.  One warp per
// block: each lane reads block/32 values (coalesced across the warp), a
// warp reduction gives max|x|, and the lanes quantize their own values.
// The dequantizer is one thread per value.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ u, int8_t* __restrict__ q,
                float* __restrict__ scales, int n_blocks, int block) {
  const int blk = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (blk >= n_blocks) return;               // whole warp leaves together
  const size_t base = (size_t)blk * block;
  float amax = 0.f;
  for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(x[base + i]));
  amax = port::warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
  for (int i = lane; i < block; i += 32) {
    const float s = __fdiv_rn(x[base + i], scale);
    const float lo = floorf(s);
    float qv = lo + ((u[base + i] < s - lo) ? 1.f : 0.f);
    qv = fminf(fmaxf(qv, -127.f), 127.f);
    q[base + i] = static_cast<int8_t>(qv);
  }
  if (lane == 0) scales[blk] = scale;
}

__global__ void dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                                  float* __restrict__ x, int n, int block) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = __fmul_rn(static_cast<float>(q[i]), scales[i / block]);
}

}  // namespace

// x, u: (n,) f32; q: (n,) int8; scales: (n / block,) f32; n % block == 0.
extern "C" int quantize(const void* x, const void* u, void* q, void* scales, int n, int block,
                        void* stream) {
  if (n == 0) return cudaSuccess;
  if (block < 1 || n % block) return cudaErrorInvalidValue;
  const int n_blocks = n / block;
  quantize_kernel<<<(n_blocks + kWarps - 1) / kWarps, kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), static_cast<int8_t*>(q),
      static_cast<float*>(scales), n_blocks, block);
  return cudaGetLastError();
}

// q: (n,) int8; scales: (n / block,) f32; x: (n,) f32.
extern "C" int dequantize(const void* q, const void* scales, void* x, int n, int block,
                          void* stream) {
  if (n == 0) return cudaSuccess;
  if (block < 1 || n % block) return cudaErrorInvalidValue;
  dequantize_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), static_cast<float*>(x),
      n, block);
  return cudaGetLastError();
}
