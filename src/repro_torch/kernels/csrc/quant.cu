// Blockwise symmetric int8 quantization for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant/kernel.py, `quantize` (Pallas body
// `_quant_kernel`) and `dequantize` (body `_dequant_kernel`).
//
// quantize: per block of `block` values,
//   scale = max(max|x|, 1e-12) / 127,  s = x / scale,  lo = floor(s),
//   q = clip(lo + (u < s - lo), -127, 127)
// with the uniforms u supplied by the caller: an (n,) array (random
// rounding, the gradient path) or one value for every element (the serving
// engine's u = 0.5).  dequantize: x = q * scale, in f32 or rounded to bf16.
//
// Bit-exact against the plain version: the division is an IEEE division
// (__fdiv_rn), never a multiply by the reciprocal, and the build passes no
// fast-math flag; max, floor, compare and clip are exact in any order, and
// widening bf16 x to f32 is exact.
//
// Bound on this card: bytes (x and u read once, q and the scales written
// once; the dequantizer reads q and writes x), a handful of operations a
// value.  What the design does about it:
// - quantize_kernel: one trip to memory per block.  A team, one warp for
//   blocks up to kWarpBlockMax values and the whole CTA above, owns a
//   block; each thread loads its share once, kVecBytes at a time (4 f32 or
//   8 bf16 of x, and the matching u as float4s), keeps it in registers,
//   takes the team's max (warp shuffles, then shared memory across the
//   CTA's warps) and quantizes from the registers, storing its 4 or 8 int8
//   as one packed store.  u of one value is read once a thread.
// - The grid is the CTAs that fit on the card at once (the SM count from
//   the caller, the occupancy from the runtime), not the data: teams stride
//   over the blocks, and each starts the next block's loads before it
//   reduces the current one, so two trips to memory are in flight a team.
// - A block beyond a CTA team's registers (more than kGridBlockMin values:
//   the gradient push quantizes a whole tensor as one block, up to 1.13e9
//   values) takes the grid-wide path: `parts` CTAs a block.  First
//   quantize_amax_kernel writes each CTA's max |x| over its share; then
//   quantize_grid_kernel, with the same CTAs, folds its block's partial
//   maxima into the scale (CTA 0 of the block stores it) and rounds its
//   share, each value with its own u.  So x is read twice (the honest
//   floor of a one-block quantizer: the scale depends on every value
//   before any value can be rounded), u once, q written once; no atomics.
//   Both kernels load 16 bytes a thread where the block allows it, one
//   value a thread where it does not (a ragged or misaligned block).
// - quantize_scalar_kernel takes what the vector kernel cannot below that
//   size: a block that is not a multiple of the vector width or a pointer
//   that is not 16-byte aligned (a view at an odd offset); a warp per
//   block, two passes over it.
// - dequantize_kernel: 16 int8 a thread (one 16-byte load), one scale, no
//   division per value, then 4 float4 stores (f32) or 2 16-byte stores
//   (bf16), each contiguous across the warp: a store instruction that left
//   16-byte gaps between lanes wrote each 32-byte sector in two halves and
//   ran slower than one 4-byte store a value; lanes trade q words by
//   shuffles instead.  dequantize_scalar_kernel takes a block that is not a
//   multiple of 16 or a misaligned pointer.
#include "common.cuh"

namespace {

constexpr int kVecBytes = 16;        // bytes of x a thread loads at a time
constexpr int kCtaThreads = 256;     // threads of every CTA
constexpr int kWarpBlockMax = 1024;  // a warp per block up to this many values, a CTA above
constexpr int kCtaMaxVpl = 4;        // vectors of x a thread of a CTA team holds at most
constexpr int kDqVals = 16;          // int8 values a dequantize thread takes
constexpr int kGridBlockMin = 4096;  // blocks above this many values go grid-wide (above a
                                     // CTA team's kCtaMaxVpl f32 vectors a thread)

template <typename XT> struct XVec;  // kVecBytes of x
template <> struct XVec<float> {
  using T = float4;
  static constexpr int V = kVecBytes / sizeof(float);
};
template <> struct XVec<__nv_bfloat16> {
  using T = uint4;
  static constexpr int V = kVecBytes / sizeof(__nv_bfloat16);
};

__device__ __forceinline__ void unpack(const float4& v, float* f) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// 8 bf16, element 0 in the low half of the first word; widening is exact.
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ int quant1(float x, float u, float scale) {
  const float s = __fdiv_rn(x, scale);
  const float lo = floorf(s);
  const float qv = lo + ((u < s - lo) ? 1.f : 0.f);
  return static_cast<int>(fminf(fmaxf(qv, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(const int* v) {
  return (v[0] & 0xff) | (v[1] & 0xff) << 8 | (v[2] & 0xff) << 16 | (uint32_t)(v[3] & 0xff) << 24;
}

// Starts one thread's loads of block `blk`: vector i = t + j * TEAM of the
// block into xs[j] (and its u into us[j]); vectors past the block are 0.
template <typename XT, bool U_ONE, int TEAM, int VPL>
__device__ __forceinline__ void load_share(const XT* __restrict__ x, const float* __restrict__ u,
                                           int blk, int block, int t,
                                           typename XVec<XT>::T (&xs)[VPL],
                                           float4 (&us)[VPL][XVec<XT>::V / 4]) {
  using Vec = typename XVec<XT>::T;
  constexpr int V = XVec<XT>::V;
  const Vec* xb = reinterpret_cast<const Vec*>(x + (size_t)blk * block);
  const int n_vec = block / V;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = t + j * TEAM;
    xs[j] = i < n_vec ? xb[i] : Vec{};
    if constexpr (!U_ONE) {
      const float4* ub = reinterpret_cast<const float4*>(u + (size_t)blk * block) + i * (V / 4);
#pragma unroll
      for (int k = 0; k < V / 4; ++k) us[j][k] = i < n_vec ? ub[k] : float4{};
    }
  }
}

template <typename XT, bool U_ONE, int TEAM, int VPL>
__global__ void __launch_bounds__(kCtaThreads)
quantize_kernel(const XT* __restrict__ x, const float* __restrict__ u, int8_t* __restrict__ q,
                float* __restrict__ scales, int n_blocks, int block) {
  using Vec = typename XVec<XT>::T;
  constexpr int V = XVec<XT>::V;
  constexpr int kTeams = kCtaThreads / TEAM;          // teams a CTA
  constexpr int kTeamWarps = TEAM / 32;
  __shared__ float red[2][kTeamWarps];                // a CTA team's warp maxima, by parity
  const int t = threadIdx.x % TEAM;
  const int n_teams = gridDim.x * kTeams;
  const int n_vec = block / V;
  const float u_one = U_ONE ? u[0] : 0.f;

  Vec xn[VPL];                                        // the next block's share
  float4 un[VPL][V / 4];
  int blk = blockIdx.x * kTeams + threadIdx.x / TEAM;
  if (blk < n_blocks) load_share<XT, U_ONE, TEAM, VPL>(x, u, blk, block, t, xn, un);
  for (int it = 0; blk < n_blocks; blk += n_teams, ++it) {
    Vec xc[VPL];
    float4 uc[VPL][V / 4];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      xc[j] = xn[j];
      if constexpr (!U_ONE) {
#pragma unroll
        for (int k = 0; k < V / 4; ++k) uc[j][k] = un[j][k];
      }
    }
    if (blk + n_teams < n_blocks)
      load_share<XT, U_ONE, TEAM, VPL>(x, u, blk + n_teams, block, t, xn, un);

    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      float f[V];
      unpack(xc[j], f);
#pragma unroll
      for (int k = 0; k < V; ++k) amax = fmaxf(amax, fabsf(f[k]));
    }
    // -- quantize: loaded
    amax = port::warp_max(amax);
    if constexpr (kTeamWarps > 1) {
      if (threadIdx.x % 32 == 0) red[it & 1][threadIdx.x / 32] = amax;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kTeamWarps; ++w) amax = fmaxf(amax, red[it & 1][w]);
    }
    const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
    // -- quantize: reduced

    int8_t* qb = q + (size_t)blk * block;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int i = t + j * TEAM;
      if (i >= n_vec) continue;
      float f[V], uf[V];
      int qv[V];
      unpack(xc[j], f);
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        if constexpr (U_ONE) {
          uf[4 * k] = uf[4 * k + 1] = uf[4 * k + 2] = uf[4 * k + 3] = u_one;
        } else {
          unpack(uc[j][k], uf + 4 * k);
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) qv[k] = quant1(f[k], uf[k], scale);
      if constexpr (V == 4) {
        *reinterpret_cast<uint32_t*>(qb + i * V) = pack4(qv);
      } else {
        *reinterpret_cast<uint2*>(qb + i * V) = make_uint2(pack4(qv), pack4(qv + 4));
      }
    }
    if (t == 0) scales[blk] = scale;
  }
}

// The grid-wide path: CTA c works on block c / parts, share c % parts.
// VEC: 16-byte vectors of x (and u); otherwise one value at a time.
template <typename XT, bool VEC>
__global__ void __launch_bounds__(kCtaThreads)
quantize_amax_kernel(const XT* __restrict__ x, float* __restrict__ partial, int block,
                     int parts) {
  using Vec = typename XVec<XT>::T;
  constexpr int V = VEC ? XVec<XT>::V : 1;
  __shared__ float red[kCtaThreads / 32];
  const int blk = blockIdx.x / parts, part = blockIdx.x % parts;
  const XT* xb = x + (size_t)blk * block;
  const int n = block / V;
  float amax = 0.f;
  for (long long i = part * kCtaThreads + threadIdx.x; i < n; i += (long long)parts * kCtaThreads) {
    if constexpr (VEC) {
      float f[XVec<XT>::V];
      unpack(reinterpret_cast<const Vec*>(xb)[i], f);
#pragma unroll
      for (int k = 0; k < V; ++k) amax = fmaxf(amax, fabsf(f[k]));
    } else {
      amax = fmaxf(amax, fabsf(port::to_f32(xb[i])));
    }
  }
  // -- quantize (grid): loaded
  amax = port::warp_max(amax);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kCtaThreads / 32; ++w) amax = fmaxf(amax, red[w]);
    partial[blockIdx.x] = amax;
  }
}

template <typename XT, bool U_ONE, bool VEC>
__global__ void __launch_bounds__(kCtaThreads)
quantize_grid_kernel(const XT* __restrict__ x, const float* __restrict__ u,
                     int8_t* __restrict__ q, float* __restrict__ scales,
                     const float* __restrict__ partial, int block, int parts) {
  using Vec = typename XVec<XT>::T;
  constexpr int V = VEC ? XVec<XT>::V : 1;
  __shared__ float red[kCtaThreads / 32];
  const int blk = blockIdx.x / parts, part = blockIdx.x % parts;
  float amax = 0.f;                                   // the block's max, from the partials
  for (int i = threadIdx.x; i < parts; i += kCtaThreads)
    amax = fmaxf(amax, partial[(size_t)blk * parts + i]);
  amax = port::warp_max(amax);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kCtaThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
  if (part == 0 && threadIdx.x == 0) scales[blk] = scale;

  const size_t base = (size_t)blk * block;
  const float u_one = U_ONE ? u[0] : 0.f;
  const int n = block / V;
  for (long long i = part * kCtaThreads + threadIdx.x; i < n; i += (long long)parts * kCtaThreads) {
    if constexpr (VEC) {
      float f[V], uf[V];
      int qv[V];
      unpack(reinterpret_cast<const Vec*>(x + base)[i], f);
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        if constexpr (U_ONE) {
          uf[4 * k] = uf[4 * k + 1] = uf[4 * k + 2] = uf[4 * k + 3] = u_one;
        } else {
          unpack(reinterpret_cast<const float4*>(u + base)[i * (V / 4) + k], uf + 4 * k);
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) qv[k] = quant1(f[k], uf[k], scale);
      if constexpr (V == 4) {
        reinterpret_cast<uint32_t*>(q + base)[i] = pack4(qv);
      } else {
        reinterpret_cast<uint2*>(q + base)[i] = make_uint2(pack4(qv), pack4(qv + 4));
      }
    } else {
      q[base + i] = static_cast<int8_t>(
          quant1(port::to_f32(x[base + i]), U_ONE ? u_one : u[base + i], scale));
    }
  }
}

template <typename XT, bool U_ONE>
__global__ void __launch_bounds__(kCtaThreads)
quantize_scalar_kernel(const XT* __restrict__ x, const float* __restrict__ u,
                       int8_t* __restrict__ q, float* __restrict__ scales, int n_blocks,
                       int block) {
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * (kCtaThreads / 32);
  const float u_one = U_ONE ? u[0] : 0.f;
  for (int blk = blockIdx.x * (kCtaThreads / 32) + threadIdx.x / 32; blk < n_blocks;
       blk += n_warps) {                               // whole warps stride together
    const size_t base = (size_t)blk * block;
    float amax = 0.f;
    for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(port::to_f32(x[base + i])));
    amax = port::warp_max(amax);
    const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
    for (int i = lane; i < block; i += 32)
      q[base + i] = static_cast<int8_t>(
          quant1(port::to_f32(x[base + i]), U_ONE ? u_one : u[base + i], scale));
    if (lane == 0) scales[blk] = scale;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16;
}

// 16-byte stores of OT: E values, E / 4 words of q.  A warp takes 32
// chunks of kDqVals int8 (one 16-byte load a lane) and writes them back as
// 16-byte stores that are contiguous across the warp: store k of lane l
// holds values k * 32E + lE .. + E of the warp's chunks, whose q words a
// shuffle brings from the lane that loaded them, with that lane's scale.
template <typename OT>
__global__ void __launch_bounds__(kCtaThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  OT* __restrict__ x, int n_chunks, int chunks_per_block) {
  constexpr int E = kVecBytes / sizeof(OT);
  constexpr int kStores = kDqVals / E;                 // 16-byte stores a lane
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * (kCtaThreads / 32);
  for (int base = (blockIdx.x * (kCtaThreads / 32) + threadIdx.x / 32) * 32; base < n_chunks;
       base += n_warps * 32) {                         // whole warps stride together
    const int c = base + lane;
    const uint4 raw = c < n_chunks ? reinterpret_cast<const uint4*>(q)[c] : uint4{};
    const float s = c < n_chunks ? scales[c / chunks_per_block] : 0.f;
    // -- dequantize: loaded
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    const int first = (E * lane / 4) % 4;             // this lane's first word in its source
#pragma unroll
    for (int k = 0; k < kStores; ++k) {
      const int src = 2 * E * k + E * lane / 16;      // the lane that loaded this store's q
      uint32_t got[E / 4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v = __shfl_sync(0xffffffffu, w[j], src);
#pragma unroll
        for (int m = 0; m < E / 4; ++m)
          if (j == first + m) got[m] = v;
      }
      const float sc = __shfl_sync(0xffffffffu, s, src);
      if (base + src >= n_chunks) continue;
      float f[E];
#pragma unroll
      for (int e = 0; e < E; ++e)   // sign-extend byte e % 4 of word e / 4
        f[e] = __fmul_rn(static_cast<float>(static_cast<int>(got[e / 4] << (24 - 8 * (e % 4))) >> 24), sc);
      OT* o = x + (size_t)base * kDqVals + k * 32 * E + E * lane;
      if constexpr (E == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
      } else {
        *reinterpret_cast<uint4*>(o) = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                                  pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
      }
    }
  }
}

template <typename OT>
__global__ void __launch_bounds__(kCtaThreads)
dequantize_scalar_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                         OT* __restrict__ x, int n, int block) {
  for (int i = blockIdx.x * kCtaThreads + threadIdx.x; i < n; i += gridDim.x * kCtaThreads)
    x[i] = port::from_f32<OT>(__fmul_rn(static_cast<float>(q[i]), scales[i / block]));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0; }

// The CTAs of `kernel` that fit on the card at once, at most `want`.
template <typename Kernel>
int card_grid(Kernel kernel, int n_sms, long long want) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCtaThreads, 0) != cudaSuccess
      || per_sm < 1)
    per_sm = 1;
  const long long cap = (long long)per_sm * n_sms;
  return static_cast<int>(want < cap ? want : cap);
}

// The vector kernel with the fewest vectors a thread (a power of two) that
// holds `vpl`: a warp team up to kWarpBlockMax values, a CTA team up to
// kCtaMaxVpl vectors a thread.
template <typename XT, bool U_ONE, int TEAM, int VPL>
int launch_vector(const XT* x, const float* u, int8_t* q, float* scales, int n_blocks, int block,
                  int vpl, int n_sms, cudaStream_t st) {
  constexpr int kMostVpl = TEAM == 32 ? kWarpBlockMax / (32 * XVec<XT>::V) : kCtaMaxVpl;
  if constexpr (VPL < kMostVpl) {
    if (vpl > VPL)
      return launch_vector<XT, U_ONE, TEAM, VPL * 2>(x, u, q, scales, n_blocks, block, vpl, n_sms, st);
  }
  const auto kernel = quantize_kernel<XT, U_ONE, TEAM, VPL>;
  constexpr int kTeams = kCtaThreads / TEAM;
  const int grid = card_grid(kernel, n_sms, (n_blocks + kTeams - 1) / kTeams);
  kernel<<<grid, kCtaThreads, 0, st>>>(x, u, q, scales, n_blocks, block);
  return cudaGetLastError();
}

// The grid-wide path's two launches; `partial` holds n_partial floats.
template <typename XT, bool U_ONE, bool VEC>
int launch_grid(const XT* x, const float* u, int8_t* q, float* scales, float* partial,
                int n_partial, int n_blocks, int block, int n_sms, cudaStream_t st) {
  const auto amax_kernel = quantize_amax_kernel<XT, VEC>;
  const long long cap = card_grid(amax_kernel, n_sms, 1LL << 30);   // CTAs the card holds
  const int n = block / (VEC ? XVec<XT>::V : 1);
  long long parts = cap / n_blocks;
  parts = parts < (n + kCtaThreads - 1) / kCtaThreads ? parts : (n + kCtaThreads - 1) / kCtaThreads;
  parts = parts < n_partial / n_blocks ? parts : n_partial / n_blocks;
  if (parts < 1) parts = 1;
  if (parts * n_blocks > n_partial) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(parts * n_blocks);
  amax_kernel<<<grid, kCtaThreads, 0, st>>>(x, partial, block, (int)parts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  quantize_grid_kernel<XT, U_ONE, VEC><<<grid, kCtaThreads, 0, st>>>(x, u, q, scales, partial,
                                                                     block, (int)parts);
  return cudaGetLastError();
}

template <typename XT, bool U_ONE>
int launch_quantize(const void* xp, const float* u, int8_t* q, float* scales, float* partial,
                    int n_partial, int n_blocks, int block, int n_sms, cudaStream_t st) {
  constexpr int V = XVec<XT>::V;
  const XT* x = static_cast<const XT*>(xp);
  const int team = block <= kWarpBlockMax ? 32 : kCtaThreads;
  const int vpl = (block / V + team - 1) / team;
  const bool vec = block % V == 0 && aligned16(x) && aligned16(q) && (U_ONE || aligned16(u));
  if (vec && (team == 32 || vpl <= kCtaMaxVpl)) {
    return team == 32
               ? launch_vector<XT, U_ONE, 32, 1>(x, u, q, scales, n_blocks, block, vpl, n_sms, st)
               : launch_vector<XT, U_ONE, kCtaThreads, 1>(x, u, q, scales, n_blocks, block, vpl,
                                                          n_sms, st);
  }
  if (block > kGridBlockMin)
    return vec ? launch_grid<XT, U_ONE, true>(x, u, q, scales, partial, n_partial, n_blocks,
                                               block, n_sms, st)
               : launch_grid<XT, U_ONE, false>(x, u, q, scales, partial, n_partial, n_blocks,
                                                block, n_sms, st);
  const auto kernel = quantize_scalar_kernel<XT, U_ONE>;
  constexpr int kWarps = kCtaThreads / 32;
  const int grid = card_grid(kernel, n_sms, (n_blocks + kWarps - 1) / kWarps);
  kernel<<<grid, kCtaThreads, 0, st>>>(x, u, q, scales, n_blocks, block);
  return cudaGetLastError();
}

template <typename OT>
int launch_dequantize(const int8_t* q, const float* scales, void* xp, int n, int block, int n_sms,
                      cudaStream_t st) {
  OT* x = static_cast<OT*>(xp);
  if (block % kDqVals == 0 && aligned16(q) && aligned16(x)) {
    const auto kernel = dequantize_kernel<OT>;
    const int n_chunks = n / kDqVals;
    const int grid = card_grid(kernel, n_sms, (n_chunks + kCtaThreads - 1) / kCtaThreads);
    kernel<<<grid, kCtaThreads, 0, st>>>(q, scales, x, n_chunks, block / kDqVals);
  } else {
    const auto kernel = dequantize_scalar_kernel<OT>;
    const int grid = card_grid(kernel, n_sms, (n + kCtaThreads - 1) / kCtaThreads);
    kernel<<<grid, kCtaThreads, 0, st>>>(q, scales, x, n, block);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (n,) f32 or bf16 (x_bf16); u: (n,) f32, or one f32 for every element
// (u_one); q: (n,) int8; scales: (n / block,) f32; n % block == 0; n_sms:
// the card's SM count; partial: n_partial f32 of scratch for the grid-wide
// path (at least n / block, the more the wider its grid).
extern "C" int quantize(const void* x, const void* u, void* q, void* scales, void* partial,
                        int n, int block, int x_bf16, int u_one, int n_sms, int n_partial,
                        void* stream) {
  if (n == 0) return cudaSuccess;
  if (block < 1 || n % block || n_sms < 1 || n_partial < n / block) return cudaErrorInvalidValue;
  const float* uf = static_cast<const float*>(u);
  int8_t* qq = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scales);
  float* pp = static_cast<float*>(partial);
  const int nb = n / block;
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return u_one ? launch_quantize<__nv_bfloat16, true>(x, uf, qq, sc, pp, n_partial, nb, block,
                                                        n_sms, st)
                 : launch_quantize<__nv_bfloat16, false>(x, uf, qq, sc, pp, n_partial, nb, block,
                                                         n_sms, st);
  return u_one ? launch_quantize<float, true>(x, uf, qq, sc, pp, n_partial, nb, block, n_sms, st)
               : launch_quantize<float, false>(x, uf, qq, sc, pp, n_partial, nb, block, n_sms, st);
}

// q: (n,) int8; scales: (n / block,) f32; x: (n,) f32, or bf16 (out_bf16).
extern "C" int dequantize(const void* q, const void* scales, void* x, int n, int block,
                          int out_bf16, int n_sms, void* stream) {
  if (n == 0) return cudaSuccess;
  if (block < 1 || n % block || n_sms < 1) return cudaErrorInvalidValue;
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  const auto st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_dequantize<__nv_bfloat16>(qq, sc, x, n, block, n_sms, st)
                  : launch_dequantize<float>(qq, sc, x, n, block, n_sms, st);
}
