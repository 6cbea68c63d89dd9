// Paged attention for Hopper (sm_90a): S query tokens per request over the
// serving engine's paged KV pool, read in place through the block table.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py, `paged_attention`
// (Pallas body `_paged_kernel`).
//
// Computes, for request b, query row j (logical position pos[b] + j) and
// query head h (KV head h / G):
//   softmax_kv( q . k * hd^-0.5, masked where kv position > query position )
//   . v
// over the first `n_vis` columns of the request's block table; kv position
// of (column kb, offset t) is kb * BS + t.  Stale table entries point at the
// trash block, whose positions are all in the future, so the one mask rule
// covers tail blocks, causality inside a chunk and stale rows.  Online
// softmax, masking and accumulation are in f32, as in the JAX kernel.
//
// Bound on this card: bytes.  Each visible KV block is read once from HBM
// (sum_b ctx_b * K * hd * 2 * sizeof(pool)); the arithmetic is ~2 flops a
// byte.  At a decode tick that is under 3 MB, so the kernel is bound by
// latency: how many SMs work at once and how many dependent memory round
// trips lie between launch and the last store.
//
// Design (split-KV, "flash-decoding"):
// - One CTA serves one (request, KV head, tile of 16 (query token, head)
//   rows, split of the KV axis).  All G heads x S rows of the tile read
//   each K/V block from shared memory, so the pool is read once per KV head
//   and row tile, not once per query head.
// - The host sizes the splits from n_vis (never from pos, which would cost a
//   sync per layer): whole 32-key stages, at most three a split, and enough
//   splits that B x K x tiles x splits fills the SMs.  A decode tick of 8
//   requests x 2 KV heads gets 9 splits of 2 stages.
// - A CTA loads pos, its q rows and its table entries together, then exits
//   at once if its split starts past the tile's last query position (such a
//   split is not counted).  Split 0 holds position 0, which every query
//   sees, so the merged maximum is finite.
// - The blocks the rows need are copied in the pool's own dtype (bf16 or
//   f32, not widened) with 16-byte cp.async lines, every stage of the split
//   in flight at once, into shared memory rows padded by 16 bytes.
// - No reduction per score: lane t of a warp holds key t of the stage and
//   loops over hd in shared memory for its warp's 4 rows; the stage's row
//   max and sum are one warp reduction each per 32 keys.  P goes through
//   shared memory and each lane accumulates hd/32 dims of P.V (2, 3 or 4
//   at hd 64, 96 and 128; at 3 its loads and stores are scalar).  (mma.sync
//   would need bf16 q and a bf16 pool; the serving default pool is f32 and
//   an f32 q must keep f32 scores, so the CUDA cores serve all four dtype
//   pairs.)
// - The combine is in the same launch: with more than one live split each
//   CTA writes f32 partials (m, l, acc[hd]) to scratch and one thread bumps
//   the counter of its (request, KV head, row tile) with an acq_rel atomic;
//   the CTA that brings it to the number of live splits merges the partials
//   in one pass by log-sum-exp, writes the output and resets the counter to
//   0 for the next launch.  With one live split the CTA writes the output
//   directly and touches no counter.
//
// Left for a later PR: tensor cores for bf16 pools, TMA block loads, the
// table and block loads of the next layer's launch overlapped (PDL).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kStage = 32;                     // keys of a stage: one per lane
constexpr int kMaxStages = 3;                  // stages of a split, all loaded at once
static_assert(kMaxStages == 3, "the stage loop waits on three copy groups");

template <typename T> struct Line {             // 16-byte lines of T
  static constexpr int kElems = 16 / sizeof(T);
};

// A padded shared-memory row of one key: hd values and one spare line.
template <typename PoolT, int HD> __host__ __device__ constexpr int row_ld() {
  return HD + Line<PoolT>::kElems;
}

// K and V of every stage of a split, q widened to f32, and p.
template <typename PoolT, int HD> size_t smem_bytes(int stages) {
  return (size_t)2 * stages * kStage * row_ld<PoolT, HD>() * sizeof(PoolT) +
         (size_t)kRowsPerCta * HD * sizeof(float) + (size_t)kRowsPerCta * kStage * sizeof(float);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <int D> __device__ __forceinline__ void loadD(const float* p, float (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = p[i];
}

// An odd D (hd 96: 3 a lane) starts at an odd element for odd lanes, so
// it is read and written one value at a time; an even D as bf16 pairs,
// and as one float2 / float4 (D = 2 / 4, 8- / 16-byte aligned).
template <int D> __device__ __forceinline__ void loadD(const __nv_bfloat16* p, float (&x)[D]) {
  if constexpr (D % 2) {
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = __bfloat162float(p[i]);
  } else {
#pragma unroll
    for (int i = 0; i < D; i += 2) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
      x[i] = f.x;
      x[i + 1] = f.y;
    }
  }
}

// D consecutive floats as one vector store / L2 load (D = 2 or 4), or D
// scalar ones.
template <int D> __device__ __forceinline__ void store_f32(float* p, const float (&x)[D]) {
  if constexpr (D == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (D == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) p[i] = x[i];
  }
}

template <int D> __device__ __forceinline__ void load_f32_cg(const float* p, float (&x)[D]) {
  if constexpr (D == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (D == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = __ldcg(p + i);
  }
}

template <typename QT, typename PoolT, int HD, int BS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const PoolT* __restrict__ k_pool,
                       const PoolT* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ pos, QT* __restrict__ out,
                       float2* __restrict__ part_ml, float* __restrict__ part_acc,
                       int* __restrict__ counters, int S, int H, int K, int MB, int n_vis,
                       int n_split, int split_keys, float scale) {
  constexpr int D = HD / 32;                   // accumulator dims of a lane
  constexpr int LD = row_ld<PoolT, HD>();
  constexpr int LE = Line<PoolT>::kElems;
  constexpr int LINES = HD / LE;               // 16-byte lines per key row
  constexpr int KITER = kStage * LINES / kThreads;
  constexpr int QE = 16 / sizeof(QT);          // q values in a 16-byte line
  constexpr int QLINES = kRowsPerCta * HD / QE;   // the tile's q lines: 192 at
  constexpr int QITER = (QLINES + kThreads - 1) / kThreads;   // hd 96 bf16
  static_assert(HD % 32 == 0 && kStage * LINES % kThreads == 0, "a key row's lines");
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_bufs = split_keys / kStage;      // stages of a split
  PoolT* ks = reinterpret_cast<PoolT*>(smem);  // [n_bufs][kStage][LD]
  PoolT* vs = ks + n_bufs * kStage * LD;       // [n_bufs][kStage][LD]
  float* qs = reinterpret_cast<float*>(vs + n_bufs * kStage * LD);   // [kRowsPerCta][HD]
  float* ps = qs + kRowsPerCta * HD;           // [kRowsPerCta][kStage]
  __shared__ int s_last;

  const int b = blockIdx.z, kh = blockIdx.y;
  const int split = blockIdx.x % n_split, tile = blockIdx.x / n_split;
  const int n_row_tiles = gridDim.x / n_split;
  const int G = H / K, rows = S * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = tile * kRowsPerCta;

  // The position, the tile's q rows and the split's table entries load
  // together; the blocks follow once pos says which the rows need.
  const int p0 = pos[b];
  uint4 qv[QITER];
#pragma unroll
  for (int i = 0; i < QITER; ++i) {
    const int e = tid + i * kThreads, r = e / (HD / QE), c = e % (HD / QE), row = row0 + r;
    const size_t src = ((size_t)(b * S + row / G) * H + kh * G + row % G) * HD + c * QE;
    qv[i] = e < QLINES && row < rows ? __ldg(reinterpret_cast<const uint4*>(q + src))
                                     : make_uint4(0, 0, 0, 0);
  }
  const int k_begin = split * split_keys;
  const int k_lim = min(k_begin + split_keys, n_vis * BS);   // the split's visible keys
  int phys[kMaxStages][KITER];                 // table entries, loaded beside pos
#pragma unroll
  for (int st = 0; st < kMaxStages; ++st)
#pragma unroll
    for (int i = 0; i < KITER; ++i) {
      const int key = k_begin + st * kStage + (tid + i * kThreads) / LINES;
      phys[st][i] = key < k_lim ? __ldg(tables + (size_t)b * MB + key / BS) : 0;
    }

  // keys past end_key are masked for every row of the tile
  const int last_row = min(row0 + kRowsPerCta, rows) - 1;
  const int end_key = min(n_vis * BS, p0 + last_row / G + 1);
  const int n_live = min(n_split, (end_key + split_keys - 1) / split_keys);
  if (split >= n_live) return;                 // wholly in the future
  const int k_end = min(k_lim, end_key);
  const int n_stages = (k_end - k_begin + kStage - 1) / kStage;

  // every stage the rows need in flight at once, one copy group a stage
#pragma unroll
  for (int st = 0; st < kMaxStages; ++st) {
#pragma unroll
    for (int i = 0; i < KITER; ++i) {
      const int e = tid + i * kThreads, t = e / LINES, c = e % LINES;
      const int key = k_begin + st * kStage + t;
      if (key >= k_end) continue;
      const size_t off = (((size_t)phys[st][i] * BS + key % BS) * K + kh) * HD + c * LE;
      const int so = (st * kStage + t) * LD + c * LE;
      port::cp_async16(port::smem_addr(ks + so), k_pool + off);
      port::cp_async16(port::smem_addr(vs + so), v_pool + off);
    }
    port::cp_async_commit();
  }

  // q rows of the tile, widened to f32
#pragma unroll
  for (int i = 0; i < QITER; ++i) {
    if (tid + i * kThreads >= QLINES) break;
    float* dst = qs + (size_t)(tid + i * kThreads) * QE;
    if constexpr (QE == 8) {
      float x[8];
      load8(reinterpret_cast<const __nv_bfloat16*>(&qv[i]), x);
      reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
    } else {
      *reinterpret_cast<uint4*>(dst) = qv[i];
    }
  }

  float acc[kRowsPerWarp][D], m[kRowsPerWarp], l[kRowsPerWarp];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    qpos[r] = row < rows ? p0 + row / G : INT_MIN;
    m[r] = port::kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[r][i] = 0.f;
  }
  const float* qw = qs + warp * kRowsPerWarp * HD;
  float* pw = ps + warp * kRowsPerWarp * kStage;
  const bool warp_live = row0 + warp * kRowsPerWarp < rows;   // decode: 12 of 16 rows

  for (int st = 0; st < n_stages; ++st) {
    if (st == 0) port::cp_async_wait<kMaxStages - 1>();   // stage st has landed
    else if (st == 1) port::cp_async_wait<kMaxStages - 2>();
    else port::cp_async_wait<0>();
    __syncthreads();                           // ... for every thread (and q)
    if (!warp_live) continue;
    const PoolT* kt = ks + st * kStage * LD;
    const PoolT* vt = vs + st * kStage * LD;
    const int k0 = k_begin + st * kStage;
    const int nk = min(kStage, k_end - k0);

    // scores: lane = key, its warp's 4 rows
    float dot[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) dot[r] = 0.f;
    const PoolT* krow = kt + lane * LD;
#pragma unroll
    for (int d = 0; d < HD; d += 8) {
      float kx[8];
      load8(krow + d, kx);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float qx[8];
        load8(qw + r * HD + d, qx);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot[r] += qx[i] * kx[i];
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float s = lane >= nk ? -INFINITY
                                 : (key <= qpos[r] ? dot[r] * scale : port::kMaskValue);
      const float mx = fmaxf(m[r], port::warp_max(s));
      const float corr = expf(m[r] - mx);
      const float p = expf(s - mx);
      l[r] = l[r] * corr + port::warp_sum(p);
      m[r] = mx;
      pw[r * kStage + lane] = p;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[r][i] *= corr;
    }
    __syncwarp();

    // acc += P . V: lane holds dims lane * D .. lane * D + D - 1
#pragma unroll 8
    for (int t = 0; t < nk; ++t) {
      float vx[D];
      loadD<D>(vt + t * LD + lane * D, vx);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = pw[r * kStage + t];
#pragma unroll
        for (int i = 0; i < D; ++i) acc[r][i] += p * vx[i];
      }
    }
    __syncwarp();                              // p consumed
  }
  port::cp_async_wait<0>();

  auto store = [&](int row, const float(&a)[D], float denom) {
    QT* op = out + ((size_t)(b * S + row / G) * H + kh * G + row % G) * HD + lane * D;
#pragma unroll
    for (int i = 0; i < D; ++i) op[i] = port::from_f32<QT>(a[i] / denom);
  };

  if (n_live == 1) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + warp * kRowsPerWarp + r;
      if (row < rows) store(row, acc[r], fmaxf(l[r], 1e-30f));
    }
    return;
  }

  // partials of this split, then the last CTA of the group merges
  const int grp = (b * K + kh) * n_row_tiles + tile;
  const size_t base = (size_t)grp * n_split * kRowsPerCta;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const size_t idx = base + (size_t)split * kRowsPerCta + warp * kRowsPerWarp + r;
    if (lane == 0) part_ml[idx] = make_float2(m[r], l[r]);
    store_f32<D>(part_acc + idx * HD + lane * D, acc[r]);
  }
  __syncthreads();                             // the CTA's partials are written
  if (tid == 0) {                              // release them, acquire the others'
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counters + grp)
                 : "memory");
    s_last = prev == n_live - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // one pass over the splits, rescaling as the running maximum grows; the
  // loads of four splits x four rows are in flight at once
  float M[kRowsPerWarp], L[kRowsPerWarp], a[kRowsPerWarp][D];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    M[r] = port::kMaskValue;
    L[r] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) a[r][i] = 0.f;
  }
#pragma unroll 4
  for (int sp = 0; sp < n_live; ++sp) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const size_t idx = base + (size_t)sp * kRowsPerCta + warp * kRowsPerWarp + r;
      const float2 ml = __ldcg(part_ml + idx);
      float pa[D];
      load_f32_cg<D>(part_acc + idx * HD + lane * D, pa);
      const float mx = fmaxf(M[r], ml.x);
      const float c = expf(M[r] - mx), w = expf(ml.x - mx);
      L[r] = L[r] * c + ml.y * w;
#pragma unroll
      for (int i = 0; i < D; ++i) a[r][i] = a[r][i] * c + w * pa[i];
      M[r] = mx;
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row < rows) store(row, a[r], fmaxf(L[r], 1e-30f));
  }
  if (tid == 0) counters[grp] = 0;
}

template <typename QT, typename PoolT, int HD, int BS>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                   const void* pos, void* out, void* part_ml, void* part_acc, void* counters,
                   int B, int S, int H, int K, int MB, int n_vis, int n_split, int split_keys,
                   float scale, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, PoolT, HD, BS>;
  const size_t smem = smem_bytes<PoolT, HD>(split_keys / kStage);   // above 48 KB: opt in
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles = (S * (H / K) + kRowsPerCta - 1) / kRowsPerCta;
  dim3 grid(tiles * n_split, K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PoolT*>(k_pool),
      static_cast<const PoolT*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<QT*>(out), static_cast<float2*>(part_ml),
      static_cast<float*>(part_acc), static_cast<int*>(counters), S, H, K, MB, n_vis, n_split,
      split_keys, scale);
  return cudaGetLastError();
}

template <typename QT, typename PoolT>
cudaError_t dispatch_shape(const void* q, const void* kp, const void* vp, const void* tables,
                           const void* pos, void* out, void* pml, void* pacc, void* cnt, int B,
                           int S, int H, int K, int hd, int bs, int MB, int n_vis, int n_split,
                           int split_keys, float scale, cudaStream_t st) {
#define PORT_PAGED_CASE(HD_, BS_)                                                              \
  if (hd == HD_ && bs == BS_)                                                                  \
    return launch<QT, PoolT, HD_, BS_>(q, kp, vp, tables, pos, out, pml, pacc, cnt, B, S, H, K, \
                                       MB, n_vis, n_split, split_keys, scale, st);
  PORT_PAGED_CASE(64, 8)
  PORT_PAGED_CASE(64, 16)
  PORT_PAGED_CASE(96, 8)
  PORT_PAGED_CASE(96, 16)
  PORT_PAGED_CASE(128, 8)
  PORT_PAGED_CASE(128, 16)
#undef PORT_PAGED_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, S, H, hd); k_pool, v_pool: (NB, bs, K, hd); tables: (B, MB) int32;
// pos: (B,) int32.  q/out are bf16 when q_bf16 else f32; the pools likewise.
// The KV axis is cut into n_split splits of split_keys keys (a multiple of 32).
// With n_split > 1: part_ml (B*K*tiles*n_split*16 float2), part_acc (the same
// x hd floats) and counters (B*K*tiles int32, all 0 on entry, 0 again on exit),
// where tiles = ceil(S*H/K / 16).
extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* tables, const void* pos, void* out, void* part_ml,
                               void* part_acc, void* counters, int B, int S, int H, int K,
                               int hd, int bs, int MB, int n_vis, int n_split, int split_keys,
                               int q_bf16, int pool_bf16, float scale, void* stream) {
  if (B == 0 || S == 0 || n_vis == 0) return cudaSuccess;
  if (n_split < 1 || split_keys < kStage || split_keys % kStage ||
      split_keys > kMaxStages * kStage ||
      (n_split > 1 && (!part_ml || !part_acc || !counters)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PORT_PAGED_ARGS                                                                      \
  q, k_pool, v_pool, tables, pos, out, part_ml, part_acc, counters, B, S, H, K, hd, bs, MB,  \
      n_vis, n_split, split_keys, scale, st
  if (q_bf16 && pool_bf16) return dispatch_shape<__nv_bfloat16, __nv_bfloat16>(PORT_PAGED_ARGS);
  if (q_bf16) return dispatch_shape<__nv_bfloat16, float>(PORT_PAGED_ARGS);
  if (pool_bf16) return dispatch_shape<float, __nv_bfloat16>(PORT_PAGED_ARGS);
  return dispatch_shape<float, float>(PORT_PAGED_ARGS);
#undef PORT_PAGED_ARGS
}
