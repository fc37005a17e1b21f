// The gradient of streaming-softmax attention, causal or not, with
// grouped KV heads (GQA), for bf16 and f32 inputs:
//
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h/G, j] * scale) v[b, h/G, j]
//
// where a causal row i sees keys j <= i + (Sk - Sq) and G = Hq / Hkv.
// From q, k, v, the forward's output o, its row log-sum-exp lse
// (natural log of sum_j exp(s_ij * scale), f32, written by the forward
// kernels on request) and the output's gradient do:
//
//   P = exp(S * scale - lse)     dV = sum_g P^T dO
//   dP = dO V^T                  delta = rowsum(dO * O)
//   dS = P * (dP - delta)        dQ = dS K * scale
//                                dK = sum_g dS^T Q * scale
//
// sum_g runs over the G q heads of each kv head.
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention) is forward only, and the JAX package trains through
// its XLA attention, which XLA differentiates.  The port's models attend
// through the forward kernel, so their training needs this gradient; a
// plain autograd of the blockwise attention would keep every chunk's
// probabilities, O(S^2) memory again.  kernels/flash_attention/ref.py::
// attention_bwd_ref is its plain version.
//
// Bound: 10 D flops a visible (query, key) pair, against the 989
// TFLOP/s bf16 tensor-core rate (67 TFLOP/s f32) of an H100 SXM at 700 W
// (data sheet); the bytes (q, k, v, o, do read once, dq, dk, dv written
// once) are far below that.  Deterministic: every sum is taken in one
// block in a fixed order, no atomics.  First attention_delta_kernel (one
// warp a row, f32), then two passes a dtype.
//
// * bf16 runs both passes on Hopper's tensor cores, each as the forward
//   (flash_attention_sm90.cu) runs: 3 warpgroups, one thread of the
//   third producing TMA loads (the 128-byte swizzle; D 96 as two
//   64-column chunks whose last 32 columns TMA fills with zeros, never
//   read), the tiles it holds once, then a ring of kStages stages
//   guarded by full and empty mbarriers; setmaxnreg moves registers to
//   the two consumer warpgroups, 64 rows each.  Products are wgmma
//   m64nNk16 with f32 sums: S and dP from two K-major shared operands
//   over D/16 steps; their accumulator layout is the register-A layout
//   of the next product, so P and dS never leave registers and go in as
//   two bf16 terms each, hi = bf16(x) and lo = bf16(x - hi), as the
//   forward does with p: about 16 bits, so the gradients stay within one
//   bf16 ulp of the f32 plain version.  Masks (key > q + Sk - Sq) only
//   on tiles that cross the diagonal; a warpgroup whose rows and keys
//   the diagonal wholly separates skips its products.
//   - attention_dkdv_sm90_kernel: one block a (b, kv head, 128-key
//     tile), earliest keys first.  It holds K and V, streams the 64-row
//     Q and dO tiles (with their lse and delta, 1-D bulk copies) of the
//     q tiles that see the keys, in each the G q heads of the group, and
//     each consumer takes 64 keys: S^T = K Q^T, dP^T = V dO^T, then
//     dV += P^T dO and dK += dS^T Q with dO and Q read MN-major through
//     the transpose bit (n96 at D 96).  The group sum stays in
//     registers; dK and dV are written once.  12 D tensor flops a pair.
//   - attention_dq_sm90_kernel: one block a (b, q head, 128-row q tile),
//     latest rows first.  It holds Q, dO and their rows' lse and delta,
//     streams the 64-key K and V tiles the rows see, and each consumer
//     takes 64 rows: S = Q K^T, dP = dO V^T, dQ += dS K with K read
//     MN-major.  8 D tensor flops a pair.
//   So S and dP are computed in both passes: 20 D tensor flops a pair
//   against the 10 D the gradient needs, 4 D of it the lo terms.  A
//   single pass that computes them once and folds each key tile's share
//   of dQ into an f32 scratch in key-tile order (a counter a q tile,
//   no atomics in arrival order) measured 2.5-3x slower on an H100: the
//   ordered adds and the registers the fold holds cost more than the
//   recomputation (PERF.md).
// * f32 stays on the CUDA cores as fp32 FMAs, as the f32 forward does
//   (TF32 would not hold 1e-4): dK and dV a (b, kv head, 64-key tile)
//   over its G heads, then dQ a (b, q head, 64-row q tile); 256
//   threads, 4 x 4 register tiles of S and dP (rows 16 apart, keys 16
//   apart, float4 along d), 4 x D/16 register tiles of the products into
//   dK, dV and dQ (float4 or float2 along d), rows padded by 4 floats
//   against bank conflicts.
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kB = 64;          // q rows of a q tile, keys of a key tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLdP = kB + 4;    // row stride of the (64, 64) P and dS tiles
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Cols {
  static constexpr int kLd = D + 4;                 // row stride of a (64, D) tile
  static constexpr int kNC = D / 16;                // 4, 6 or 8 columns a thread
  static constexpr int kVW = kNC % 4 == 0 ? 4 : 2;  // as vectors of kVW
  static constexpr int kNV = kNC / kVW;
  static constexpr int kTile = kB * kLd;            // floats of a (64, D) tile
};

template <int VW> struct Vec;
template <> struct Vec<4> { typedef float4 T; };
template <> struct Vec<2> { typedef float2 T; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 64 rows of D floats from g (row-major, contiguous) into s with row
// stride Cols<D>::kLd, a float4 a copy.
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g, int tid) {
  constexpr int kChunks = D / 4;
  for (int i = tid; i < kB * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    *reinterpret_cast<float4*>(s + r * Cols<D>::kLd + 4 * c) =
        *reinterpret_cast<const float4*>(g + 4 * i);
  }
}

// acc[i][j] = a[ty + 16 i] . b[tx + 16 j] over D: rows 16 apart, keys
// 16 apart, float4 along d.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a,
                                         const float* b, int tx, int ty) {
  constexpr int kLd = Cols<D>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + 4 * c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[e][col] += sum_r w[r][4 ty + e] * m[r][col] over the 64 rows r of
// the (64, 64) tile w (row stride kLdP) and the (64, D) tile m: the
// thread's 4 rows of the result (4 ty + e) and its D/16 columns
// ((tx + 16 c) * kVW + 0 .. kVW-1).
template <int D>
__device__ __forceinline__ void tn_tile(float (&acc)[4][Cols<D>::kNC], const float* w,
                                        const float* m, int tx, int ty) {
  typedef Cols<D> C;
  typedef typename Vec<C::kVW>::T V;
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    const float4 p = *reinterpret_cast<const float4*>(w + r * kLdP + 4 * ty);
#pragma unroll
    for (int c = 0; c < C::kNV; ++c) {
      const V x = *reinterpret_cast<const V*>(m + r * C::kLd + (tx + 16 * c) * C::kVW);
#pragma unroll
      for (int e = 0; e < C::kVW; ++e) {
        const float xe = (&x.x)[e];
        acc[0][c * C::kVW + e] = fmaf(p.x, xe, acc[0][c * C::kVW + e]);
        acc[1][c * C::kVW + e] = fmaf(p.y, xe, acc[1][c * C::kVW + e]);
        acc[2][c * C::kVW + e] = fmaf(p.z, xe, acc[2][c * C::kVW + e]);
        acc[3][c * C::kVW + e] = fmaf(p.w, xe, acc[3][c * C::kVW + e]);
      }
    }
  }
}

// out rows 4 ty + e of a (rows, D) tensor <- acc * scale.
template <int D>
__device__ __forceinline__ void write_rows(float* __restrict__ out,
                                           const float (&acc)[4][Cols<D>::kNC], float scale,
                                           int tx, int ty) {
  typedef Cols<D> C;
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < C::kNC; ++c)
      out[static_cast<long long>(4 * ty + e) * D + (tx + 16 * (c / C::kVW)) * C::kVW +
          c % C::kVW] = acc[e][c] * scale;
}

// P (or, with ds, dS) of a thread's 4 x 4 entries from the scores s and
// dp = dO V^T: p = exp(s * scale - lse), 0 where masked.
__device__ __forceinline__ void probabilities(float (&s)[4][4], const float* lse_s,
                                              int q0, int k0, int q_offset, int causal,
                                              float scale, int tx, int ty) {
  const bool mask = causal && k0 + kB - 1 > q0 + q_offset;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = lse_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool hidden = mask && k0 + tx + 16 * j > q0 + r + q_offset;
      s[i][j] = hidden ? 0.f : expf(fmaf(s[i][j], scale, -l));
    }
  }
}

// delta[row] = sum_d dO[row, d] * O[row, d] in f32: a warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
    long long rows, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(dout[row * D + d]), to_f32(o[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) delta[row] = acc;
}

// f32: dK and dV of one (b, kv head, key tile); G q heads a kv head.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) attention_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int n_bkv, int Hq, int group, int Sq, int Sk, float scale, int causal) {
  typedef Cols<D> C;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // (64, D) keys of the tile
  float* vs = ks + C::kTile;        // (64, D) values
  float* qs = vs + C::kTile;        // (64, D) q rows of the q tile
  float* dos = qs + C::kTile;       // (64, D) their dO
  float* ps = dos + C::kTile;       // (64, 64) P
  float* dss = ps + kB * kLdP;      // (64, 64) dS
  float* lse_s = dss + kB * kLdP;   // (64,)
  float* delta_s = lse_s + kB;      // (64,)

  const int kt = static_cast<int>(blockIdx.x) / n_bkv;  // earliest keys (most q tiles) first
  const int bkv = static_cast<int>(blockIdx.x) % n_bkv;  // b * Hkv + kv head
  const int Hkv = Hq / group;
  const int b = bkv / Hkv, kvh = bkv - b * Hkv;
  const int k0 = kt * kB;
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long kv_off = (static_cast<long long>(bkv) * Sk + k0) * D;

  load_tile<D>(ks, k + kv_off, tid);
  load_tile<D>(vs, v + kv_off, tid);

  float acc_k[4][C::kNC], acc_v[4][C::kNC];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < C::kNC; ++c) acc_k[e][c] = acc_v[e][c] = 0.f;

  // causal: the first q tile with a row that sees key k0
  const int first = causal ? max(0, k0 - q_offset) / kB : 0;
  for (int g = 0; g < group; ++g) {
    const long long bh = static_cast<long long>(b) * Hq + kvh * group + g;
    for (int qt = first; qt < Sq / kB; ++qt) {
      const int q0 = qt * kB;
      const long long q_off = (bh * Sq + q0) * D;
      __syncthreads();  // the last iteration's reads of qs, dos, ps, dss done
      load_tile<D>(qs, q + q_off, tid);
      load_tile<D>(dos, dout + q_off, tid);
      if (tid < kB) {
        lse_s[tid] = lse[bh * Sq + q0 + tid];
        delta_s[tid] = delta[bh * Sq + q0 + tid];
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      dot_tile<D>(s, qs, ks, tx, ty);
      probabilities(s, lse_s, q0, k0, q_offset, causal, scale, tx, ty);
      dot_tile<D>(dp, dos, vs, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, key = tx + 16 * j;
          ps[r * kLdP + key] = s[i][j];
          dss[r * kLdP + key] = s[i][j] * (dp[i][j] - delta_s[r]);
        }
      __syncthreads();
      tn_tile<D>(acc_v, ps, dos, tx, ty);   // dV += P^T dO
      tn_tile<D>(acc_k, dss, qs, tx, ty);   // dK += dS^T Q
    }
  }
  write_rows<D>(dk + kv_off, acc_k, scale, tx, ty);
  write_rows<D>(dv + kv_off, acc_v, 1.f, tx, ty);
}

// f32: dQ of one (b, q head, q tile).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) attention_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int n_bh, int Hq,
    int group, int Sq, int Sk, float scale, int causal) {
  typedef Cols<D> C;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // (64, D) q rows of the tile
  float* dos = qs + C::kTile;       // (64, D) their dO
  float* ks = dos + C::kTile;       // (64, D) keys of a key tile
  float* vs = ks + C::kTile;        // (64, D) values
  float* dst = vs + C::kTile;       // (64, 64) dS transposed: key-major
  float* lse_s = dst + kB * kLdP;   // (64,)
  float* delta_s = lse_s + kB;      // (64,)

  const int nq = Sq / kB;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / n_bh;  // heaviest first
  const int bh = static_cast<int>(blockIdx.x) % n_bh;            // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_row = static_cast<long long>(b) * (Hq / group) + h / group;
  const int q0 = qt * kB;
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long q_off = (static_cast<long long>(bh) * Sq + q0) * D;

  load_tile<D>(qs, q + q_off, tid);
  load_tile<D>(dos, dout + q_off, tid);
  if (tid < kB) {
    lse_s[tid] = lse[static_cast<long long>(bh) * Sq + q0 + tid];
    delta_s[tid] = delta[static_cast<long long>(bh) * Sq + q0 + tid];
  }
  float acc[4][C::kNC];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < C::kNC; ++c) acc[e][c] = 0.f;

  int n_tiles = Sk / kB;
  if (causal) n_tiles = min(n_tiles, (q0 + kB - 1 + q_offset) / kB + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    const long long kv_off = (kv_row * Sk + k0) * D;
    __syncthreads();  // the last iteration's reads of ks, vs, dst done
    load_tile<D>(ks, k + kv_off, tid);
    load_tile<D>(vs, v + kv_off, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<D>(s, qs, ks, tx, ty);
    probabilities(s, lse_s, q0, k0, q_offset, causal, scale, tx, ty);
    dot_tile<D>(dp, dos, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, key = tx + 16 * j;
        dst[key * kLdP + r] = s[i][j] * (dp[i][j] - delta_s[r]);
      }
    __syncthreads();
    tn_tile<D>(acc, dst, ks, tx, ty);  // dQ += dS K
  }
  write_rows<D>(dq + q_off, acc, scale, tx, ty);
}

template <int D>
constexpr int dkdv_smem() {
  return static_cast<int>(sizeof(float)) * (4 * Cols<D>::kTile + 2 * kB * kLdP + 2 * kB);
}
template <int D>
constexpr int dq_smem() {
  return static_cast<int>(sizeof(float)) * (4 * Cols<D>::kTile + kB * kLdP + 2 * kB);
}


// ---- bf16 on Hopper: wgmma fed by TMA rings, two passes -------------

typedef __nv_bfloat16 bf16;
constexpr int kKeys = 128;        // dK/dV: keys a block, 64 a consumer warpgroup
constexpr int kRows = 128;        // dQ: q rows a block, 64 a consumer warpgroup
constexpr int kStep = 64;         // q rows (dK/dV) or keys (dQ) a step
constexpr int kStages = 2;        // ring depth
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kSm90Threads = 128 * (kConsumers + 1);
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kBigChunk = 128 * 128;   // a 64-column chunk of a 128-row tile
constexpr int kStepChunk = kStep * 128;  // a 64-column chunk of a 64-row tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct BwdTiles {
  static constexpr int kChunks = (D + 63) / 64;  // 64-column chunks
  static constexpr int kBig = kChunks * kBigChunk;    // a 128-row tile
  static constexpr int kSmall = kChunks * kStepChunk;  // a 64-row tile
  // both kernels: two 128-row tiles held, kStages stages of two 64-row
  // tiles, the rows' lse and delta (dK/dV: a stage's 64 each; dQ: the
  // held tile's 128 each), barriers (held, full[S], empty[S])
  static constexpr int kStats = 2 * 4 * (kStages * kStep > kRows ? kStages * kStep : kRows);
  static constexpr int kBarriers = 1 + 2 * kStages;
  static constexpr int kSmem = 1024 /* alignment slack */ + 2 * kBig + kStages * 2 * kSmall +
                               kStats + 8 * kBarriers;
};

// p = exp2(s scale log2 e - lse log2 e), 0 where masked; ds = p (dp -
// delta): 32 values in the accumulator layout, in place.  row(j, e)
// and col(j, e) give a value's q row and key; lse2 and dl its row's lse
// log2 e and delta.
template <typename Row, typename Col, typename Lse, typename Dl>
__device__ __forceinline__ void probabilities(float (&s)[32], float (&dp)[32], float scale_log2,
                                              bool mask, int q_offset, Row row, Col col,
                                              Lse lse2, Dl dl) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = exp2f(fmaf(s[i], scale_log2, -lse2(j, e)));
      if (mask && col(j, e) > row(j, e) + q_offset) p = 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - dl(j, e));
    }
}

// 32 accumulator values as the register-A fragments (hi and lo terms)
// of the four k16 steps of the next product: a[0] rows r0, columns 16kk
// + c0..; a[1] rows r0+8; a[2]/a[3] columns + 8
__device__ __forceinline__ void to_a(const float (&x)[32], uint32_t (&hi)[4][4],
                                     uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], hi[kk][e], lo[kk][e]);
}

// d (+)= A B over the D/16 k16 steps of a head dim: A the warpgroup's
// 64 rows of a 128- or 64-row tile, B a 64-row tile, both K-major in
// 64-column chunks (a_chunk, b_chunk bytes apart)
template <int D>
__device__ __forceinline__ void product_over_d(float (&d)[32], uint32_t a, int a_chunk,
                                               uint32_t b, int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n64(d, smem_desc(a + (kk / 4) * a_chunk + col, 16, 1024),
                 smem_desc(b + (kk / 4) * b_chunk + col, 16, 1024), kk > 0);
  }
}

// acc (64 rows x D) += A B over 64 (the k16 steps kk): A in registers as
// hi and lo terms, B a 64-row tile read MN-major (chunks b_chunk apart)
template <int D>
__device__ __forceinline__ void product_into_d(float (&acc)[D / 2], const uint32_t (&hi)[4][4],
                                               const uint32_t (&lo)[4][4], uint32_t b,
                                               int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc(b + kk * 16 * 128, b_chunk, 1024);
    if constexpr (D == 128) {
      wgmma_rs_n128(acc, hi[kk], db);
      wgmma_rs_n128(acc, lo[kk], db);
    } else if constexpr (D == 96) {
      wgmma_rs_n96(acc, hi[kk], db);
      wgmma_rs_n96(acc, lo[kk], db);
    } else {
      wgmma_rs_n64(acc, hi[kk], db);
      wgmma_rs_n64(acc, lo[kk], db);
    }
  }
}

// rows r0 and r0 + 8 of a (rows, D) bf16 tensor at out (row r0, column
// c0) <- acc * scale
template <int D>
__device__ __forceinline__ void write_bf16_rows(bf16* out, const float (&acc)[D / 2], float scale) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(out + (8 * r) * D + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
}

__device__ __forceinline__ void init_barriers(uint32_t bars) {
  mbar_init(bars, 1);  // the held tiles
  for (int s = 0; s < kStages; ++s) {
    mbar_init(bars + 8 * (1 + s), 1);                             // full
    mbar_init(bars + 8 * (1 + kStages + s), kConsumerWarps);      // empty
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bf16 pass 1: dK and dV of one (b, kv head, 128-key tile).  The block
// walks the 64-row q tiles that see its keys, last first, and in each
// the G q heads of its group (step t: q tile nq-1 - t/G of head
// kvh*G + t%G), so dK and dV sum the group in registers.
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1) attention_dkdv_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int n_bkv, int Hq, int group, int Sq, int Sk, float scale,
    int causal) {
  using T = BwdTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  // K and V tiles, the ring's stages of (Q, dO), its (lse, delta), barriers
  const uint32_t k_s = base, v_s = k_s + T::kBig;
  const uint32_t ring = v_s + T::kBig;
  const uint32_t stat0 = ring + kStages * 2 * T::kSmall;
  const uint32_t bars = stat0 + T::kStats;
  const auto full = [&](int s) { return bars + 8 * (1 + s); };
  const auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();

  const int kt = static_cast<int>(blockIdx.x) / n_bkv;  // earliest keys (most q tiles) first
  const int bkv = static_cast<int>(blockIdx.x) % n_bkv;  // b * Hkv + kv head
  const int Hkv = Hq / group;
  const int b = bkv / Hkv, kvh = bkv - b * Hkv;
  const int k0 = kt * kKeys;
  const int q_offset = Sk - Sq;
  const int nq = Sq / kStep;
  // causal: the first q tile with a row that sees key k0
  const int first = causal ? max(0, k0 - q_offset) / kStep : 0;
  const int n_steps = (nq - first) * group;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the TMA ring full ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      const int kv_row = bkv * Sk + k0;
      mbar_expect_tx(bars, 2 * T::kBig);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(k_s + c * kBigChunk, &tk, 64 * c, kv_row, bars);
        tma_load(v_s + c * kBigChunk, &tv, 64 * c, kv_row, bars);
      }
      for (int t = 0; t < n_steps; ++t) {
        const int s = t % kStages, phase = (t / kStages) & 1;
        const int row = (b * Hq + kvh * group + t % group) * Sq + (nq - 1 - t / group) * kStep;
        const uint32_t qs = ring + s * 2 * T::kSmall, st = stat0 + s * 2 * kStep * 4;
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), 2 * T::kSmall + 2 * kStep * 4);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(qs + c * kStepChunk, &tq, 64 * c, row, full(s));
          tma_load(qs + T::kSmall + c * kStepChunk, &tdo, 64 * c, row, full(s));
        }
        bulk_load(st, lse + row, kStep * 4, full(s));
        bulk_load(st + kStep * 4, delta + row, kStep * 4, full(s));
      }
    }
  } else {
    // ---- consumers: 64 keys a warpgroup -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // accumulator layout of wgmma m64nN: this thread holds rows
    // r0 = 16*warp + lane/4 and r0 + 8 of the warpgroup's 64, and in
    // every 8-column block j the columns 8j + c0 + {0, 1}: d[4j + 0..1]
    // on row r0, d[4j + 2..3] on row r0 + 8.  Here rows are keys and
    // columns q rows (S^T, dP^T).
    const int r0 = 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int key_lo = k0 + 64 * wg;  // the warpgroup's first key
    const float scale_log2 = scale * kLog2e;
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(bars, 0);
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % kStages, phase = (t / kStages) & 1;
      const int q0 = (nq - 1 - t / group) * kStep;
      const uint32_t qs = ring + s * 2 * T::kSmall, dos = qs + T::kSmall;
      // every key of the warpgroup past every row of the tile; some past
      const bool hidden = causal && key_lo > q0 + kStep - 1 + q_offset;
      const bool mask = causal && key_lo + 63 > q0 + q_offset;
      mbar_wait(full(s), phase);
      if (!hidden) {
        // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 q rows, f32)
        float sc[32], dp[32];
        const uint32_t rows = k_s + 64 * wg * 128;
        wgmma_fence();
        product_over_d<D>(sc, rows, kBigChunk, qs, kStepChunk);
        product_over_d<D>(dp, rows + T::kBig, kBigChunk, dos, kStepChunk);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(sc);
        fence_operands(dp);
        // P^T and dS^T: lse and delta by column (q row), from the stage
        const float* st =
            reinterpret_cast<const float*>(smem_raw + (stat0 + s * 2 * kStep * 4 - raw));
        probabilities(
            sc, dp, scale_log2, mask, q_offset,
            [&](int j, int e) { return q0 + 8 * j + c0 + (e & 1); },
            [&](int j, int e) { return key_lo + r0 + 8 * (e >> 1); },
            [&](int j, int e) { return st[8 * j + c0 + (e & 1)] * kLog2e; },
            [&](int j, int e) { return st[kStep + 8 * j + c0 + (e & 1)]; });
        // dV += P^T dO, then dK += dS^T Q (dO and Q read MN-major): dS's
        // fragments are made while dV's products run, behind a second
        // fence, so one set of fragments is live beside the accumulators
        uint32_t hi[4][4], lo[4][4], dhi[4][4], dlo[4][4];
        to_a(sc, hi, lo);
        fence_operands(acc_v);
        fence_operands(acc_k);
        wgmma_fence();
        product_into_d<D>(acc_v, hi, lo, dos, kStepChunk);
        to_a(dp, dhi, dlo);
        wgmma_fence();
        product_into_d<D>(acc_k, dhi, dlo, qs, kStepChunk);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(acc_v);
        fence_operands(acc_k);
      }
      if (lane == 0) mbar_arrive(empty(s));  // Q, dO, lse and delta read
    }
    // dK (times scale) and dV, each written once
    const long long out = (static_cast<long long>(bkv) * Sk + key_lo + r0) * D + c0;
    write_bf16_rows<D>(dk + out, acc_k, scale);
    write_bf16_rows<D>(dv + out, acc_v, 1.f);
  }
}

// bf16 pass 2: dQ of one (b, q head, 128-row q tile), heaviest (latest
// rows) first; the block walks the 64-key tiles its rows see.
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1) attention_dq_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    int n_bh, int Hq, int group, int Sq, int Sk, float scale, int causal) {
  using T = BwdTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  // Q and dO tiles, the ring's stages of (K, V), the rows' (lse, delta),
  // barriers
  const uint32_t q_s = base, do_s = q_s + T::kBig;
  const uint32_t ring = do_s + T::kBig;
  const uint32_t stat = ring + kStages * 2 * T::kSmall;
  const uint32_t bars = stat + T::kStats;
  const auto full = [&](int s) { return bars + 8 * (1 + s); };
  const auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();

  const int nq = Sq / kRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / n_bh;  // heaviest first
  const int bh = static_cast<int>(blockIdx.x) % n_bh;            // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const int kv_row0 = (b * (Hq / group) + h / group) * Sk;
  const int q0 = qt * kRows;
  const int q_offset = Sk - Sq;
  int n_tiles = Sk / kStep;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1 + q_offset) / kStep + 1);

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer --------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      const int q_row = bh * Sq + q0;
      mbar_expect_tx(bars, 2 * T::kBig + 2 * kRows * 4);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(q_s + c * kBigChunk, &tq, 64 * c, q_row, bars);
        tma_load(do_s + c * kBigChunk, &tdo, 64 * c, q_row, bars);
      }
      bulk_load(stat, lse + q_row, kRows * 4, bars);
      bulk_load(stat + kRows * 4, delta + q_row, kRows * 4, bars);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, phase = (t / kStages) & 1;
        const uint32_t ks = ring + s * 2 * T::kSmall;
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), 2 * T::kSmall);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(ks + c * kStepChunk, &tk, 64 * c, kv_row0 + t * kStep, full(s));
          tma_load(ks + T::kSmall + c * kStepChunk, &tv, 64 * c, kv_row0 + t * kStep, full(s));
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // the accumulator layout as above, rows q rows and columns keys (S, dP)
    const int r0 = 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int row_lo = q0 + 64 * wg;  // the warpgroup's first q row
    const float scale_log2 = scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(bars, 0);
    const float* st = reinterpret_cast<const float*>(smem_raw + (stat - raw));
    const float lse2[2] = {st[64 * wg + r0] * kLog2e, st[64 * wg + r0 + 8] * kLog2e};
    const float dl[2] = {st[kRows + 64 * wg + r0], st[kRows + 64 * wg + r0 + 8]};
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, phase = (t / kStages) & 1;
      const int k0 = t * kStep;
      const uint32_t ks = ring + s * 2 * T::kSmall, vs = ks + T::kSmall;
      // every key of the tile past every row of the warpgroup; some past
      const bool hidden = causal && k0 > row_lo + 63 + q_offset;
      const bool mask = causal && k0 + kStep - 1 > row_lo + q_offset;
      mbar_wait(full(s), phase);
      if (!hidden) {
        // S = Q K^T and dP = dO V^T (64 q rows x 64 keys, f32)
        float sc[32], dp[32];
        const uint32_t rows = q_s + 64 * wg * 128;
        wgmma_fence();
        product_over_d<D>(sc, rows, kBigChunk, ks, kStepChunk);
        product_over_d<D>(dp, rows + T::kBig, kBigChunk, vs, kStepChunk);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(sc);
        fence_operands(dp);
        probabilities(
            sc, dp, scale_log2, mask, q_offset,
            [&](int j, int e) { return row_lo + r0 + 8 * (e >> 1); },
            [&](int j, int e) { return k0 + 8 * j + c0 + (e & 1); },
            [&](int j, int e) { return lse2[e >> 1]; }, [&](int j, int e) { return dl[e >> 1]; });
        // dQ += dS K, K read MN-major
        uint32_t hi[4][4], lo[4][4];
        to_a(dp, hi, lo);
        fence_operands(acc);
        wgmma_fence();
        product_into_d<D>(acc, hi, lo, ks, kStepChunk);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(acc);
      }
      if (lane == 0) mbar_arrive(empty(s));  // K and V read
    }
    write_bf16_rows<D>(dq + (static_cast<long long>(bh) * Sq + row_lo + r0) * D + c0, acc, scale);
  }
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, long long rows, int D,
                 cudaStream_t stream) {
  attention_delta_kernel<T>
      <<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dq, float* dk, float* dv, int B,
               int Hq, int Hkv, int Sq, int Sk, int causal, float scale,
               cudaStream_t stream) {
  auto dkdv = attention_dkdv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dkdv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bkv = B * Hkv;
  dkdv<<<static_cast<unsigned>(n_bkv) * (Sk / kB), kThreads, dkdv_smem<D>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, n_bkv, Hq, Hq / Hkv, Sq, Sk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dqk = attention_dq_kernel<D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = B * Hq;
  dqk<<<static_cast<unsigned>(n_bh) * (Sq / kB), kThreads, dq_smem<D>(), stream>>>(
      q, k, v, dout, lse, delta, dq, n_bh, Hq, Hq / Hkv, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                const float* lse, const float* delta, bf16* dq, bf16* dk, bf16* dv, int B,
                int Hq, int Hkv, int Sq, int Sk, int causal, float scale,
                cudaStream_t stream) {
  if (Sq % kRows != 0 || Sk % kKeys != 0 || reinterpret_cast<uintptr_t>(lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(delta) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the dK/dV pass holds 128-key tiles and streams 64-row q tiles; the
  // dQ pass holds 128-row q tiles and streams 64-key tiles
  const long long q_rows = static_cast<long long>(B) * Hq * Sq;
  const long long kv_rows = static_cast<long long>(B) * Hkv * Sk;
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  if (!tile_map(&q64, q, q_rows, D, kStep) || !tile_map(&do64, dout, q_rows, D, kStep) ||
      !tile_map(&k128, k, kv_rows, D, kKeys) || !tile_map(&v128, v, kv_rows, D, kKeys) ||
      !tile_map(&q128, q, q_rows, D, kRows) || !tile_map(&do128, dout, q_rows, D, kRows) ||
      !tile_map(&k64, k, kv_rows, D, kStep) || !tile_map(&v64, v, kv_rows, D, kStep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = BwdTiles<D>::kSmem;
  auto dkdv = attention_dkdv_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bkv = B * Hkv;
  dkdv<<<static_cast<unsigned>(n_bkv) * (Sk / kKeys), kSm90Threads, smem, stream>>>(
      q64, k128, v128, do64, lse, delta, dk, dv, n_bkv, Hq, Hq / Hkv, Sq, Sk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dqk = attention_dq_sm90_kernel<D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = B * Hq;
  dqk<<<static_cast<unsigned>(n_bh) * (Sq / kRows), kSm90Threads, smem, stream>>>(
      q128, k64, v64, do128, lse, delta, dq, n_bh, Hq, Hq / Hkv, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV and dQ of one type at head dim D
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           float* scratch, void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
           int Sk, int is_bf16, int causal, float scale, cudaStream_t stream) {
  if (is_bf16) {
    return launch_bf16<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
                          scratch, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                          static_cast<bf16*>(dv), B, Hq, Hkv, Sq, Sk, causal, scale, stream);
  }
  return launch_f32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(dout), lse,
                       scratch, static_cast<float*>(dq), static_cast<float*>(dk),
                       static_cast<float*>(dv), B, Hq, Hkv, Sq, Sk, causal, scale, stream);
}

}  // namespace

// q, out, dout, dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); all
// contiguous, on 16 bytes, of one type (bf16 when is_bf16, else f32);
// lse (B, Hq, Sq) f32 from the forward; scratch B*Hq*Sq floats (delta).
// The caller guarantees the forward's contract: D in {64, 96, 128}, Sq
// and Sk multiples of 128, Hq % Hkv == 0 and, when causal, Sq <= Sk.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* scratch, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, int is_bf16, int causal, float scale,
    cudaStream_t stream) {
  if (static_cast<long long>(B) * Hq * Sq == 0) return 0;
  if (Sq % kB != 0 || Sk % kB != 0 || Hkv <= 0 || Hq % Hkv != 0 || scratch == nullptr ||
      (D != 64 && D != 96 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  const int rc = is_bf16 ? launch_delta<bf16>(out, dout, scratch, rows, D, stream)
                         : launch_delta<float>(out, dout, scratch, rows, D, stream);
  if (rc != 0) return rc;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, dout, lse, scratch, dq, dk, dv, B, Hq, Hkv, Sq, Sk, is_bf16,
                        causal, scale, stream);
    case 96:
      return launch<96>(q, k, v, dout, lse, scratch, dq, dk, dv, B, Hq, Hkv, Sq, Sk, is_bf16,
                        causal, scale, stream);
    default:
      return launch<128>(q, k, v, dout, lse, scratch, dq, dk, dv, B, Hq, Hkv, Sq, Sk,
                         is_bf16, causal, scale, stream);
  }
}
