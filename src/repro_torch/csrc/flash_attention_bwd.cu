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
// Three kernels, deterministic, no atomics:
//   1. delta: one warp a row, f32.
//   2. dK and dV: one block a (b, kv head, 64-key tile).  It walks the G
//      q heads of its group and every 64-row q tile that sees the key
//      tile (causal: from the diagonal on), recomputes S and P from lse,
//      and sums dV and dK in registers: the group's sum is taken inside
//      the block, and each is written once.
//   3. dQ: one block a (b, q head, 64-row q tile), heaviest first; it
//      walks the key tiles that q tile sees and sums dQ in registers.
// So S and dP are computed twice (in 2 and in 3): 14 D flops a visible
// (query, key) pair against the 10 D the gradient needs.
//
// Bound: 10 D flops a visible pair, against the 989 TFLOP/s bf16
// tensor-core rate (67 TFLOP/s f32) of an H100 SXM at 700 W (data
// sheet); the bytes (q, k, v, o, do read once, dq, dk, dv written once)
// are far below that.
//
// * bf16 runs the products on the tensor cores, mma.sync m16n8k16 with
//   f32 sums, 4 warps a block, each warp 16 rows of the block's tile (16
//   keys of dK and dV, or 16 q rows of dQ), the other side walked 32 at
//   a time.  Tiles sit in shared memory as bf16, rows padded by 8 values
//   so that ldmatrix reads them without bank conflicts; S and dP come
//   out in the accumulator layout, which is the A layout of the next
//   product, so P and dS never leave registers.  P and dS are split
//   into two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), and both
//   go through the tensor cores (as the forward does with p): about 16
//   bits of each, so the gradients stay within one bf16 ulp of the f32
//   plain version.  That is 14 D tensor flops a pair in dK/dV and 10 D in
//   dQ.
// * f32 stays on the CUDA cores as fp32 FMAs, as the f32 forward does
//   (TF32 would not hold 1e-4): 256 threads, 4 x 4 register tiles of S
//   and dP (rows 16 apart, keys 16 apart, float4 along d), 4 x D/16
//   register tiles of the products into dK, dV and dQ (float4 or float2
//   along d), rows padded by 4 floats against bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---- bf16 on the tensor cores: mma.sync m16n8k16, f32 sums ---------

typedef __nv_bfloat16 bf16;
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows of the block's tile each
constexpr int kSub = 32;          // q rows (dK, dV) or keys (dQ) a step of a warp

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;       // bf16 row stride: 16-byte rows, 4 banks apart
  static constexpr int kTile = kB * kLd;  // bf16 of a (64, D) tile
  static constexpr int kNT = D / 8;       // n-tiles of 8 along d
  static constexpr int kSmem = static_cast<int>(sizeof(bf16)) * 4 * kTile +
                               static_cast<int>(sizeof(float)) * 2 * kB;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += A B, A 16x16 (a[0..3]: rows g and g+8 by columns 2t.. and 2t+8..),
// B 16x8 (b0: rows 2t.. column g; b1: rows 2t+8..), g = lane / 4, t =
// lane % 4; d: rows g and g+8 by columns 2t, 2t+1
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x ~ hi + lo for two values, each term bf16, packed as bf16x2 (the
// first value in the low half)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// `rows` rows of D bf16 from g (row-major, contiguous) into s with row
// stride MmaTile<D>::kLd, 16 bytes a copy
template <int D>
__device__ __forceinline__ void load_bf16_tile(bf16* s, const bf16* __restrict__ g, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < kB * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    *reinterpret_cast<uint4*>(s + r * MmaTile<D>::kLd + 8 * c) =
        *reinterpret_cast<const uint4*>(g + 8 * i);
  }
}

// acc[j] = rows a0 .. a0+15 of tile a times rows b0 + 8 j .. b0 + 8 j + 7
// of tile b, transposed, over D (both (64, D) tiles): a 16 x 32 block of
// A B^T in the accumulator layout
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[kSub / 8][4], const bf16* a, int a0,
                                        const bf16* b, int b0, int lane) {
  constexpr int kLd = MmaTile<D>::kLd;
#pragma unroll
  for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (a0 + (lane & 15)) * kLd + 16 * kk + 8 * (lane >> 4));
#pragma unroll
    for (int j = 0; j < kSub / 8; j += 2) {
      uint32_t bf[4];  // n-tiles j and j+1, each its k halves
      ldsm_x4(bf, b + (b0 + 8 * j + 8 * (lane >> 4) + (lane & 7)) * kLd + 16 * kk +
                      8 * ((lane >> 3) & 1));
      mma(acc[j], af, bf[0], bf[1]);
      mma(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += A (16 x 32: two k chunks, as hi and lo terms) times
// rows m0 .. m0+31 of tile m (a (64, D) tile, read transposed)
template <int D>
__device__ __forceinline__ void mma_an(float (&acc)[MmaTile<D>::kNT][4],
                                       const uint32_t (&hi)[kSub / 16][4],
                                       const uint32_t (&lo)[kSub / 16][4], const bf16* m,
                                       int m0, int lane) {
  constexpr int kLd = MmaTile<D>::kLd;
#pragma unroll
  for (int kc = 0; kc < kSub / 16; ++kc) {
#pragma unroll
    for (int j = 0; j < MmaTile<D>::kNT; j += 2) {
      uint32_t bf[4];  // k halves of n-tile j, then of n-tile j+1
      ldsm_x4_t(bf, m + (m0 + 16 * kc + 8 * ((lane >> 3) & 1) + (lane & 7)) * kLd + 8 * j +
                        8 * (lane >> 4));
      mma(acc[j], hi[kc], bf[0], bf[1]);
      mma(acc[j], lo[kc], bf[0], bf[1]);
      mma(acc[j + 1], hi[kc], bf[2], bf[3]);
      mma(acc[j + 1], lo[kc], bf[2], bf[3]);
    }
  }
}

// the accumulator layout of a 16 x 32 block as the A fragments of its
// two 16 x 16 k chunks, each value split into hi and lo terms
__device__ __forceinline__ void to_a(const float (&c)[kSub / 8][4],
                                     uint32_t (&hi)[kSub / 16][4],
                                     uint32_t (&lo)[kSub / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < kSub / 16; ++kc) {
    split_bf16(c[2 * kc][0], c[2 * kc][1], hi[kc][0], lo[kc][0]);
    split_bf16(c[2 * kc][2], c[2 * kc][3], hi[kc][1], lo[kc][1]);
    split_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1], hi[kc][2], lo[kc][2]);
    split_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3], hi[kc][3], lo[kc][3]);
  }
}

// rows r0 + g and r0 + g + 8 of a (rows, D) bf16 tensor <- acc * scale
template <int D>
__device__ __forceinline__ void write_mma_rows(bf16* __restrict__ out,
                                               const float (&acc)[MmaTile<D>::kNT][4],
                                               float scale, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < MmaTile<D>::kNT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(r0 + g + 8 * h) * D +
                                         8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
}

// bf16: dK and dV of one (b, kv head, key tile); warp w owns keys 16 w ..
// 16 w + 15 and walks the q rows 32 at a time: S^T and dP^T (its keys by
// the q rows), then dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) attention_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int n_bkv, int Hq, int group, int Sq, int Sk, float scale, int causal) {
  typedef MmaTile<D> M;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + M::kTile;
  bf16* qs = vs + M::kTile;
  bf16* dos = qs + M::kTile;
  float* lse_s = reinterpret_cast<float*>(dos + M::kTile);
  float* delta_s = lse_s + kB;

  const int kt = static_cast<int>(blockIdx.x) / n_bkv;  // earliest keys (most q tiles) first
  const int bkv = static_cast<int>(blockIdx.x) % n_bkv;
  const int Hkv = Hq / group;
  const int b = bkv / Hkv, kvh = bkv - b * Hkv;
  const int k0 = kt * kB;
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const long long kv_off = (static_cast<long long>(bkv) * Sk + k0) * D;

  load_bf16_tile<D>(ks, k + kv_off, tid);
  load_bf16_tile<D>(vs, v + kv_off, tid);

  float acc_k[M::kNT][4], acc_v[M::kNT][4];
#pragma unroll
  for (int j = 0; j < M::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0 and key0 + 8
  const int first = causal ? max(0, k0 - q_offset) / kB : 0;
  for (int gi = 0; gi < group; ++gi) {
    const long long bh = static_cast<long long>(b) * Hq + kvh * group + gi;
    for (int qt = first; qt < Sq / kB; ++qt) {
      const int q0 = qt * kB;
      const long long q_off = (bh * Sq + q0) * D;
      __syncthreads();  // the last iteration's reads of qs, dos, lse_s, delta_s done
      load_bf16_tile<D>(qs, q + q_off, tid);
      load_bf16_tile<D>(dos, dout + q_off, tid);
      if (tid < kB) {
        lse_s[tid] = lse[bh * Sq + q0 + tid];
        delta_s[tid] = delta[bh * Sq + q0 + tid];
      }
      __syncthreads();
#pragma unroll 1
      for (int r0 = 0; r0 < kB; r0 += kSub) {
        // every row of the step sees none of the warp's keys
        if (causal && k0 + 16 * warp > q0 + r0 + kSub - 1 + q_offset) continue;
        float s[kSub / 8][4], dp[kSub / 8][4];
        mma_abt<D>(s, ks, 16 * warp, qs, r0, lane);   // S^T
        mma_abt<D>(dp, vs, 16 * warp, dos, r0, lane); // dP^T
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * j + 2 * t + (e & 1);  // q row within the tile
            const int key = key0 + 8 * (e >> 1);
            const bool hidden = causal && key > q0 + r + q_offset;
            const float p = hidden ? 0.f : expf(fmaf(s[j][e], scale, -lse_s[r]));
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - delta_s[r]);
          }
        uint32_t hi[kSub / 16][4], lo[kSub / 16][4];
        to_a(s, hi, lo);
        mma_an<D>(acc_v, hi, lo, dos, r0, lane);  // dV += P^T dO
        to_a(dp, hi, lo);
        mma_an<D>(acc_k, hi, lo, qs, r0, lane);   // dK += dS^T Q
      }
    }
  }
  write_mma_rows<D>(dk + kv_off, acc_k, scale, 16 * warp, lane);
  write_mma_rows<D>(dv + kv_off, acc_v, 1.f, 16 * warp, lane);
}

// bf16: dQ of one (b, q head, q tile); warp w owns q rows 16 w .. 16 w +
// 15 and walks the keys 32 at a time: S and dP, then dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) attention_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int n_bh, int Hq, int group,
    int Sq, int Sk, float scale, int causal) {
  typedef MmaTile<D> M;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + M::kTile;
  bf16* ks = dos + M::kTile;
  bf16* vs = ks + M::kTile;
  float* lse_s = reinterpret_cast<float*>(vs + M::kTile);
  float* delta_s = lse_s + kB;

  const int nq = Sq / kB;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / n_bh;  // heaviest first
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_row = static_cast<long long>(b) * (Hq / group) + h / group;
  const int q0 = qt * kB;
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const long long q_off = (static_cast<long long>(bh) * Sq + q0) * D;

  load_bf16_tile<D>(qs, q + q_off, tid);
  load_bf16_tile<D>(dos, dout + q_off, tid);
  if (tid < kB) {
    lse_s[tid] = lse[static_cast<long long>(bh) * Sq + q0 + tid];
    delta_s[tid] = delta[static_cast<long long>(bh) * Sq + q0 + tid];
  }
  float acc[M::kNT][4];
#pragma unroll
  for (int j = 0; j < M::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int row0 = 16 * warp + g;  // this thread's q rows in the tile: row0 and row0 + 8
  int n_tiles = Sk / kB;
  if (causal) n_tiles = min(n_tiles, (q0 + kB - 1 + q_offset) / kB + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kB;
    const long long kv_off = (kv_row * Sk + k0) * D;
    __syncthreads();  // the last iteration's reads of ks, vs done
    load_bf16_tile<D>(ks, k + kv_off, tid);
    load_bf16_tile<D>(vs, v + kv_off, tid);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kB; c0 += kSub) {
      // every key of the step is past the warp's last row
      if (causal && k0 + c0 > q0 + 16 * warp + 15 + q_offset) continue;
      float s[kSub / 8][4], dp[kSub / 8][4];
      mma_abt<D>(s, qs, 16 * warp, ks, c0, lane);
      mma_abt<D>(dp, dos, 16 * warp, vs, c0, lane);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + 8 * (e >> 1);
          const int key = k0 + c0 + 8 * j + 2 * t + (e & 1);
          const bool hidden = causal && key > q0 + r + q_offset;
          const float p = hidden ? 0.f : expf(fmaf(s[j][e], scale, -lse_s[r]));
          dp[j][e] = p * (dp[j][e] - delta_s[r]);
        }
      uint32_t hi[kSub / 16][4], lo[kSub / 16][4];
      to_a(dp, hi, lo);
      mma_an<D>(acc, hi, lo, ks, c0, lane);  // dQ += dS K
    }
  }
  write_mma_rows<D>(dq + q_off, acc, scale, 16 * warp, lane);
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
  constexpr int smem = MmaTile<D>::kSmem;
  auto dkdv = attention_dkdv_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bkv = B * Hkv;
  dkdv<<<static_cast<unsigned>(n_bkv) * (Sk / kB), kMmaThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, n_bkv, Hq, Hq / Hkv, Sq, Sk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dqk = attention_dq_mma_kernel<D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = B * Hq;
  dqk<<<static_cast<unsigned>(n_bh) * (Sq / kB), kMmaThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, n_bh, Hq, Hq / Hkv, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV and dQ of one type at head dim D
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
           int Sk, int is_bf16, int causal, float scale, cudaStream_t stream) {
  if (is_bf16) {
    return launch_bf16<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
                          delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                          static_cast<bf16*>(dv), B, Hq, Hkv, Sq, Sk, causal, scale, stream);
  }
  return launch_f32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(dout), lse,
                       delta, static_cast<float*>(dq), static_cast<float*>(dk),
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
