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
// TFLOP/s bf16 tensor-core rate of an H100 SXM at 700 W (data sheet);
// f32 against 67 TFLOP/s on the CUDA cores, or the floor of its
// tensor-core route, 495 / 3 TFLOP/s (three TF32 products a product,
// below); the bytes (q, k, v, o, do read once, dq, dk, dv written once)
// are far below that.  Deterministic: every sum is taken in one block in
// a fixed order, no atomics.  First attention_delta_kernel (one warp a
// row, f32), then two passes a dtype.
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
// * f32 runs on the tensor cores too, in 3xTF32: TF32 keeps 10 mantissa
//   bits, about 3 decimal digits, which would not hold the plain
//   version's 1e-4 of max |grad|.  Each operand x is split once, hi =
//   tf32(x) and lo = tf32(x - hi), rounded as cvt.rna rounds (nearest,
//   ties away; two integer operations, where cvt's NaN handling costs
//   more), and a product a b is taken as lo_a hi_b + hi_a lo_b + hi_a
//   hi_b, the two small terms first, each an mma.sync.m16n8k8 TF32
//   product with f32 sums; the dropped lo_a lo_b is about 2^-22 of the
//   product, near f32's own rounding.  mma.sync and not wgmma: wgmma
//   takes TF32 B operands K-major only, and dV = P^T dO, dK = dS^T Q and
//   dQ = dS K read dO, Q and K MN-major from their row-major tiles.  S =
//   Q K^T alone runs on the CUDA cores, in f32 FMAs (scores_fma): the
//   tensor cores round each product's sum toward zero, and P = exp(S
//   scale - lse) against the forward's f32 lse carried that error into
//   every gradient; a card test's one AdamW step, whose update g / (|g|
//   + eps) turns on the sign of a gradient below Adam's eps, flipped a
//   weight of wv by it.  dP in FMAs did not move that gradient, S in
//   FMAs did (scripts/attn_probe.py --precision; PERF.md).  Two passes, as bf16,
//   S and dP recomputed in each (14 D a pair, 3 TF32 terms each but S's
//   FMAs), 8 warps a block, 16 rows a warp:
//   - attention_dkdv_tf32_kernel: one block a (b, kv head, 128-key
//     tile), earliest keys first.  It holds K and V and streams the Q
//     and dO tiles of kStep rows (with their lse and delta) of the q
//     tiles that see the keys, in each the G q heads of the group; each
//     warp takes 16 keys: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK
//     += dS^T Q.
//   - attention_dq_tf32_kernel: one block a (b, q head, 128-row q tile),
//     latest rows first.  It holds Q and dO and streams the K and V
//     tiles of kStep keys its rows see; each warp takes 16 rows: S = Q
//     K^T, dP = dO V^T, dQ += dS K.
//   The m16n8 accumulator holds columns 2t and 2t+1 of each 8-column
//   block (t = lane % 4) and the k8 A fragment columns t and t+4, so the
//   next product takes k slot t as column 2t and slot t+4 as 2t+1, and
//   its B fragments read those rows: P and dS go from the accumulators
//   into the A fragments without leaving registers.  Streamed tiles
//   arrive by 16-byte cp.async in a ring of kTfStages stages, the next
//   step's copy running under this step's products; once landed, the
//   block splits them in one pass (hi and lo beside them, the tile kept
//   for S's FMAs), so each of
//   the 8 warps that reads them as B fragments loads hi and lo instead
//   of splitting every element again (on an H100 that took case i of
//   PERF.md from about 2.0 ms to 1.7).  The scores' fragments come by
//   ldmatrix (a 16 x 8 A fragment or two n-blocks' B fragments an
//   instruction, where plain loads take four); the held tiles' A
//   fragments are split in registers (each feeds kStep / 8 products).
//   dK, dV and dQ sum each step's part from zero on the tensor cores and
//   add it to the gradient in f32: the tensor cores drop low bits at
//   each product's sum, and over S 2048 rows in one accumulator that took
//   dK and dV 2.5e-5 of their max |value| from the plain version,
//   against 4e-6 so (PERF.md).  Rows are D + 4 floats
//   apart (4 banks), so every fragment load of a warp (8 rows x 4
//   columns, or 4 row pairs x 8 columns) touches 32 distinct banks.
//   kStep is 32 rows at D 64 and 96 and 16 at D 128: a block holds two
//   (128, D) tiles, two stages of two (kStep, D) tiles and their hi and
//   lo terms, 205,312 bytes of shared memory at D 96 and 203,008 at D
//   128 (32 rows would take 270,848, past the 232,448 a block may
//   have).  So
//   one block an SM, 8 warps: a warp holds its 16 rows' dK and dV (or
//   dQ) in registers, D/2 (D/4) floats a thread, beside S, dP, the
//   step's parts and the fragments, up to 255 registers a thread at D 96
//   and 128 with no spill, which is what bounds the rows a warp and the
//   warps an SM (16 warps would leave 128 registers a thread).
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;   // attention_delta_kernel: a warp a row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// ---- f32 on the tensor cores: 3xTF32 mma.sync fed by cp.async rings --

constexpr int kTfWarps = 8;
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int kTfTile = 16 * kTfWarps;  // keys (dK/dV) or q rows (dQ) a block
constexpr int kTfStages = 2;            // ring depth

template <int D>
struct TfTiles {
  // q rows (dK/dV) or keys (dQ) a step: 16 at D 128, where 32 would
  // take the shared memory past the card's 227 KB a block
  static constexpr int kStep = D > 96 ? 16 : 32;
  static constexpr int kNB = kStep / 8;           // 8-column blocks of S a warp
  static constexpr int kLd = D + 4;               // row stride, floats
  static constexpr int kHeld = kTfTile * kLd;     // a held (128, D) tile
  static constexpr int kStream = kStep * kLd;     // a streamed (kStep, D) tile
  // a stage: two streamed tiles, then (dK/dV) their rows' lse and delta
  static constexpr int kStage = 2 * kStream + 2 * kStep;
  // two held tiles, the ring, the hi and lo terms of the current
  // step's two streamed tiles
  static constexpr int kSmem =
      static_cast<int>(sizeof(float)) * (2 * kHeld + kTfStages * kStage + 4 * kStream);
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows of D floats from g (row-major, contiguous) into s with row
// stride D + 4, 16 bytes a cp.async.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(float* s, const float* __restrict__ g, int tid) {
  constexpr int kChunks = D / 4;
  static_assert(ROWS * kChunks % kTfThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += kTfThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    cp_async16(s + r * TfTiles<D>::kLd + 4 * c, g + 4 * i);
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest,
// ties away from zero: add half of the 13 dropped bits' unit to the
// magnitude, then drop them), in two integer operations where cvt's
// NaN and infinity handling takes four or more
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi = tf32(x) and lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ROWS rows of D floats at s (row stride D + 4), left as they are: each
// x as hi and lo at the same offset from hi and lo, a float4 a thread
// at a time.
template <int D, int ROWS>
__device__ __forceinline__ void split_rows(const float* s, float* hi, float* lo, int tid) {
  constexpr int kChunks = D / 4;
  static_assert(ROWS * kChunks % kTfThreads == 0, "whole float4s a thread");
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += kTfThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int o = r * TfTiles<D>::kLd + 4 * c;
    const float4 x = *reinterpret_cast<const float4*>(s + o);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// d += a b, one m16n8k8 TF32 product with f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of lane (g = lane / 4, t = lane % 4) in m16n8k8: A (16 x 8)
// a[0] row g col t, a[1] row g+8 col t, a[2] row g col t+4, a[3] row
// g+8 col t+4; B (8 x 8) b[0] row t col g, b[1] row t+4 col g; the
// accumulator c[0], c[1] row g cols 2t, 2t+1, c[2], c[3] row g+8.

// Four 8 x 8 matrices of 16-bit values from shared memory, each as 8
// rows of 4 floats: lane i gives the address of row i % 8 of matrix i /
// 8, and gets float lane % 4 of row lane / 4 of matrix m in r[m], which
// is where an m16n8k8 TF32 fragment wants it.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// s[j] = A B^T over D in f32 FMAs on the CUDA cores, for the 16 rows of
// A at a and the kStep rows of B at b (both row-major, stride D + 4, as
// they arrived; n-block j B's rows 8j..8j+7): S^T = K Q^T or S = Q K^T.
// The lane takes rows g and g + 8 of A against B's rows 8j + 2t and 8j
// + 2t + 1, in the accumulator's layout of scores_tf32; each sum in
// column order, four columns a load.  A quarter warp's loads touch
// distinct banks: A's rows g are 4 banks apart (a row is D + 4 floats),
// B's rows 2t 8 apart.
template <int D>
__device__ __forceinline__ void scores_fma(float (&s)[TfTiles<D>::kNB][4], const float* a,
                                           const float* b, int lane) {
  constexpr int kLd = TfTiles<D>::kLd, kNB = TfTiles<D>::kNB;
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * kLd;
  const float* a1 = a0 + 8 * kLd;
  const float* b0 = b + 2 * t * kLd;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 y = *reinterpret_cast<const float4*>(b0 + (8 * j + e) * kLd + d);
        float u = s[j][e], w = s[j][2 + e];
        u = fmaf(x0.x, y.x, u);
        w = fmaf(x1.x, y.x, w);
        u = fmaf(x0.y, y.y, u);
        w = fmaf(x1.y, y.y, w);
        u = fmaf(x0.z, y.z, u);
        w = fmaf(x1.z, y.z, w);
        s[j][e] = fmaf(x0.w, y.w, u);
        s[j][2 + e] = fmaf(x1.w, y.w, w);
      }
  }
}

// s[j] = A B^T over D in 3xTF32 for the 16 rows of A at a (row-major,
// stride D + 4, f32, split here) and the kStep rows of B (n-block j its
// rows 8j..8j+7), split already: hi at b, lo at blo.  dP^T = V dO^T or
// dP = dO V^T; kNB independent sums between dependent terms.  An A
// fragment is one ldmatrix (rows 0-7 and 8-15 at columns t, then t+4),
// a pair of n-blocks' B fragments one a term (rows 8j.. at columns t
// and t+4, then rows 8j+8..).
template <int D>
__device__ __forceinline__ void scores_tf32(float (&s)[TfTiles<D>::kNB][4], const float* a,
                                            const float* b, const float* blo, int lane) {
  constexpr int kLd = TfTiles<D>::kLd, kNB = TfTiles<D>::kNB;
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
  const float* ar = a + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 4 * (lane >> 4);
  const int bo = ((lane & 7) + 8 * (lane >> 4)) * kLd + 4 * ((lane >> 3) & 1);
  // k8 steps unrolled: all of them, but 4 at a time at D 128, where all
  // 16 at once spill registers in the dK/dV kernel
  constexpr int kUnroll = D > 96 ? 4 : D / 8;
#pragma unroll 1
  for (int k0 = 0; k0 < D / 8; k0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = k0 + u;
      uint32_t raw[4], ahi[4], alo[4], bhi[kNB / 2][4], bl[kNB / 2][4];
      ldsm_x4(raw, ar + 8 * kk);
#pragma unroll
      for (int jj = 0; jj < kNB / 2; ++jj) {
        ldsm_x4(bhi[jj], b + bo + 16 * jj * kLd + 8 * kk);
        ldsm_x4(bl[jj], blo + bo + 16 * jj * kLd + 8 * kk);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(raw[e]), ahi[e], alo[e]);
#pragma unroll
      for (int j = 0; j < kNB; ++j)
        mma_tf32(s[j], alo, bhi[j / 2][2 * (j % 2)], bhi[j / 2][2 * (j % 2) + 1]);
#pragma unroll
      for (int j = 0; j < kNB; ++j)
        mma_tf32(s[j], ahi, bl[j / 2][2 * (j % 2)], bl[j / 2][2 * (j % 2) + 1]);
#pragma unroll
      for (int j = 0; j < kNB; ++j)
        mma_tf32(s[j], ahi, bhi[j / 2][2 * (j % 2)], bhi[j / 2][2 * (j % 2) + 1]);
    }
  }
}

// acc (16 rows x D) += X B over the kStep rows of the step: X the 16 x
// kStep accumulator x (P^T, dS^T or dS) as A fragments, k slot t of its
// k8 step j its column 8j+2t and slot t+4 its column 8j+2t+1; B the
// (kStep, D) tile read at those rows (dO, Q or K), split already (hi at
// b, lo at blo), n-block n its columns 8n..8n+7.  Four n-blocks at a
// time, four independent sums, each the step's part summed from zero by
// the tensor cores and added to acc by an f32 add (the note at the top).
// The A fragments are split again for each four n-blocks: kept across
// them, they spilled registers in the dK/dV kernel at D 96.
template <int D>
__device__ __forceinline__ void product_tf32(float (&acc)[D / 8][4],
                                             const float (&x)[TfTiles<D>::kNB][4],
                                             const float* b, const float* blo, int g, int t) {
  constexpr int kLd = TfTiles<D>::kLd;
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += 4) {
    float part[4][4] = {};
#pragma unroll
    for (int j = 0; j < TfTiles<D>::kNB; ++j) {
      uint32_t ahi[4], alo[4], bhi[4][2], bl[4][2];
      split_tf32(x[j][0], ahi[0], alo[0]);  // row g, column 2t
      split_tf32(x[j][2], ahi[1], alo[1]);  // row g+8, column 2t
      split_tf32(x[j][1], ahi[2], alo[2]);  // row g, column 2t+1
      split_tf32(x[j][3], ahi[3], alo[3]);  // row g+8, column 2t+1
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (8 * j + 2 * t) * kLd + 8 * (n0 + i) + g;
        bhi[i][0] = __float_as_uint(b[o]);
        bhi[i][1] = __float_as_uint(b[o + kLd]);
        bl[i][0] = __float_as_uint(blo[o]);
        bl[i][1] = __float_as_uint(blo[o + kLd]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(part[i], alo, bhi[i][0], bhi[i][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(part[i], ahi, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(part[i], ahi, bhi[i][0], bhi[i][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n0 + i][c] += part[i][c];
  }
}

// rows g and g+8 of a (rows, D) f32 tensor at out (row g) <- acc * scale
template <int D>
__device__ __forceinline__ void write_f32_rows(float* __restrict__ out,
                                               const float (&acc)[D / 8][4], float scale,
                                               int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (8 * r) * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
}

// f32 pass 1: dK and dV of one (b, kv head, 128-key tile).  The block
// walks the q tiles of kStep rows that see its keys, first to last, and
// in each the G q heads of its group (step t: q tile first + t/G of
// head kvh*G + t%G), so dK and dV sum the group in registers.
template <int D>
__global__ void __launch_bounds__(kTfThreads, 1) attention_dkdv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int n_bkv, int Hq, int group, int Sq, int Sk, float scale, int causal) {
  using T = TfTiles<D>;
  constexpr int kStep = T::kStep, kNB = T::kNB;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // (128, D) keys of the tile
  float* vs = ks + T::kHeld;                 // (128, D) values
  float* ring = vs + T::kHeld;               // kTfStages x (Q, dO, lse, delta)
  float* hi = ring + kTfStages * T::kStage;  // the step's Q and dO hi terms
  float* lo = hi + 2 * T::kStream;           // lo terms

  const int kt = static_cast<int>(blockIdx.x) / n_bkv;  // earliest keys (most q tiles) first
  const int bkv = static_cast<int>(blockIdx.x) % n_bkv;  // b * Hkv + kv head
  const int Hkv = Hq / group;
  const int b = bkv / Hkv, kvh = bkv - b * Hkv;
  const int k0 = kt * kTfTile;
  const int q_offset = Sk - Sq;
  // causal: the first q tile with a row that sees key k0
  const int first = causal ? max(0, k0 - q_offset) / kStep : 0;
  const int n_steps = (Sq / kStep - first) * group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long kv_off = (static_cast<long long>(bkv) * Sk + k0) * D;

  const auto stage = [&](int step) {
    float* st = ring + (step % kTfStages) * T::kStage;
    const long long row = (static_cast<long long>(b) * Hq + kvh * group + step % group) * Sq +
                          (first + step / group) * kStep;
    copy_rows<D, kStep>(st, q + row * D, tid);
    copy_rows<D, kStep>(st + T::kStream, dout + row * D, tid);
    if (tid < 2 * kStep / 4)  // lse, then delta, 4 rows a copy
      cp_async16(st + 2 * T::kStream + 4 * tid, tid < kStep / 4
                                                     ? lse + row + 4 * tid
                                                     : delta + row + 4 * (tid - kStep / 4));
  };
  copy_rows<D, kTfTile>(ks, k + kv_off, tid);
  copy_rows<D, kTfTile>(vs, v + kv_off, tid);
  cp_async_commit();
#pragma unroll
  for (int p = 0; p < kTfStages - 1; ++p) {
    if (p < n_steps) stage(p);
    cp_async_commit();
  }

  const int key_lo = k0 + 16 * warp;  // the warp's first key
  const float* kw = ks + 16 * warp * T::kLd;
  const float* vw = vs + 16 * warp * T::kLd;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kTfStages - 2>();
    __syncthreads();  // this step's stage landed; the last step's stage and lo read
    if (step + kTfStages - 1 < n_steps) stage(step + kTfStages - 1);
    cp_async_commit();
    float* qs = ring + (step % kTfStages) * T::kStage;
    split_rows<D, 2 * kStep>(qs, hi, lo, tid);  // Q and dO's terms
    __syncthreads();
    const int q0 = (first + step / group) * kStep;
    // every key of the warp past every row of the tile; some past
    if (causal && key_lo > q0 + kStep - 1 + q_offset) continue;
    const bool mask = causal && key_lo + 15 > q0 + q_offset;
    const float* dos = qs + T::kStream;
    const float* lse_s = dos + T::kStream;
    const float* dl_s = lse_s + kStep;

    float s[kNB][4], dp[kNB][4];  // S^T and dP^T: 16 keys x kStep q rows
    scores_fma<D>(s, kw, qs, lane);
    scores_tf32<D>(dp, vw, hi + T::kStream, lo + T::kStream, lane);
    // P^T and dS^T, in place: key key_lo + g + 8 (c / 2), q row q0 + 8j
    // + 2t + c % 2
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1);
        float p = expf(fmaf(s[j][c], scale, -lse_s[col]));
        if (mask && key_lo + g + 8 * (c >> 1) > q0 + col + q_offset) p = 0.f;
        s[j][c] = p;
        dp[j][c] = p * (dp[j][c] - dl_s[col]);
      }
    product_tf32<D>(acc_v, s, hi + T::kStream, lo + T::kStream, g, t);  // dV += P^T dO
    product_tf32<D>(acc_k, dp, hi, lo, g, t);                           // dK += dS^T Q
  }
  cp_async_wait<0>();
  const long long out = kv_off + static_cast<long long>(16 * warp + g) * D;
  write_f32_rows<D>(dk + out, acc_k, scale, t);
  write_f32_rows<D>(dv + out, acc_v, 1.f, t);
}

// f32 pass 2: dQ of one (b, q head, 128-row q tile), heaviest (latest
// rows) first; the block walks the key tiles of kStep keys its rows see.
template <int D>
__global__ void __launch_bounds__(kTfThreads, 1) attention_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int n_bh, int Hq,
    int group, int Sq, int Sk, float scale, int causal) {
  using T = TfTiles<D>;
  constexpr int kStep = T::kStep, kNB = T::kNB;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // (128, D) q rows of the tile
  float* dos = qs + T::kHeld;                // (128, D) their dO
  float* ring = dos + T::kHeld;              // kTfStages x (K, V)
  float* hi = ring + kTfStages * T::kStage;  // the step's K and V hi terms
  float* lo = hi + 2 * T::kStream;           // lo terms

  const int nq = Sq / kTfTile;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / n_bh;  // heaviest first
  const int bh = static_cast<int>(blockIdx.x) % n_bh;            // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_row0 = (static_cast<long long>(b) * (Hq / group) + h / group) * Sk;
  const int q0 = qt * kTfTile;
  const int q_offset = Sk - Sq;
  int n_steps = Sk / kStep;
  if (causal) n_steps = min(n_steps, (q0 + kTfTile - 1 + q_offset) / kStep + 1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long q_row = static_cast<long long>(bh) * Sq + q0;

  const auto stage = [&](int step) {
    float* st = ring + (step % kTfStages) * T::kStage;
    const long long row = kv_row0 + step * kStep;
    copy_rows<D, kStep>(st, k + row * D, tid);
    copy_rows<D, kStep>(st + T::kStream, v + row * D, tid);
  };
  copy_rows<D, kTfTile>(qs, q + q_row * D, tid);
  copy_rows<D, kTfTile>(dos, dout + q_row * D, tid);
  cp_async_commit();
#pragma unroll
  for (int p = 0; p < kTfStages - 1; ++p) {
    if (p < n_steps) stage(p);
    cp_async_commit();
  }

  const int row_lo = q0 + 16 * warp;  // the warp's first q row
  const long long my_row = q_row + 16 * warp + g;
  const float lse_r[2] = {lse[my_row], lse[my_row + 8]};
  const float dl_r[2] = {delta[my_row], delta[my_row + 8]};
  const float* qw = qs + 16 * warp * T::kLd;
  const float* dow = dos + 16 * warp * T::kLd;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kTfStages - 2>();
    __syncthreads();  // this step's stage landed; the last step's stage and lo read
    if (step + kTfStages - 1 < n_steps) stage(step + kTfStages - 1);
    cp_async_commit();
    float* kst = ring + (step % kTfStages) * T::kStage;
    split_rows<D, 2 * kStep>(kst, hi, lo, tid);  // K and V's terms
    __syncthreads();
    const int k0 = step * kStep;
    // every key of the tile past every row of the warp; some past
    if (causal && k0 > row_lo + 15 + q_offset) continue;
    const bool mask = causal && k0 + kStep - 1 > row_lo + q_offset;
    const float* vst = kst + T::kStream;

    float s[kNB][4], dp[kNB][4];  // S and dP: 16 q rows x kStep keys
    scores_fma<D>(s, qw, kst, lane);
    scores_tf32<D>(dp, dow, hi + T::kStream, lo + T::kStream, lane);
    // dS in place: q row row_lo + g + 8 (c / 2), key k0 + 8j + 2t + c % 2
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = expf(fmaf(s[j][c], scale, -lse_r[c >> 1]));
        if (mask && k0 + 8 * j + 2 * t + (c & 1) > row_lo + g + 8 * (c >> 1) + q_offset)
          p = 0.f;
        dp[j][c] = p * (dp[j][c] - dl_r[c >> 1]);
      }
    product_tf32<D>(acc, dp, hi, lo, g, t);  // dQ += dS K
  }
  cp_async_wait<0>();
  write_f32_rows<D>(dq + my_row * D, acc, scale, t);
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
  if (reinterpret_cast<uintptr_t>(lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(delta) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = TfTiles<D>::kSmem;
  auto dkdv = attention_dkdv_tf32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bkv = B * Hkv;
  dkdv<<<static_cast<unsigned>(n_bkv) * (Sk / kTfTile), kTfThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, n_bkv, Hq, Hq / Hkv, Sq, Sk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dqk = attention_dq_tf32_kernel<D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = B * Hq;
  dqk<<<static_cast<unsigned>(n_bh) * (Sq / kTfTile), kTfThreads, smem, stream>>>(
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
  if (Sq % kTfTile != 0 || Sk % kTfTile != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      scratch == nullptr || (D != 64 && D != 96 && D != 128)) {
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
