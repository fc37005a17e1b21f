// Streaming-softmax (flash) attention for f32 on the CUDA cores,
// forward only, causal or not, with grouped KV heads (GQA):
//
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h/G, j] * scale) v[b, h/G, j]
//
// where a causal row i sees keys j <= i + (Sk - Sq) and G = Hq / Hkv.
// flash_attention_launch below is the library's one entry point for
// attention: it sends bf16 to the tensor-core kernel in
// flash_attention_sm90.cu (wgmma, TMA) and f32 to this one.
//
// Replaces, for f32, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py (flash_attention ->
// _attn_kernel).  The TPU kernel walks a grid (B*Hq, Sq/128, Sk/128)
// in order, carrying the running max m, sum l and accumulator acc in
// VMEM scratch across the sequential k axis.  Hopper's blocks run in
// no order, so here a block owns one (b*Hq + h, 128-row q tile) and a
// loop over 64-key tiles inside the block takes the place of that
// axis; m, l and acc live in registers.  The kv row is b*Hkv + h/G, so
// no K/V head is replicated (the TPU's kv_map).  Key tiles wholly above
// the causal diagonal are never visited (the TPU kernel's pl.when(run)).
// Heavier q tiles (later rows, more key tiles) are scheduled first.
//
// Arithmetic is the TPU kernel's, all in fp32: s = (q.k)*scale, masked
// entries take -1e30, p stays fp32 for p.v, and the output is
// acc / max(l, 1e-30).  The products run as fp32 FMAs on the CUDA
// cores: the f32 path is held to 2e-5 of the f32 reference, which TF32
// tensor cores would not meet.  Bound: 4*D flops per visible
// (query, key) pair at the 67 TFLOP/s fp32 rate of an H100 SXM (data
// sheet, 700 W): 128 FFMA a clock an SM, so the inner loops are built
// to issue FFMAs, not shared-memory loads.
//
// * Register tiles.  512 threads, 16 warps; a warp owns 8 q rows, a
//   half warp 4 of them.  For the 128x64 score tile a thread holds its
//   4 rows x 4 adjacent keys (16 key groups, a half warp a row group);
//   for the 128xD accumulator its 4 rows x D/16 columns as float4 or
//   float2 vectors.  Row max and row sum reduce over a half warp by
//   shuffles.
// * Q and K sit in shared memory row-major with their 16-byte chunks
//   swizzled by (row / 4) % 8, so that per 4 d a thread's q rows are
//   four LDS.128 a half warp shares (broadcast) and its keys four
//   LDS.128 in two wavefronts: 8 LDS.128 a 64 FFMA.  P goes to a
//   warp's own slice of shared memory, transposed (key-major, the
//   4 rows of a half warp as one float4, chunks swizzled against bank
//   conflicts), so P.V reads one LDS.128 of p and D/64 .. D/32 vectors
//   of the V row per 4*D/16 FFMA.  P needs only __syncwarp.
// * K/V ring.  K and V tiles arrive by 16-byte cp.async.cg in a ring
//   of two stages: the copy of tile t+1 runs under the math of tile t.
//   Shared memory at D 128: Q 64 KB, K and V 2 x 2 x 32 KB, P 32 KB,
//   224 KB for one block of 16 warps an SM.
// * Split keys.  Where B*Hq*Sq/128 blocks leave the card short, the
//   caller's n_split (kernels/flash_attention/kernel.py::split_plan)
//   cuts the key tiles each (head, q tile) visits into n_split
//   contiguous chunks, a block each.  A block then writes its m, l and
//   unnormalized acc to the caller's scratch, and flash_merge_kernel
//   folds the chunks in order: m* = max m_i, l = sum l_i e^(m_i - m*),
//   o = sum acc_i e^(m_i - m*) / max(l, 1e-30).
// * Row log-sum-exp.  Given a non-null lse, the kernel (or, split, the
//   merge) also writes each row's lse = m + log(l) in natural log, f32
//   (B, Hq, Sq), which the backward (flash_attention_bwd.cu) reads to
//   recompute p; a null lse leaves the rest unchanged.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 128;        // q rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 512;   // 16 warps
constexpr int kGroup = 16;      // lanes that share a row group: a half warp
constexpr int kTM = 4;          // q rows a thread owns
constexpr int kTN = kBK / kGroup;  // 4 adjacent keys a thread owns
constexpr int kPWarp = 2 * kTM * kBK;  // P floats of a warp: 8 rows x 64 keys
constexpr int kStages = 2;
constexpr int kMergeRows = 8;   // rows of a merge block, a warp each
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

static_assert(kThreads / 32 * 2 * kTM == kBQ, "a warp owns 8 q rows");

// The accumulator columns of a thread: kNV vectors of kVW floats, the
// vector c of its key group g at column (g + 16 c) * kVW.
template <int D>
struct Cols {
  static constexpr int kNC = D / kGroup;             // 4, 6 or 8
  static constexpr int kVW = kNC % 4 == 0 ? 4 : 2;
  static constexpr int kNV = kNC / kVW;
};

template <int VW> struct Vec;
template <> struct Vec<4> { typedef float4 T; };
template <> struct Vec<2> { typedef float2 T; };

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * D +
                          2 * kStages * kBK * D + (kThreads / 32) * kPWarp);
}

// Key tiles a q tile visits: all, or up to the one holding the last
// key its last row sees (kernels/flash_attention/kernel.py::key_tiles).
__device__ __forceinline__ int key_tiles(int q0, int Sk, int q_offset, int causal) {
  const int n = Sk / kBK;
  return causal ? min(n, (q0 + kBQ - 1 + q_offset) / kBK + 1) : n;
}

// 16-byte chunk c of a swizzled Q or K row: rows 4 apart land in
// different banks.
__device__ __forceinline__ int swz(int row, int c) { return c ^ ((row >> 2) & 7); }

// P of a warp, key-major: key j's line holds the 4 rows of both half
// warps for keys j & ~3 .. +3, its float4 slots swizzled by j / 4.
__device__ __forceinline__ int p_index(int j, int half) {
  return (j >> 2) * 32 + (((((j & 3) << 1) | half) ^ ((j >> 2) & 7)) << 2);
}

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

// ROWS x D floats from g (row-major) into s, 16 bytes a copy.
template <int D, int ROWS, bool kSwizzle>
__device__ __forceinline__ void copy_tile(float* s, const float* __restrict__ g, int tid) {
  constexpr int kChunks = D / 4;
  static_assert(ROWS * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i / kChunks, c = i - r * kChunks;
    cp_async16(s + r * D + ((kSwizzle ? swz(r, c) : c) << 2), g + 4 * i);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ part, int BH, int Hq, int group, int Sq, int Sk, float scale, int causal,
    int n_split) {
  typedef Cols<D> C;
  typedef typename Vec<C::kVW>::T V;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // kBQ x D, swizzled
  float* ks = qs + kBQ * D;            // kStages x kBK x D, swizzled
  float* vs = ks + kStages * kBK * D;  // kStages x kBK x D
  float* ps = vs + kStages * kBK * D;  // kPWarp a warp

  const int nq = Sq / kBQ;
  const int chunk = blockIdx.x % n_split;
  const int rest = blockIdx.x / n_split;
  const int qt = nq - 1 - rest / BH;  // heaviest q tiles first, every head
  const int bh = rest % BH;           // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_row = static_cast<long long>(b) * (Hq / group) + h / group;
  const int q0 = qt * kBQ;
  const int q_offset = Sk - Sq;
  const int n_tiles = key_tiles(q0, Sk, q_offset, causal);
  const int t_lo = chunk * n_tiles / n_split;
  const int t_hi = (chunk + 1) * n_tiles / n_split;
  const float* qg = q + (static_cast<long long>(bh) * Sq + q0) * D;
  const float* kg = k + kv_row * Sk * D;
  const float* vg = v + kv_row * Sk * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, g = lane & (kGroup - 1);
  const int r0 = warp * 2 * kTM + half * kTM;  // first q row of the thread
  const int qx = (r0 >> 2) & 7;                // swizzle of its q rows
  const int kx = g & 7;                        // swizzle of its keys g*4 .. +3
  float* pw = ps + warp * kPWarp;

  if (t_lo < t_hi) {
    copy_tile<D, kBQ, true>(qs, qg, tid);
    copy_tile<D, kBK, true>(ks, kg + static_cast<long long>(t_lo) * kBK * D, tid);
    copy_tile<D, kBK, false>(vs, vg + static_cast<long long>(t_lo) * kBK * D, tid);
    cp_async_commit();
  }

  float m[kTM], l[kTM], acc[kTM][C::kNC];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;  // this thread's keys only; the row's sum is reduced at the end
#pragma unroll
    for (int j = 0; j < C::kNC; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile into the other stage, under this one's math
      const long long next = static_cast<long long>(t + 1) * kBK * D;
      copy_tile<D, kBK, true>(ks + (st ^ 1) * kBK * D, kg + next, tid);
      copy_tile<D, kBK, false>(vs + (st ^ 1) * kBK * D, vg + next, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) landed for every thread
    const float* kst = ks + st * kBK * D;
    const float* vst = vs + st * kBK * D;

    // ---- S = Q K^T, a thread's 4 rows x 4 keys
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
    const float* qrow = qs + r0 * D;
    const float* krow = kst + g * kTN * D;
#pragma unroll 8
    for (int c = 0; c < D / 4; ++c) {
      float4 a[kTM], bk[kTN];
      const int qc = (c ^ qx) << 2, kc = (c ^ kx) << 2;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(qrow + i * D + qc);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        bk[j] = *reinterpret_cast<const float4*>(krow + j * D + kc);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // ---- online softmax, rows reduced over the half warp
    const int k0 = t * kBK;
    const bool mask = causal && k0 + kBK - 1 > q0 + q_offset;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int last = q0 + r0 + i + q_offset;  // the row's last visible key
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        float x = s[i][j] * scale;
        if (mask && k0 + g * kTN + j > last) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::kNC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      *reinterpret_cast<float4*>(pw + p_index(g * kTN + j, half)) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncwarp();

    // ---- O += P V, a thread's 4 rows x D/16 columns
#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pw + p_index(j, half));
      const float* vrow = vst + j * D;
#pragma unroll
      for (int c = 0; c < C::kNV; ++c) {
        const V w = *reinterpret_cast<const V*>(vrow + (g + kGroup * c) * C::kVW);
#pragma unroll
        for (int e = 0; e < C::kVW; ++e) {
          const float we = (&w.x)[e];
          acc[0][c * C::kVW + e] = fmaf(p.x, we, acc[0][c * C::kVW + e]);
          acc[1][c * C::kVW + e] = fmaf(p.y, we, acc[1][c * C::kVW + e]);
          acc[2][c * C::kVW + e] = fmaf(p.z, we, acc[2][c * C::kVW + e]);
          acc[3][c * C::kVW + e] = fmaf(p.w, we, acc[3][c * C::kVW + e]);
        }
      }
    }
    __syncthreads();  // every read of this stage done before it is refilled
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(kFull, l[i], off);
  }
  if (n_split == 1) {
    float* og = o + (static_cast<long long>(bh) * Sq + q0 + r0) * D;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (lse != nullptr && g == 0) {
        lse[static_cast<long long>(bh) * Sq + q0 + r0 + i] = m[i] + logf(l[i]);
      }
      const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < C::kNV; ++c) {
        V w;
#pragma unroll
        for (int e = 0; e < C::kVW; ++e) (&w.x)[e] = acc[i][c * C::kVW + e] / li;
        *reinterpret_cast<V*>(og + i * D + (g + kGroup * c) * C::kVW) = w;
      }
    }
    return;
  }
  // a chunk's partial: m and l (n_split, BH, Sq), then acc (n_split, BH, Sq, D)
  const long long rows = static_cast<long long>(n_split) * BH * Sq;
  const long long prow = (static_cast<long long>(chunk) * BH + bh) * Sq + q0 + r0;
  float* pacc = part + 2 * rows + prow * D;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (g == 0) {
      part[prow + i] = m[i];
      part[rows + prow + i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < C::kNV; ++c) {
      V w;
#pragma unroll
      for (int e = 0; e < C::kVW; ++e) (&w.x)[e] = acc[i][c * C::kVW + e];
      *reinterpret_cast<V*>(pacc + i * D + (g + kGroup * c) * C::kVW) = w;
    }
  }
}

// Folds the n_split chunks' partials of each of `rows` = BH*Sq rows, in
// chunk order; a warp a row, a lane a float4 of its D columns.
template <int D>
__global__ void __launch_bounds__(32 * kMergeRows) flash_merge_kernel(
    const float* __restrict__ part, float* __restrict__ o, float* __restrict__ lse,
    long long rows, int n_split) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kMergeRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows || lane >= D / 4) return;
  const long long total = rows * n_split;
  const float* pm = part;
  const float* pl = part + total;
  const float* pacc = part + 2 * total;
  float m_star = kNegInf;
  for (int i = 0; i < n_split; ++i) m_star = fmaxf(m_star, pm[i * rows + row]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n_split; ++i) {
    const long long r = i * rows + row;
    const float w = expf(pm[r] - m_star);
    const float4 a = *reinterpret_cast<const float4*>(pacc + r * D + 4 * lane);
    l += pl[r] * w;
    acc.x += a.x * w;
    acc.y += a.y * w;
    acc.z += a.z * w;
    acc.w += a.w * w;
  }
  if (lse != nullptr && lane == 0) lse[row] = m_star + logf(l);
  const float li = fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(o + row * D + 4 * lane) =
      make_float4(acc.x / li, acc.y / li, acc.z / li, acc.w / li);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, float scale, int n_split,
           void* part, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long BH = static_cast<long long>(B) * Hq;
  const long long blocks = BH * (Sq / kBQ) * n_split;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse,
      static_cast<float*>(part), static_cast<int>(BH), Hq, Hq / Hkv, Sq, Sk,
      scale, causal, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const long long rows = BH * Sq;
  flash_merge_kernel<D><<<static_cast<unsigned int>((rows + kMergeRows - 1) / kMergeRows),
                          32 * kMergeRows, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(o), lse, rows, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flash_attention_sm90.cu
int flash_attention_bf16_sm90(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                              int D, int causal, float scale,
                              cudaStream_t stream);

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o like q; all contiguous, on
// 16 bytes, of one type (bf16 when is_bf16, else f32); lse null, or
// (B, Hq, Sq) f32 for each row's natural-log log-sum-exp.  The caller
// guarantees D in {64, 96, 128}, Sq and Sk multiples of 128,
// Hq % Hkv == 0 and, when causal, Sq <= Sk.  f32 only: n_split >= 1
// key chunks a (head, q tile); above 1, part holds
// n_split * B*Hq*Sq * (D + 2) floats of scratch.  bf16 takes n_split 1.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int Hq, int Hkv, int Sq, int Sk, int D, int is_bf16, int causal, float scale,
    int n_split, void* part, cudaStream_t stream) {
  if (static_cast<long long>(B) * Hq * Sq == 0) return 0;
  if (n_split < 1 || (n_split > 1 && (is_bf16 || part == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16) {
    return flash_attention_bf16_sm90(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, D, causal,
                                     scale, stream);
  }
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, scale, n_split,
                        part, stream);
    case 96:
      return launch<96>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, scale, n_split,
                        part, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, scale, n_split,
                         part, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
