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
// no order, so here one block owns one (b*Hq + h, 64-row q tile) and a
// loop over 64-key tiles inside the block takes the place of that
// axis; m, l and acc live in registers.  K/V tiles go through shared
// memory, read once per q tile; the kv row is b*Hkv + h/G, so no K/V
// head is replicated (the TPU's kv_map).  Key tiles wholly above the
// causal diagonal are never visited (the TPU kernel's pl.when(run)).
// Heavier q tiles (later rows, more key tiles) are scheduled first.
//
// Arithmetic is the TPU kernel's, all in fp32: s = (q.k)*scale, masked
// entries take -1e30, p stays fp32 for p.v, and the output is
// acc / max(l, 1e-30).  The products run as fp32 FMAs on the CUDA
// cores: the f32 path is held to 2e-5 of the f32 reference, which TF32
// tensor cores would not meet.  Bound: 4*D flops per visible
// (query, key) pair at the 67 TFLOP/s fp32 rate of an H100 SXM (data
// sheet, 700 W).
//
// Thread layout (256 threads, 8 warps): thread t owns q rows
// 4*(t/16) .. +3 of the tile.  For the 64x64 score tile it holds the
// columns t%16 + 16*j (j < 4); for the 64xD accumulator the columns
// t%16 + 16*j (j < D/16).  A row's 16 threads are one half-warp, so
// row max and row sum reduce with four shuffles.  Shared rows are
// padded so that every shared-memory read in the inner loops is free
// of bank conflicts (or a broadcast).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr int kGroup = 16;     // threads that share a row group
constexpr int kRows = kBQ * kGroup / kThreads;  // 4 q rows per thread
constexpr int kCols = kBK / kGroup;             // 4 score columns per thread
constexpr int kPStride = kBK + 4;  // rows 4 apart land 16 banks apart
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

template <int D>
constexpr size_t smem_bytes() {
  // q and k tiles padded to D+1 floats a row, v tile D, p tile kPStride
  return sizeof(float) *
         (static_cast<size_t>(kBQ + kBK) * (D + 1) + kBK * D + kBQ * kPStride);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Hq, int group,
    int Sq, int Sk, float scale, int causal) {
  constexpr int kDC = D / kGroup;  // accumulator columns per thread
  constexpr int kQK = D + 1;       // padded row of the q and k tiles
  extern __shared__ float smem[];
  float* qs = smem;               // kBQ x kQK
  float* ks = qs + kBQ * kQK;     // kBK x kQK
  float* vs = ks + kBK * kQK;     // kBK x D
  float* ps = vs + kBK * D;       // kBQ x kPStride

  const int nq = Sq / kBQ;
  const int bh = blockIdx.x / nq;                 // b * Hq + h
  const int qt = nq - 1 - (blockIdx.x - bh * nq);  // heaviest tiles first
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_row = static_cast<long long>(b) * (Hq / group) + h / group;
  const int q0 = qt * kBQ;
  const int q_offset = Sk - Sq;
  const float* qg = q + (static_cast<long long>(bh) * Sq + q0) * D;
  const float* kg = k + kv_row * Sk * D;
  const float* vg = v + kv_row * Sk * D;
  float* og = o + (static_cast<long long>(bh) * Sq + q0) * D;

  const int tid = threadIdx.x;
  const int rg = tid / kGroup, cg = tid % kGroup;
  const int r0 = rg * kRows;  // first q row of this thread in the tile

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    qs[r * kQK + (i - r * D)] = qg[i];
  }

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = Sk / kBK;
  if (causal) {  // last key the tile's last row can see, over kBK
    n_tiles = min(n_tiles, (q0 + kBQ - 1 + q_offset) / kBK + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // q tile written; last tile's k, v, p reads done
    const long long base = static_cast<long long>(k0) * D;
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      ks[r * kQK + (i - r * D)] = kg[base + i];
      vs[i] = vg[base + i];
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(r0 + i) * kQK + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(cg + kGroup * j) * kQK + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + r0 + i + q_offset;  // absolute query position
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * scale;
        if (causal && row < k0 + cg + kGroup * j) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        ps[(r0 + i) * kPStride + cg + kGroup * j] = s[i][j];
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[kDC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(r0 + i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) vv[j] = vs[c * D + cg + kGroup * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDC; ++j) {
      og[static_cast<long long>(r0 + i) * D + cg + kGroup * j] = acc[i][j] / li;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * Hq * (Sq / kBQ);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hq / Hkv, Sq,
      Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flash_attention_sm90.cu
int flash_attention_bf16_sm90(const void* q, const void* k, const void* v,
                              void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                              int D, int causal, float scale,
                              cudaStream_t stream);

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o like q; all contiguous, of
// one type (bf16 when is_bf16, else f32).  The caller guarantees
// D in {64, 96, 128}, Sq and Sk multiples of 128, Hq % Hkv == 0 and,
// when causal, Sq <= Sk.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, int is_bf16, int causal, float scale,
    cudaStream_t stream) {
  if (static_cast<long long>(B) * Hq * Sq == 0) return 0;
  if (is_bf16) {
    return flash_attention_bf16_sm90(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                     scale, stream);
  }
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, scale, stream);
    case 96:
      return launch<96>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
