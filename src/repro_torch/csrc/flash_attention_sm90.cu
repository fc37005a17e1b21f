// Streaming-softmax (flash) attention for bf16 on Hopper's tensor
// cores, forward only, causal or not, with grouped KV heads (GQA):
//
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h/G, j] * scale) v[b, h/G, j]
//
// where a causal row i sees keys j <= i + (Sk - Sq) and G = Hq / Hkv.
//
// Replaces, for bf16, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py (flash_attention ->
// _attn_kernel); f32 stays on the CUDA-core kernel in
// flash_attention.cu.  The TPU kernel walks a grid (B*Hq, Sq/128,
// Sk/128) in order and carries m, l and acc in VMEM scratch across the
// sequential k axis.  Here one block owns one (b*Hq + h, 128-row q
// tile) and a loop over 128-key tiles inside the block takes the place
// of that axis; m, l and acc live in registers.  Blocks run heaviest
// q tiles first (causal rows late in the sequence see the most keys).
// The kv row is b*Hkv + h/G, so no K/V head is replicated (the TPU's
// kv_map), and key tiles wholly above the causal diagonal are never
// loaded (the TPU kernel's pl.when(run)).
//
// Bound: at bf16 the work is compute-bound, 4*D flops per visible
// (query, key) pair against 2 bytes per element moved once: the
// 989 TFLOP/s bf16 tensor cores of an H100 SXM at its 700 W limit
// (data sheet).  So both products run on wgmma:
//
// * Warp specialization: 3 warpgroups.  Warpgroups 0 and 1 consume,
//   64 q rows each; one thread of warpgroup 2 produces, issuing TMA
//   loads (cp.async.bulk.tensor) of the Q tile once and of K and V
//   tiles into a ring of kStages stages guarded by full/empty
//   mbarriers, so the next tile's copy overlaps this tile's products.
//   setmaxnreg moves registers from the producer to the consumers.
// * Tiles land in shared memory in TMA's 128-byte swizzle, as 64-column
//   (128-byte) chunks of 128 rows: D 128 is two chunks, D 64 one, and
//   D 96 two whose last 32 columns TMA fills with zeros (out of the
//   tensor's bounds).  The wgmma descriptors read the same swizzle.
// * S = Q K^T: wgmma m64n128k16, A and B from shared memory, both
//   K-major as they stand (d contiguous).  D/16 steps; the zero columns
//   of D 96 are never read.
// * Online softmax in f32 as the TPU kernel does it (m, l, alpha), in
//   the base-2 domain (scale * log2 e folded into one multiply); masked
//   entries take -1e30, only on tiles that cross the diagonal.  l sums
//   the f32 p.
// * O += P V with P kept in registers (the accumulator layout of S is
//   the register-A layout of the next product) and V read MN-major
//   through wgmma's transpose bit.  P is split into two bf16 terms,
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both go through the
//   tensor cores: p to about 16 bits, so the result stays within one
//   bf16 ulp of the f32 reference (bf16 p alone reaches about 1.04x
//   that bound on long causal rows).  That is 1.5x the tensor work of a
//   single bf16 P V.
// * The output is acc / max(l, 1e-30), rounded once to bf16 (D 96:
//   the padded columns are dropped).
// * Given a non-null lse, each row's log-sum-exp goes there too, f32
//   (B, Hq, Sq), in natural log as the backward reads it: m is kept in
//   the base-2 domain (scale * log2 e folded in), so lse = (m + log2 l)
//   * ln 2.  A null lse leaves the rest unchanged.
//
// The tensor maps are built on the host for every call and passed as
// __grid_constant__ parameters.  The PTX primitives and tile_map are
// sm90.cuh's, shared with the backward (flash_attention_bwd.cu).
#include "sm90.cuh"

namespace {

constexpr int kBQ = 128;          // q rows a block, 64 a consumer warpgroup
constexpr int kBK = 128;          // keys a K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kChunkBytes = kBK * 128;  // one 64-column chunk of a 128-row tile
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
static_assert(kBQ == kBK, "Q and K/V tiles share one tensor-map box");

template <int D>
struct Tiles {
  static constexpr int kChunks = (D + 63) / 64;      // 64-column chunks
  static constexpr int kPad = 64 * kChunks;          // D padded to chunks
  static constexpr int kBytes = kChunks * kChunkBytes;  // a Q, K or V tile
  // barriers: q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr int kBarriers = 1 + 4 * kStages;
  static constexpr int kSmem = 1024 /* alignment slack */ +
                               kBytes * (1 + 2 * kStages) + 8 * kBarriers;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int n_bh, int Hq, int group, int Sq, int Sk, float scale_log2, int causal) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t q_s = base;                        // Q tile
  const uint32_t k_s = q_s + T::kBytes;             // K ring
  const uint32_t v_s = k_s + kStages * T::kBytes;   // V ring
  const uint32_t bars = v_s + kStages * T::kBytes;
  const uint32_t q_full = bars;
  const auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  const auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  const auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  const auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  // heaviest q tiles first: block i takes tile nq-1 - i/n_bh of head i%n_bh
  const int nq = Sq / kBQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;  // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const int kv_row = b * (Hq / group) + h / group;
  const int q0 = qt * kBQ;
  const int q_offset = Sk - Sq;
  int n_tiles = Sk / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1 + q_offset) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the TMA ring full ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      const int q_row = bh * Sq + q0;
      const int kv_base = kv_row * Sk;
      mbar_expect_tx(q_full, T::kBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(q_s + c * kChunkBytes, &tq, 64 * c, q_row, q_full);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, phase = (t / kStages) & 1;
        const uint32_t ks = k_s + s * T::kBytes, vs = v_s + s * T::kBytes;
        mbar_wait(k_empty(s), phase ^ 1);
        mbar_expect_tx(k_full(s), T::kBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(ks + c * kChunkBytes, &tk, 64 * c, kv_base + t * kBK, k_full(s));
        }
        mbar_wait(v_empty(s), phase ^ 1);
        mbar_expect_tx(v_full(s), T::kBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(vs + c * kChunkBytes, &tv, 64 * c, kv_base + t * kBK, v_full(s));
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // accumulator layout of wgmma m64nN: this thread holds rows
    // r0 = 16*warp + lane/4 and r0 + 8 of the warpgroup's 64, and in
    // every 8-column block j the columns 8j + 2*(lane%4) + {0, 1}:
    // d[4j + 0..1] on row r0, d[4j + 2..3] on row r0 + 8
    const int r0 = 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int row0 = q0 + 64 * wg + r0;  // absolute q row of d[4j + 0..1]
    float acc[T::kPad / 2];
#pragma unroll
    for (int i = 0; i < T::kPad / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's part

    const uint32_t q_wg = q_s + 64 * wg * 128;  // the warpgroup's 64 rows
    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, phase = (t / kStages) & 1;
      const uint32_t ks = k_s + s * T::kBytes, vs = v_s + s * T::kBytes;
      const int k0 = t * kBK;

      // S = Q K^T (64 x 128, f32)
      float sc[kBK / 2];
      mbar_wait(k_full(s), phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, smem_desc(q_wg + off, 16, 1024),
                      smem_desc(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(sc);
      if (lane == 0) mbar_arrive(k_empty(s));

      // online softmax in the base-2 domain
      const bool mask = causal && k0 + kBK - 1 > q0 + 64 * wg + q_offset;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (mask) {
          const int key = k0 + 8 * (i / 4) + c0 + (i & 1);
          if (key > row0 + ((i & 2) ? 8 : 0) + q_offset) x = kNegInf;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] - m[r]);
        l[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < T::kPad / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // P as register-A fragments of m64n*k16, one per 16 keys: a[0]
      // rows r0 keys 16kk + c0.., a[1] rows r0+8, a[2]/a[3] keys + 8
      uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], p_hi[kk][e],
                     p_lo[kk][e]);
        }
      }

      // O += P_hi V + P_lo V
      mbar_wait(v_full(s), phase);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = smem_desc(vs + kk * 16 * 128, kChunkBytes, 1024);
        if constexpr (T::kPad == 128) {
          wgmma_rs_n128(acc, p_hi[kk], dv);
          wgmma_rs_n128(acc, p_lo[kk], dv);
        } else {
          wgmma_rs_n64(acc, p_hi[kk], dv);
          wgmma_rs_n64(acc, p_lo[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(v_empty(s));
    }

    // out = acc / max(l, 1e-30), once rounded to bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (lse != nullptr && lane % 4 == 0) {
        lse[static_cast<long long>(bh) * Sq + q0 + 64 * wg + r0 + 8 * r] =
            (m[r] + log2f(l[r])) * 0.6931471805599453f;
      }
      l[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* out = o + (static_cast<long long>(bh) * Sq + q0 + 64 * wg + r0) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<__nv_bfloat162*>(out + (8 * r) * D + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / l[r],
                                  acc[4 * j + 2 * r + 1] / l[r]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, static_cast<long long>(B) * Hq * Sq, D, kBQ) ||
      !tile_map(&tk, k, static_cast<long long>(B) * Hkv * Sk, D, kBK) ||
      !tile_map(&tv, v, static_cast<long long>(B) * Hkv * Sk, D, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = Tiles<D>::kSmem;
  auto kernel = flash_attention_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = B * Hq;
  const long long blocks = static_cast<long long>(n_bh) * (Sq / kBQ);
  const float log2e = 1.4426950408889634f;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, n_bh, Hq, Hq / Hkv, Sq, Sk,
      scale * log2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o like q; all contiguous.
// Called by flash_attention_launch (flash_attention.cu), which holds
// the contract: D in {64, 96, 128}, Sq and Sk multiples of 128,
// Hq % Hkv == 0 and, when causal, Sq <= Sk.
int flash_attention_bf16_sm90(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int Hq, int Hkv, int Sq,
                              int Sk, int D, int causal, float scale,
                              cudaStream_t stream) {
  if (Sq % kBQ != 0 || Sk % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, scale, stream);
    case 96:
      return launch<96>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
