// ELL SpMM, the neighbour aggregation of the GNN layers:
//
//   sum:  out[r, :] = sum_s x[col[r, s], :] * wgt[r, s]   (s = 0 .. W-1 in order)
//   max:  out[r, :] = max of x[col[r, s], :] over the s with wgt[r, s] > 0,
//                     -inf where there is none; a NaN wins, as in jnp.max
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell/kernel.py
// (spmm_ell -> _make_kernel).  There a grid step keeps a whole
// (n_x, 128) feature strip in VMEM and gathers a (block_rows, W, 128)
// tile out of it.  No such strip fits the 227 KB of shared memory a
// block has here, so the gather goes to device memory through L2.  The
// kernel is bound by bytes on this card (3.35 TB/s, H100 SXM at its
// 700 W limit, data sheet; two flops for every 4-byte element read):
// col and wgt, the gathered rows of x and the output.  So the design
// spends its effort on loads.  One warp owns one row.  Its lanes span
// the features with the widest vector load that d allows (float4 at
// d = 100: 25 lanes; float2 at d = 64: all 32; scalar where d is odd,
// as at d = 1433), so each slot's row of x is one coalesced warp load.
// The lanes read the row's col and wgt 32 slots at a time, coalesced,
// and broadcast each slot by shuffle, so col and wgt are read once
// where d <= 32 x the vector width (d > 32 x it walks the features in
// chunks and reads them again, from L1).  The slots are walked in
// order with the product and the sum each rounded (no FMA
// contraction): the sum is the sequential sum, the same from launch to
// launch.  Padding slots (weight 0, pointing at the zero row) are read
// like any other, so the sum keeps the reference's x * 0.  Offsets
// col * d and r * d are 64-bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp a row
constexpr int kBlockThreads = 32 * kRowsPerBlock;
constexpr int kSum = 0;
constexpr int kMax = 1;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int OP, int V>
__global__ void __launch_bounds__(kBlockThreads)
spmm_ell_kernel(const float* __restrict__ x, const int* __restrict__ col,
                const float* __restrict__ wgt, float* __restrict__ out,
                int R, int W, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // uniform across the warp: its lanes share `row`
  const long long base = row * W;
  const int nv = d / V;  // vectors in a row of x
  for (int j0 = 0; j0 < nv; j0 += 32) {
    const int j = j0 + lane;
    const bool active = j < nv;
    const long long off = static_cast<long long>(j) * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = OP == kSum ? 0.f : -INFINITY;
    for (int s0 = 0; s0 < W; s0 += 32) {
      const int n = min(32, W - s0);
      int my_col = 0;
      float my_w = 0.f;
      if (lane < n) {
        my_col = __ldg(col + base + s0 + lane);
        my_w = __ldg(wgt + base + s0 + lane);
      }
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const int c = __shfl_sync(0xffffffffu, my_col, t);
        const float w = __shfl_sync(0xffffffffu, my_w, t);
        if (!active) continue;
        const float* xr = x + static_cast<long long>(c) * d + off;
        float v[V];
        if constexpr (OP == kSum) {
          load_vec<V>(xr, v);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], w));
        } else if (w > 0.f) {
          load_vec<V>(xr, v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if (v[i] > acc[i] || isnan(v[i])) acc[i] = v[i];  // fmaxf drops NaN
          }
        }
      }
    }
    if (active) store_vec<V>(out + row * d + off, acc);
  }
}

// The widest of float4, float2 and float that divides d and the two
// pointers' alignment; then narrower while a row still takes one pass
// of the warp, so that more lanes load (d = 64: float2 on 32 lanes).
int vector_width(const float* x, const float* out, int d) {
  const auto aligned = [&](uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(out) % bytes == 0;
  };
  int v = 1;
  if (d % 4 == 0 && aligned(16)) {
    v = 4;
  } else if (d % 2 == 0 && aligned(8)) {
    v = 2;
  }
  while (v > 1 && d / v < 32 && d / (v / 2) <= 32) v /= 2;
  return v;
}

template <int OP>
void launch_op(const float* x, const int* col, const float* wgt, float* out,
               int R, int W, int d, cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((static_cast<long long>(R) + kRowsPerBlock - 1) / kRowsPerBlock);
  switch (vector_width(x, out, d)) {
    case 4:
      spmm_ell_kernel<OP, 4><<<blocks, kBlockThreads, 0, stream>>>(x, col, wgt, out, R, W, d);
      break;
    case 2:
      spmm_ell_kernel<OP, 2><<<blocks, kBlockThreads, 0, stream>>>(x, col, wgt, out, R, W, d);
      break;
    default:
      spmm_ell_kernel<OP, 1><<<blocks, kBlockThreads, 0, stream>>>(x, col, wgt, out, R, W, d);
  }
}

}  // namespace

// x (n_x, d) f32, col (R, W) int32 in [0, n_x), wgt (R, W) f32, out (R, d)
// f32; all contiguous.  op 0 is the sum, 1 the max.  out is fully
// written (zeros or -inf when W == 0).
extern "C" int spmm_ell_launch(const float* x, const int* col, const float* wgt,
                               float* out, int R, int W, int d, int op,
                               cudaStream_t stream) {
  if (op != kSum && op != kMax) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(R) * d == 0) return 0;
  if (op == kSum) {
    launch_op<kSum>(x, col, wgt, out, R, W, d, stream);
  } else {
    launch_op<kMax>(x, col, wgt, out, R, W, d, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
