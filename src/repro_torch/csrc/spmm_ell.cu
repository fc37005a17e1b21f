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
// spends its effort on loads.
//
// One warp owns one (row, feature chunk).  Its lanes span the chunk's
// features with the widest vector load that d allows, so each slot's
// row of x is one coalesced warp load: float4 at d = 100 (25 lanes),
// float2 at d = 64 (all 32).  Wide rows of odd d (d = 1433) start at
// any alignment; there each lane loads the 16-byte-aligned float4 that
// holds its first feature and takes the rest from its neighbour's by
// shuffle (load_shifted): one load instruction for four features, not
// four scalar ones; the output rows, as unaligned, are stored 32
// consecutive features a step after a shuffle back.  Narrow odd rows
// (d < 128) load scalars.  A chunk is 32 vectors.  Where a row needs
// more than one (d = 1433: 12 chunks of float4) a second grid
// dimension gives each chunk its own warp, so a wide row no longer
// walks its chunks in one warp; the GIN widths (d = 100 and 64) take
// one chunk, one warp a row.
//
// The lanes read the row's col and wgt 32 slots at a time, coalesced,
// and broadcast each slot by shuffle; the warps of one wide row each
// read them (again from L1/L2).  Every feature's slots are walked in
// order with the product and the sum each rounded (no FMA
// contraction): the sum is the sequential sum, the same from launch to
// launch and whatever the split.  Padding slots (weight 0, pointing at
// the zero row) are read like any other, so the sum keeps the
// reference's x * 0.  Offsets col * d and r * d are 64-bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp a (row, chunk)
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

// The float4 at p (16-byte aligned) where `need`, zeros elsewhere.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool need) {
  return need ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// v = floats M .. M+3 of (lo, hi)
template <int M>
__device__ __forceinline__ void pick(const float4& lo, const float4& hi, float (&v)[4]) {
  const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = f[M + i];
}

// Features 4j .. 4j+3 of the row of x that starts at element r, of any
// alignment (odd d): each lane loads the 16-byte-aligned float4 at
// r - r%4 + 4j and takes the rest from the next lane's by shuffle;
// lane 31 loads the next one itself, issued beside the first so the two
// loads share one wait.  Only float4s that hold a feature of the row
// are read: x's base is 16-byte aligned, so no load reaches past the
// 16-byte granule of x's last element.  All lanes of the warp must call
// it: it shuffles.
__device__ __forceinline__ void load_shifted(const float* __restrict__ x, long long r,
                                             int j, int d, int lane, float (&v)[4]) {
  const int m = static_cast<int>(r & 3);
  const float* p = x + (r - m) + 4 * j;
  const int e = 4 * j - m;  // the row's feature at p
  const float4 lo = load4(p, e < d);
  const float4 own = load4(p + 4, lane == 31 && m != 0 && e + 4 < d);
  float4 hi;
  hi.x = __shfl_down_sync(0xffffffffu, lo.x, 1);
  hi.y = __shfl_down_sync(0xffffffffu, lo.y, 1);
  hi.z = __shfl_down_sync(0xffffffffu, lo.z, 1);
  hi.w = __shfl_down_sync(0xffffffffu, lo.w, 1);
  if (lane == 31) hi = own;
  switch (m) {  // uniform across the warp
    case 0: pick<0>(lo, hi, v); break;
    case 1: pick<1>(lo, hi, v); break;
    case 2: pick<2>(lo, hi, v); break;
    default: pick<3>(lo, hi, v);
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

// V features a lane, loaded as one vector; SHIFT (V = 4, odd d): rows
// of x start at any alignment and are read through load_shifted.
template <int OP, int V, bool SHIFT>
__global__ void __launch_bounds__(kBlockThreads)
spmm_ell_kernel(const float* __restrict__ x, const int* __restrict__ col,
                const float* __restrict__ wgt, float* __restrict__ out,
                int R, int W, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // uniform across the warp: its lanes share `row`
  const long long base = row * W;
  const int nv = SHIFT ? (d + 3) / 4 : d / V;  // vectors covering a row of x
  // this warp's chunk of 32 vectors: blockIdx.y (and every gridDim.y-th
  // after it, past the grid's 65535 limit)
  const int step = 32 * static_cast<int>(gridDim.y);
  for (int j0 = 32 * static_cast<int>(blockIdx.y); j0 < nv; j0 += step) {
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
        float v[V];
        if constexpr (SHIFT) {
          // w is the warp's: the skip is uniform, the shuffles safe
          if (OP == kMax && !(w > 0.f)) continue;
          load_shifted(x, static_cast<long long>(c) * d, j, d, lane, v);
          if (!active) continue;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if constexpr (OP == kSum) {
              acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], w));
            } else if (v[i] > acc[i] || isnan(v[i])) {
              acc[i] = v[i];
            }
          }
          continue;
        }
        if (!active) continue;
        const float* xr = x + static_cast<long long>(c) * d + off;
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
    if constexpr (SHIFT) {
      // rows of out are as unaligned as those of x: store 32 consecutive
      // features a step, feature 4*j0 + 32i + lane from lane 8i + lane/4
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int src = 8 * i + lane / 4;
        const float a0 = __shfl_sync(0xffffffffu, acc[0], src);
        const float a1 = __shfl_sync(0xffffffffu, acc[1], src);
        const float a2 = __shfl_sync(0xffffffffu, acc[2], src);
        const float a3 = __shfl_sync(0xffffffffu, acc[3], src);
        const int k = lane & 3;
        const long long f = 4LL * j0 + 32 * i + lane;
        if (f < d) out[row * d + f] = k == 0 ? a0 : k == 1 ? a1 : k == 2 ? a2 : a3;
      }
    } else if (active) {
      store_vec<V>(out + row * d + off, acc);
    }
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
  const int v = vector_width(x, out, d);
  // wide rows that take scalar loads (odd d) go through load_shifted
  const bool shift = v == 1 && d >= 4 * 32 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nv = shift ? (d + 3) / 4 : d / v;
  const int chunks = (nv + 31) / 32;  // of 32 vectors, one a warp
  const dim3 blocks(
      static_cast<unsigned int>((static_cast<long long>(R) + kRowsPerBlock - 1) / kRowsPerBlock),
      static_cast<unsigned int>(chunks < 65535 ? chunks : 65535));
  if (shift) {
    spmm_ell_kernel<OP, 4, true><<<blocks, kBlockThreads, 0, stream>>>(x, col, wgt, out, R, W, d);
    return;
  }
  switch (v) {
    case 4:
      spmm_ell_kernel<OP, 4, false><<<blocks, kBlockThreads, 0, stream>>>(x, col, wgt, out, R, W, d);
      break;
    case 2:
      spmm_ell_kernel<OP, 2, false><<<blocks, kBlockThreads, 0, stream>>>(x, col, wgt, out, R, W, d);
      break;
    default:
      spmm_ell_kernel<OP, 1, false><<<blocks, kBlockThreads, 0, stream>>>(x, col, wgt, out, R, W, d);
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
