// Embedding bag: a gather of table rows and their weighted sum per bag,
//
//   out[b] = sum_l w[b, l] * table[idx[b, l]]     (l = 0 .. L-1 in order)
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (embedding_bag -> _bag_kernel).  There a grid step (b, l) DMAs one
// table row, selected by a scalar-prefetched index, into VMEM and adds
// row * w into the revisited (1, d) output block.  Each step here rounds
// the product and then the sum (__fmul_rn, __fadd_rn: no FMA
// contraction) in l order, which is the TPU kernel's sequential
// `out += row * w`, so the two agree bit for bit.  Padding slots carry
// weight 0 (and index 0).  Bound: device-memory bytes at 3.35 TB/s (H100
// SXM at its 700 W limit, data sheet): the rows the bags touch, idx, w
// and out, each moved once; at MIND's serving widths the 33.5 MB
// profile table fits the 50 MB L2, so rows that several bags share are
// read from device memory once.
//
// A row load cannot start before its index is known, and a thread that
// loads idx[b, l], then its row, then adds, for l in order, waits on 2L
// round trips to memory.  So a group of G lanes serves a bag (G the power
// of two >= its columns, at most 32; a column is a float4, or a float
// where d % 4 != 0 or the table is not 16-byte aligned): the group loads
// the bag's indices and weights 32 slots at a time, one coalesced load a
// lane, and shares them by shuffle; each lane then issues the row loads
// of kChunk slots before it adds any of them, in l order.  At MIND's
// d = 64 and L = 16 that is 16 lanes a bag and four chunks of 4 float4
// loads.  Columns past 32 groups' worth (d > 128) take further passes.
// Measured on an H100 (scripts/bag_ab.py, PERF.md), the chain was not
// what bounds it: the bags' rows come from L2 (1.07 GB of them at
// serve_bulk, 16 a bag), and the kernel, like its parent, moves them at
// about 7 TB/s.  4 loads in flight a lane at 48 registers beat 8 at 69
// (fewer resident threads) by 13% and the parent's thread a column by 6%
// (scripts/bag_ab.py builds the other values from an edited copy of
// this file).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;   // row loads a lane issues before its adds
constexpr int kBatch = 32;  // slots whose idx and w a group loads at once
static_assert(kBatch % kChunk == 0, "a chunk must not run past the batch's slots");

__device__ __forceinline__ float4 zero_of(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float zero_of(float) { return 0.f; }

__device__ __forceinline__ float4 add_product(float4 acc, float4 r, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(r.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(r.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(r.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(r.w, w));
  return acc;
}
__device__ __forceinline__ float add_product(float acc, float r, float w) {
  return __fadd_rn(acc, __fmul_rn(r, w));
}

// T: float4 or float columns; nc columns a row.  Thread t serves bag
// t / G, columns t % G, t % G + G, ...  Every lane of a warp runs the
// same slot loop (L is the same for all bags), so the shuffles see all
// 32 lanes.
template <int G, typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ w, T* __restrict__ out, int B, int L, int nc) {
  constexpr int kPer = kBatch / G;  // slots of a batch each lane loads
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int k = static_cast<int>(threadIdx.x) & (G - 1);
  const long long b = t / G;
  const bool bag = b < B;
  const int* ib = idx + (bag ? b : 0) * L;
  const float* wb = w + (bag ? b : 0) * L;
  for (int c0 = 0; c0 < nc; c0 += G) {
    const int c = c0 + k;
    const bool on = bag && c < nc;
    T acc = zero_of(T{});
    for (int l0 = 0; l0 < L; l0 += kBatch) {
      int my_i[kPer];
      float my_w[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {  // slot l0 + k + G q, coalesced over the group
        const int s = l0 + k + G * q;
        my_i[q] = bag && s < L ? __ldg(ib + s) : 0;
        my_w[q] = bag && s < L ? __ldg(wb + s) : 0.f;
      }
      const int n = min(kBatch, L - l0);
#pragma unroll
      for (int u0 = 0; u0 < kBatch; u0 += kChunk) {
        if (u0 >= n) break;  // uniform across the warp
        T r[kChunk];
        float wl[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {  // slot u0 + u is lane (u0+u) % G's, entry (u0+u) / G
          const int i = __shfl_sync(0xffffffffu, my_i[(u0 + u) / G], (u0 + u) % G, G);
          wl[u] = __shfl_sync(0xffffffffu, my_w[(u0 + u) / G], (u0 + u) % G, G);
          r[u] = on && u0 + u < n ? __ldg(table + static_cast<long long>(i) * nc + c)
                                  : zero_of(T{});
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (u0 + u < n) acc = add_product(acc, r[u], wl[u]);
        }
      }
    }
    if (on) out[b * nc + c] = acc;
  }
}

unsigned int blocks_for(long long threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

template <typename T>
void launch(const T* table, const int* idx, const float* w, T* out, int B, int L, int nc,
            cudaStream_t stream) {
  int g = 1;
  while (g < nc && g < 32) g *= 2;
  const unsigned int blocks = blocks_for(static_cast<long long>(B) * g);
  switch (g) {
    case 1: embedding_bag_kernel<1, T><<<blocks, kThreads, 0, stream>>>(table, idx, w, out, B, L, nc); break;
    case 2: embedding_bag_kernel<2, T><<<blocks, kThreads, 0, stream>>>(table, idx, w, out, B, L, nc); break;
    case 4: embedding_bag_kernel<4, T><<<blocks, kThreads, 0, stream>>>(table, idx, w, out, B, L, nc); break;
    case 8: embedding_bag_kernel<8, T><<<blocks, kThreads, 0, stream>>>(table, idx, w, out, B, L, nc); break;
    case 16: embedding_bag_kernel<16, T><<<blocks, kThreads, 0, stream>>>(table, idx, w, out, B, L, nc); break;
    default: embedding_bag_kernel<32, T><<<blocks, kThreads, 0, stream>>>(table, idx, w, out, B, L, nc);
  }
}

}  // namespace

// table (V, d) f32, idx (B, L) int32 in [0, V), w (B, L) f32, out (B, d)
// f32; all contiguous.  out is fully written (zeros when L == 0).
extern "C" int embedding_bag_launch(const float* table, const int* idx,
                                    const float* w, float* out, int B, int L,
                                    int d, cudaStream_t stream) {
  if (static_cast<long long>(B) * d == 0) return 0;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    launch(reinterpret_cast<const float4*>(table), idx, w, reinterpret_cast<float4*>(out),
           B, L, d / 4, stream);
  } else {
    launch(table, idx, w, out, B, L, d, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
