// Embedding bag: a gather of table rows and their weighted sum per bag,
//
//   out[b] = sum_l w[b, l] * table[idx[b, l]]     (l = 0 .. L-1 in order)
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (embedding_bag -> _bag_kernel).  There a grid step (b, l) DMAs one
// table row, selected by a scalar-prefetched index, into VMEM and adds
// row * w into the revisited (1, d) output block.  Here a thread owns
// four columns of one bag (one column where d % 4 != 0 or the table is
// not 16-byte aligned) and walks l in order, loading its slice of each
// row with one 16-byte load; the d/4 threads of a bag read a whole row
// together.  Each step rounds the product and then the sum
// (__fmul_rn, __fadd_rn: no FMA contraction), which is the TPU
// kernel's sequential `out += row * w`, so the two agree bit for bit.
// Padding slots carry weight 0 (and index 0).  Bound: device-memory
// bytes at 3.35 TB/s (H100 SXM at its 700 W limit, data sheet): the
// rows the bags touch, idx, w and out, each moved once; at MIND's
// serving widths the 33.5 MB profile table fits the 50 MB L2, so rows
// that several bags share are read from device memory once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void embedding_bag_vec4(const float4* __restrict__ table,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ w,
                                   float4* __restrict__ out, int B, int L,
                                   int d4) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * d4) return;
  const long long b = t / d4;
  const int c = static_cast<int>(t - b * d4);
  const int* ib = idx + b * L;
  const float* wb = w + b * L;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l = 0; l < L; ++l) {
    const float wl = wb[l];
    const float4 r = table[static_cast<long long>(ib[l]) * d4 + c];
    acc.x = __fadd_rn(acc.x, __fmul_rn(r.x, wl));
    acc.y = __fadd_rn(acc.y, __fmul_rn(r.y, wl));
    acc.z = __fadd_rn(acc.z, __fmul_rn(r.z, wl));
    acc.w = __fadd_rn(acc.w, __fmul_rn(r.w, wl));
  }
  out[t] = acc;
}

__global__ void embedding_bag_scalar(const float* __restrict__ table,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ w,
                                     float* __restrict__ out, int B, int L,
                                     int d) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * d) return;
  const long long b = t / d;
  const int c = static_cast<int>(t - b * d);
  const int* ib = idx + b * L;
  const float* wb = w + b * L;
  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    acc = __fadd_rn(acc, __fmul_rn(table[static_cast<long long>(ib[l]) * d + c], wb[l]));
  }
  out[t] = acc;
}

unsigned int blocks_for(long long threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
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
    const long long threads = static_cast<long long>(B) * (d / 4);
    embedding_bag_vec4<<<blocks_for(threads), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(table), idx, w,
        reinterpret_cast<float4*>(out), B, L, d / 4);
  } else {
    const long long threads = static_cast<long long>(B) * d;
    embedding_bag_scalar<<<blocks_for(threads), kThreads, 0, stream>>>(
        table, idx, w, out, B, L, d);
  }
  return static_cast<int>(cudaGetLastError());
}
