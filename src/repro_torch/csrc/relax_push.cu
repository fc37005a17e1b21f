// Push-mode frontier gather: the (F, W) min-plus candidates of the
// compacted frontier rows; the caller scatter-mins them.
//
// Replaces the TPU kernel src/repro/kernels/relax_push/kernel.py
// (relax_push_gather -> _push_kernel):
//
//   out[f, w] = dist[row_src[r]] + wgt[r, w],  r = clip(row_idx[f], 0, R-1)
//
// for f < count, and +inf for f >= count.
//
// The TPU kernel scalar-prefetches row_idx so its DMA engine streams
// the listed (1, W) strips.  Here one thread per (f, w) reads its row
// id and source distance (shared by the W threads of a row, served by
// L1) and the strip element; neighbouring threads read neighbouring
// weights, so the strip loads coalesce.  Bound: device memory bytes at
// 3.35 TB/s (H100 SXM at its 700 W limit, data sheet): the live rows'
// wgt strips and source distances, and one write of the (F, W) output.
#include "minplus.cuh"

__global__ void relax_push_gather_kernel(
    const float* __restrict__ dist, const int* __restrict__ row_idx,
    const int* __restrict__ count, const int* __restrict__ row_src,
    const float* __restrict__ wgt, float* __restrict__ out,
    int F, int R, int W) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(F) * W) return;
  const int f = static_cast<int>(t / W);
  float v = INFINITY;
  if (f < min(*count, F)) {
    const int w = static_cast<int>(t - static_cast<long long>(f) * W);
    const int r = min(max(row_idx[f], 0), R - 1);
    v = dist[row_src[r]] + wgt[static_cast<long long>(r) * W + w];
  }
  out[t] = v;
}

extern "C" int relax_push_gather_launch(
    const float* dist, const int* row_idx, const int* count,
    const int* row_src, const float* wgt, float* out, int F, int R, int W,
    cudaStream_t stream) {
  const long long threads = static_cast<long long>(F) * W;
  if (threads == 0) return 0;
  relax_push_gather_kernel<<<blocks_for(threads), kThreads, 0, stream>>>(
      dist, row_idx, count, row_src, wgt, out, F, R, W);
  return static_cast<int>(cudaGetLastError());
}
