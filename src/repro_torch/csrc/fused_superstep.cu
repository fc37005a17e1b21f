// Fused sparse-superstep relaxation: gather + min-plus relax +
// scatter-min of the compacted frontier in one launch.
//
// Replaces the TPU kernel src/repro/kernels/superstep_fused/kernel.py
// (fused_superstep -> _fused_kernel).  For f < count:
//
//   out[col[r, w]] = min(out[...], dist[row_src[r]] + wgt[r, w]),
//   r = clip(row_idx[f], 0, R-1)
//
// into an (n_out+1,) buffer the caller fills with +inf (slot n_out
// takes the ELL padding).
//
// The TPU kernel keeps the whole output block resident in VMEM.  On
// Hopper the output does not fit a block's shared memory (4 MB at
// rmat scale 20 against an H100's 227 KB), so each (f, w) thread
// scatters with a global fp32 atomic min that lands in the H100's 50 MB
// L2.  Bound: device memory bytes at 3.35 TB/s (H100 SXM at its 700 W
// limit, data sheet): the live rows' col and wgt strips, their
// sources' distances and one write of the output; one add per edge
// is far below any compute limit.
#include "minplus.cuh"

__global__ void fused_superstep_kernel(
    const float* __restrict__ dist, const int* __restrict__ row_idx,
    const int* __restrict__ count, const int* __restrict__ row_src,
    const int* __restrict__ col, const float* __restrict__ wgt,
    float* __restrict__ out, int F, int R, int W) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int live = min(*count, F);
  if (t >= static_cast<long long>(live) * W) return;
  const int f = static_cast<int>(t / W);
  const int w = static_cast<int>(t - static_cast<long long>(f) * W);
  const int r = min(max(row_idx[f], 0), R - 1);
  const long long e = static_cast<long long>(r) * W + w;
  const float v = dist[row_src[r]] + wgt[e];
  if (v == INFINITY) return;  // padding slot or unreached source: min identity
  atomic_min_f32(out + col[e], v);
}

extern "C" int fused_superstep_launch(
    const float* dist, const int* row_idx, const int* count,
    const int* row_src, const int* col, const float* wgt, float* out,
    int F, int R, int W, cudaStream_t stream) {
  const long long threads = static_cast<long long>(F) * W;
  if (threads == 0) return 0;
  fused_superstep_kernel<<<blocks_for(threads), kThreads, 0, stream>>>(
      dist, row_idx, count, row_src, col, wgt, out, F, R, W);
  return static_cast<int>(cudaGetLastError());
}
