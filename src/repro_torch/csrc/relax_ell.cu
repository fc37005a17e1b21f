// Pull-mode min-plus ELL relaxation, the hot loop of the
// self-stabilizing rule R1 (paper Algorithm 1):
//
//   out[r] = min_w (dist[col[r, w]] + wgt[r, w])
//
// Replaces the TPU kernel src/repro/kernels/relax_ell/kernel.py
// (relax_ell -> _relax_kernel).  The TPU kernel blocks rows so that
// (block_rows, W) tiles and the whole distance vector sit in VMEM, and
// needs the row count padded to the block size.  Here one warp owns one
// row: lane l reads slots l, l+32, ... (coalesced 128-byte loads of the
// col and wgt rows), gathers dist through L2, and a shuffle tree takes
// the min over the warp.  The kernel masks the ragged last block
// itself, so rows need no padding.  Bound: device memory bytes at
// 3.35 TB/s (H100 SXM at its 700 W limit, data sheet): col and wgt
// read once, dist once, out written once.
#include "minplus.cuh"

__global__ void relax_ell_kernel(
    const float* __restrict__ dist, const int* __restrict__ col,
    const float* __restrict__ wgt, float* __restrict__ out, int R, int W) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // uniform across the warp: its lanes share `row`
  const long long base = row * W;
  float m = INFINITY;
  for (int w = lane; w < W; w += 32) {
    m = fminf(m, dist[col[base + w]] + wgt[base + w]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (lane == 0) out[row] = m;
}

extern "C" int relax_ell_launch(
    const float* dist, const int* col, const float* wgt, float* out,
    int R, int W, cudaStream_t stream) {
  const long long threads = static_cast<long long>(R) * 32;
  if (threads == 0) return 0;
  relax_ell_kernel<<<blocks_for(threads), kThreads, 0, stream>>>(
      dist, col, wgt, out, R, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
