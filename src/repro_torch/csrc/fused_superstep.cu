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
// rmat scale 20 against an H100's 227 KB), so each candidate scatters
// with a global fp32 atomic min that lands in the H100's 50 MB L2.
// Bound: device memory bytes at 3.35 TB/s (H100 SXM at its 700 W
// limit, data sheet): the live rows' col and wgt strips, their
// sources' distances and one write of the output; one add per edge is
// far below any compute limit.
//
// Design (minplus.cuh, walk_frontier): a persistent grid over the live
// rows only, a row to a group of W/4 lanes reading its wgt strip as
// 16-byte vectors, the row metadata pipelined in the group's lane 0.
// A chunk whose four candidates are all +inf (padding, or an
// unreached source) skips its col load; each finite candidate is one
// pre-checked atomic min.
//
// The batched entry (fused_superstep_batch_launch) runs S = B·P lanes,
// lane-major, in one launch, as vmap gives the TPU kernel a batch grid
// axis: lane s walks its own frontier (row_idx[s], count[s]) over graph
// rank s % P, reads its own distances and scatter-mins into its own
// output row.  One 1-D persistent grid serves all lanes, its warps
// shared out by the lanes' live rows (minplus.cuh, LaneShares): a lane
// at 0 takes no warp, a lane near F most of the card.
#include "minplus.cuh"

namespace {

template <int VEC>
struct FusedOp {
  const int* __restrict__ col;
  const float* __restrict__ wgt;
  float* __restrict__ out;

  __device__ __forceinline__ typename Chunk<VEC>::F load(long long e, bool ok) const {
    return ok ? load_chunk<VEC>(wgt + e) : inf_chunk<VEC>();
  }

  __device__ __forceinline__ void apply(long long, long long e, float d,
                                        const typename Chunk<VEC>::F& w, bool ok) const {
    float v[VEC];
    bool any = false;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      v[k] = d + elem(w, k);
      any |= v[k] != INFINITY;
    }
    if (!ok || !any) return;  // padding or unreached source: min identity
    const typename Chunk<VEC>::I c = load_chunk<VEC>(col + e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (v[k] != INFINITY) atomic_min_f32(out + elem(c, k), v[k]);
    }
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads) fused_superstep_kernel(
    const float* __restrict__ dist, const int* __restrict__ row_idx,
    const int* __restrict__ count, const int* __restrict__ row_src,
    const int* __restrict__ col, const float* __restrict__ wgt,
    float* __restrict__ out, int F, int R, int W, int G) {
  FusedOp<VEC> op{col, wgt, out};
  walk_frontier<VEC>(dist, row_idx, row_src, live_rows(count, F), R, W, G, op,
                     grid_warp(), grid_warps());
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) fused_superstep_batch_kernel(
    const float* __restrict__ dist, const int* __restrict__ row_idx,
    const int* __restrict__ count, const int* __restrict__ row_src,
    const int* __restrict__ col, const float* __restrict__ wgt,
    float* __restrict__ out, int F, int R, int W, int G, int P, int n_dist,
    int n_out1, int S) {
  visit_share(LiveRows{count, F}, S, [&](const Share& sh) {
    const long long s = sh.lane, q = sh.lane % P;
    FusedOp<VEC> op{col + q * R * W, wgt + q * R * W, out + s * n_out1};
    walk_frontier<VEC>(dist + s * n_dist, row_idx + s * F, row_src + q * R, sh.rows,
                       R, W, G, op, sh.slot, sh.slots);
  });
}

template <int VEC>
int batch_grid(int F, int W, int S, unsigned int* grid) {
  static int cache[kMaxDevices];
  return static_cast<int>(frontier_batch_grid(
      fused_superstep_batch_kernel<VEC>, cache, F, group_lanes(W, VEC), S, grid));
}

template <int VEC>
int launch_batch(const float* dist, const int* row_idx, const int* count,
                 const int* row_src, const int* col, const float* wgt, float* out,
                 int F, int R, int W, int P, int n_dist, int n_out1, int S,
                 cudaStream_t stream) {
  unsigned int grid = 0;
  const int err = batch_grid<VEC>(F, W, S, &grid);
  if (err != 0) return err;
  fused_superstep_batch_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      dist, row_idx, count, row_src, col, wgt, out, F, R, W, group_lanes(W, VEC),
      P, n_dist, n_out1, S);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch(const float* dist, const int* row_idx, const int* count,
           const int* row_src, const int* col, const float* wgt, float* out,
           int F, int R, int W, cudaStream_t stream) {
  static int cache[kMaxDevices];
  const int G = group_lanes(W, VEC);
  unsigned int grid = 0;
  const cudaError_t err = frontier_grid(fused_superstep_kernel<VEC>, cache, F, G, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_superstep_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      dist, row_idx, count, row_src, col, wgt, out, F, R, W, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 1 when W % 4 == 0 and col and wgt start on 16 bytes (the caller
// checks), else 0 for scalar strip loads.
extern "C" int fused_superstep_launch(
    const float* dist, const int* row_idx, const int* count,
    const int* row_src, const int* col, const float* wgt, float* out,
    int F, int R, int W, int vec, cudaStream_t stream) {
  if (static_cast<long long>(F) * W == 0) return 0;
  return vec ? launch<4>(dist, row_idx, count, row_src, col, wgt, out, F, R, W, stream)
             : launch<1>(dist, row_idx, count, row_src, col, wgt, out, F, R, W, stream);
}

// Batched: dist (S, n_dist), row_idx (S, F), count (S,), row_src (P, R),
// col and wgt (P, R, W), out (S, n_out1) filled with +inf by the caller;
// lane s reads rank s % P.  vec as above.
extern "C" int fused_superstep_batch_launch(
    const float* dist, const int* row_idx, const int* count,
    const int* row_src, const int* col, const float* wgt, float* out,
    int F, int R, int W, int P, int n_dist, int n_out1, int S, int vec,
    cudaStream_t stream) {
  if (static_cast<long long>(F) * W * S == 0) return 0;
  return vec ? launch_batch<4>(dist, row_idx, count, row_src, col, wgt, out, F, R, W,
                               P, n_dist, n_out1, S, stream)
             : launch_batch<1>(dist, row_idx, count, row_src, col, wgt, out, F, R, W,
                               P, n_dist, n_out1, S, stream);
}

// The blocks of the 1-D grid the batched entry launches for these sizes.
extern "C" int fused_superstep_batch_grid(int F, int W, int S, int vec,
                                          unsigned int* grid) {
  return vec ? batch_grid<4>(F, W, S, grid) : batch_grid<1>(F, W, S, grid);
}
