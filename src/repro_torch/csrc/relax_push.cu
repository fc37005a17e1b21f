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
// the listed (1, W) strips.  Bound: device memory bytes at 3.35 TB/s
// (H100 SXM at its 700 W limit, data sheet): the live rows' wgt strips
// and source distances, and one write of the (F, W) output.
//
// Design (minplus.cuh, walk_frontier): a persistent grid over the live
// rows only, a row to a group of W/4 lanes reading its strip and
// writing its candidates as 16-byte vectors, the row metadata
// pipelined in the group's lane 0.  The rows past count are then
// written as +inf with streaming vector stores and no loads.
//
// The batched entry (relax_push_gather_batch_launch) runs S = B·P
// lanes, lane-major, in one launch: lane s gathers its own frontier
// (row_idx[s], count[s]) over graph rank s % P into its own (F, W)
// block of the (S, F, W) output.  One 1-D persistent grid serves all
// lanes, its warps shared out by the lanes' live rows, then by their
// rows past count (minplus.cuh, LaneShares).
#include "minplus.cuh"

namespace {

template <int VEC>
struct GatherOp {
  const float* __restrict__ wgt;
  float* __restrict__ out;

  __device__ __forceinline__ typename Chunk<VEC>::F load(long long e, bool ok) const {
    return ok ? load_chunk<VEC>(wgt + e) : inf_chunk<VEC>();
  }

  __device__ __forceinline__ void apply(long long o, long long, float d,
                                        const typename Chunk<VEC>::F& w, bool ok) const {
    if (ok) *reinterpret_cast<typename Chunk<VEC>::F*>(out + o) = add_chunk(d, w);
  }
};

// +inf in the rows past `live` of an (F, W) output, streamed past the
// caches, vector i = first + k * step.
template <int VEC>
__device__ __forceinline__ void fill_tail(float* __restrict__ out, int live, int F, int W,
                                          long long first, long long step) {
  typedef typename Chunk<VEC>::F V;
  V* const tail = reinterpret_cast<V*>(out + static_cast<long long>(live) * W);
  const long long n = static_cast<long long>(F - live) * W / VEC;
  for (long long i = first; i < n; i += step) __stcs(tail + i, inf_chunk<VEC>());
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) relax_push_gather_kernel(
    const float* __restrict__ dist, const int* __restrict__ row_idx,
    const int* __restrict__ count, const int* __restrict__ row_src,
    const float* __restrict__ wgt, float* __restrict__ out,
    int F, int R, int W, int G) {
  const int live = live_rows(count, F);
  GatherOp<VEC> op{wgt, out};
  walk_frontier<VEC>(dist, row_idx, row_src, live, R, W, G, op, grid_warp(), grid_warps());
  fill_tail<VEC>(out, live, F, W,
                 static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
                 static_cast<long long>(gridDim.x) * blockDim.x);
}

// n_s of the tail: lane s's rows past count.
struct TailRows {
  const int* __restrict__ count;
  int F;
  __device__ __forceinline__ int operator()(int s) const { return F - live_rows(count + s, F); }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads) relax_push_gather_batch_kernel(
    const float* __restrict__ dist, const int* __restrict__ row_idx,
    const int* __restrict__ count, const int* __restrict__ row_src,
    const float* __restrict__ wgt, float* __restrict__ out,
    int F, int R, int W, int G, int P, int n_dist, int S) {
  const int lane = threadIdx.x & 31;
  visit_share(LiveRows{count, F}, S, [&](const Share& sh) {
    const long long s = sh.lane, q = sh.lane % P;
    GatherOp<VEC> op{wgt + q * R * W, out + s * F * W};
    walk_frontier<VEC>(dist + s * n_dist, row_idx + s * F, row_src + q * R, sh.rows,
                       R, W, G, op, sh.slot, sh.slots);
  });
  visit_share(TailRows{count, F}, S, [&](const Share& sh) {
    fill_tail<VEC>(out + static_cast<long long>(sh.lane) * F * W, F - sh.rows, F, W,
                   static_cast<long long>(sh.slot) * 32 + lane,
                   static_cast<long long>(sh.slots) * 32);
  });
}

template <int VEC>
int batch_grid(int F, int W, int S, unsigned int* grid) {
  static int cache[kMaxDevices];
  return static_cast<int>(frontier_batch_grid(
      relax_push_gather_batch_kernel<VEC>, cache, F, group_lanes(W, VEC), S, grid));
}

template <int VEC>
int launch_batch(const float* dist, const int* row_idx, const int* count,
                 const int* row_src, const float* wgt, float* out, int F, int R,
                 int W, int P, int n_dist, int S, cudaStream_t stream) {
  unsigned int grid = 0;
  const int err = batch_grid<VEC>(F, W, S, &grid);
  if (err != 0) return err;
  relax_push_gather_batch_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      dist, row_idx, count, row_src, wgt, out, F, R, W, group_lanes(W, VEC), P, n_dist, S);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch(const float* dist, const int* row_idx, const int* count,
           const int* row_src, const float* wgt, float* out, int F, int R, int W,
           cudaStream_t stream) {
  static int cache[kMaxDevices];
  const int G = group_lanes(W, VEC);
  unsigned int grid = 0;
  const cudaError_t err = frontier_grid(relax_push_gather_kernel<VEC>, cache, F, G, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_push_gather_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      dist, row_idx, count, row_src, wgt, out, F, R, W, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 1 when W % 4 == 0 and wgt and out start on 16 bytes (the caller
// checks), else 0 for scalar loads and stores.
extern "C" int relax_push_gather_launch(
    const float* dist, const int* row_idx, const int* count,
    const int* row_src, const float* wgt, float* out, int F, int R, int W,
    int vec, cudaStream_t stream) {
  if (static_cast<long long>(F) * W == 0) return 0;
  return vec ? launch<4>(dist, row_idx, count, row_src, wgt, out, F, R, W, stream)
             : launch<1>(dist, row_idx, count, row_src, wgt, out, F, R, W, stream);
}

// Batched: dist (S, n_dist), row_idx (S, F), count (S,), row_src (P, R),
// wgt (P, R, W), out (S, F, W); lane s reads rank s % P.  vec as above.
extern "C" int relax_push_gather_batch_launch(
    const float* dist, const int* row_idx, const int* count,
    const int* row_src, const float* wgt, float* out, int F, int R, int W,
    int P, int n_dist, int S, int vec, cudaStream_t stream) {
  if (static_cast<long long>(F) * W * S == 0) return 0;
  return vec ? launch_batch<4>(dist, row_idx, count, row_src, wgt, out, F, R, W, P,
                               n_dist, S, stream)
             : launch_batch<1>(dist, row_idx, count, row_src, wgt, out, F, R, W, P,
                               n_dist, S, stream);
}

// The blocks of the 1-D grid the batched entry launches for these sizes.
extern "C" int relax_push_gather_batch_grid(int F, int W, int S, int vec,
                                            unsigned int* grid) {
  return vec ? batch_grid<4>(F, W, S, grid) : batch_grid<1>(F, W, S, grid);
}
