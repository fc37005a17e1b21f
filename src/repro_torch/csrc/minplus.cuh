// Shared pieces of the min-plus kernels: launch shape, an exact fp32
// atomic min on device memory, and the row walk of the two frontier
// kernels (fused_superstep.cu, relax_push.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;

// Exact fp32 atomic min for NaN-free values.  Non-negative floats order
// like their int bits, so atomicMin on the int view is the float min;
// negative floats order inversely to their uint bits, and every
// negative float's uint view exceeds every non-negative one's, so
// atomicMax on the uint view is the float min.  min does not depend on
// the order of the updates, so the result is bit-identical to any
// sequential scatter-min.  Values at an address only ever decrease, so
// a stale plain read that is already <= v proves the update moot.  The
// return value is unused, so the atomics compile to their no-return
// (RED) form.
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (*addr <= v) return;
  if (__float_as_int(v) >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__host__ __forceinline__ unsigned int blocks_for(long long threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

// ---- the frontier row walk --------------------------------------------
//
// A frontier kernel visits rows r = clip(row_idx[f], 0, R-1) of an
// (R, W) ELL for f < live = clamp(*count, 0, F), each a source distance
// d = dist[row_src[r]] and a strip of W slots.  A group of G lanes (a
// power of two, G <= 32) owns one row at a time, VEC consecutive slots
// (a chunk) a lane: VEC 4 reads the strips as 16-byte vectors, VEC 1 as
// scalars (W % 4 != 0 or an unaligned base).  A warp holds 32 / G rows;
// the warps of a persistent grid stride over the live rows.  The group's
// lane 0 loads the row metadata and broadcasts it by shuffle, pipelined
// over the group's rows: row_idx two rows ahead, row_src one row ahead,
// dist for the current row, so the three dependent loads of three rows
// are in flight together with the current row's strip loads.

template <int VEC> struct Chunk;
template <> struct Chunk<1> { typedef float F; typedef int I; };
template <> struct Chunk<4> { typedef float4 F; typedef int4 I; };

template <int VEC>
__device__ __forceinline__ typename Chunk<VEC>::F load_chunk(const float* p) {
  return __ldg(reinterpret_cast<const typename Chunk<VEC>::F*>(p));
}
template <int VEC>
__device__ __forceinline__ typename Chunk<VEC>::I load_chunk(const int* p) {
  return __ldg(reinterpret_cast<const typename Chunk<VEC>::I*>(p));
}

// Element k of a chunk (k a constant after unrolling).
__device__ __forceinline__ float elem(const float& v, int) { return v; }
__device__ __forceinline__ int elem(const int& v, int) { return v; }
__device__ __forceinline__ float elem(const float4& v, int k) { return (&v.x)[k]; }
__device__ __forceinline__ int elem(const int4& v, int k) { return (&v.x)[k]; }

// d + w slot by slot: one IEEE add each.
__device__ __forceinline__ float add_chunk(float d, float w) { return d + w; }
__device__ __forceinline__ float4 add_chunk(float d, const float4& w) {
  return make_float4(d + w.x, d + w.y, d + w.z, d + w.w);
}

template <int VEC>
__device__ __forceinline__ typename Chunk<VEC>::F inf_chunk();
template <> __device__ __forceinline__ float inf_chunk<1>() { return INFINITY; }
template <> __device__ __forceinline__ float4 inf_chunk<4>() {
  return make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
}

__device__ __forceinline__ int clip_row(int r, int R) { return min(max(r, 0), R - 1); }

__device__ __forceinline__ int live_rows(const int* count, int F) {
  return max(0, min(__ldg(count), F));
}

// Lanes a row: the chunks a row rounded up to a power of two, at most 32.
__host__ __device__ __forceinline__ int group_lanes(int W, int vec) {
  const int chunks = W / vec;
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

// The warp's index in the grid and the grid's warps.
__device__ __forceinline__ long long grid_warp() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
}
__device__ __forceinline__ long long grid_warps() {
  return static_cast<long long>(gridDim.x) * blockDim.x >> 5;
}

// Calls op.load(e, ok) for the chunk at ELL offset e and then
// op.apply(o, e, d, chunk, ok) with o the row-major offset f * W + c * VEC,
// for every chunk of the live rows f = first + i * step + (a row of the
// warp), i = 0, 1, ...: the warp's rows when `slots` warps walk the
// frontier, this one at `slot` (the whole grid for a single frontier).
// ok is false for lanes without a chunk.  Every lane of a warp makes
// the same calls, so an op may use warp-wide intrinsics.
template <int VEC, class Op>
__device__ __forceinline__ void walk_frontier(
    const float* __restrict__ dist, const int* __restrict__ row_idx,
    const int* __restrict__ row_src, int live, int R, int W, int G, Op& op,
    long long slot, long long slots) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const bool leader = gl == 0;
  const int rpw = 32 / G;
  const int chunks = W / VEC;
  const int per_lane = (chunks + G - 1) / G;
  const long long step = slots * rpw;
  long long f = slot * rpw + lane / G;
  int r = 0, s = 0, r_next = 0;
  if (leader && f < live) r = clip_row(__ldg(row_idx + f), R);
  if (leader && f + step < live) r_next = clip_row(__ldg(row_idx + f + step), R);
  if (leader && f < live) s = __ldg(row_src + r);
  for (long long base = slot * rpw; base < live; base += step, f += step) {
    const bool row_ok = f < live;
    const long long e0 = static_cast<long long>(__shfl_sync(kFullMask, r, 0, G)) * W;
    const long long o0 = f * W;
    const bool ok0 = row_ok && gl < chunks;
    const auto first = op.load(e0 + gl * VEC, ok0);
    float d = 0.0f;
    int s_next = 0, r_after = 0;
    if (leader && row_ok) d = __ldg(dist + s);
    if (leader && f + step < live) s_next = __ldg(row_src + r_next);
    if (leader && f + 2 * step < live)
      r_after = clip_row(__ldg(row_idx + f + 2 * step), R);
    d = __shfl_sync(kFullMask, d, 0, G);
    op.apply(o0 + gl * VEC, e0 + gl * VEC, d, first, ok0);
    for (int j = 1; j < per_lane; ++j) {
      const int c = gl + j * G;
      const bool ok = row_ok && c < chunks;
      op.apply(o0 + c * VEC, e0 + c * VEC, d, op.load(e0 + c * VEC, ok), ok);
    }
    r = r_next;
    s = s_next;
    r_next = r_after;
  }
}

// Blocks of a persistent grid for `kernel`: SMs x resident blocks a SM,
// asked of the runtime once per device and kept in `cache`
// (kMaxDevices entries, 0 until asked).
template <class Kernel>
__host__ cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                                       int* cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cache[dev] = *blocks;
  return cudaSuccess;
}

// The grid of a frontier kernel: the persistent grid, or fewer blocks
// where F rows at G lanes each fill fewer.
template <class Kernel>
__host__ cudaError_t frontier_grid(Kernel kernel, int* cache, long long F, int G,
                                   unsigned int* grid) {
  int blocks = 0;
  const cudaError_t err = persistent_blocks(kernel, kThreads, 0, cache, &blocks);
  if (err != cudaSuccess) return err;
  const long long rows_per_block = (kThreads / 32) * (32 / G);
  const long long need = (F + rows_per_block - 1) / rows_per_block;
  *grid = static_cast<unsigned int>(need < blocks ? need : blocks);
  return cudaSuccess;
}

// ---- S lanes on one 1-D persistent grid ---------------------------------
//
// A batched kernel walks S frontiers (lanes) at once, lane s with n_s
// rows to visit (its live rows; for the push gather's tail, its rows
// past count).  The grid's V warps are shared out by rows, not by
// lanes: with T = sum n_s over the L lanes that have any, lane s owns
// warps [a_s, a_{s+1}),
//
//   a_s = floor(start_s * (V - L) / T) + (lanes with rows before s),
//
// start_s the exclusive prefix of n: one warp at least for a lane with
// rows (the grid holds a warp at least a lane, frontier_batch_grid),
// the rest by its share of T.  A lane at 0 takes no warp, and a lane
// with most of the rows takes most of the card.  Every warp forms the
// prefix itself from count[0..S) on the device (a warp scan, S/32
// steps; no host sync, no block sync) and walks its one lane with the
// lane's fixed stride, so the lanes advance together and a row that two
// lanes list is read twice close in time, the second time from L2.

// A warp's place: its lane (-1: none), its index among the lane's
// warps, the lane's warps and the lane's rows.
struct Share {
  int lane, slot, slots, rows;
};

template <class Rows>
struct LaneShares {
  Rows rows_of;  // rows_of(s): n_s
  int S;
  double scale;  // (V - L) / T

  __device__ __forceinline__ LaneShares(const Rows& rows, int S_, long long warps)
      : rows_of(rows), S(S_) {
    const int lane = threadIdx.x & 31;
    long long total = 0;
    int lanes = 0;
    for (int s = lane; s < S; s += 32) {
      const int n = rows_of(s);
      total += n;
      lanes += n > 0;
    }
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(kFullMask, total, off);
      lanes += __shfl_xor_sync(kFullMask, lanes, off);
    }
    scale = total > 0 ? static_cast<double>(warps - lanes) / static_cast<double>(total)
                      : 0.0;
  }

  // The lane whose range holds warp vw; the same in every lane of the
  // warp.
  __device__ __forceinline__ Share find(long long vw) const {
    const int lane = threadIdx.x & 31;
    long long before = 0;  // rows of the lanes before this chunk of 32
    int lanes_before = 0;
    for (int b = 0; b < S; b += 32) {
      const int s = b + lane;
      const int n = s < S ? rows_of(s) : 0;
      long long x = n;  // inclusive scans of n and of n > 0
      int y = n > 0;
      for (int off = 1; off < 32; off <<= 1) {
        const long long xu = __shfl_up_sync(kFullMask, x, off);
        const int yu = __shfl_up_sync(kFullMask, y, off);
        if (lane >= off) {
          x += xu;
          y += yu;
        }
      }
      const long long start = before + x - n;
      const int lb = lanes_before + y - (n > 0);
      const long long a = __double2ll_rd(static_cast<double>(start) * scale) + lb;
      const long long a1 =
          __double2ll_rd(static_cast<double>(start + n) * scale) + lb + (n > 0);
      const unsigned hit = __ballot_sync(kFullMask, n > 0 && a <= vw && vw < a1);
      if (hit) {
        const int src = __ffs(hit) - 1;
        return Share{b + src, static_cast<int>(__shfl_sync(kFullMask, vw - a, src)),
                     static_cast<int>(__shfl_sync(kFullMask, a1 - a, src)),
                     __shfl_sync(kFullMask, n, src)};
      }
      before += __shfl_sync(kFullMask, x, 31);
      lanes_before += __shfl_sync(kFullMask, y, 31);
    }
    return Share{-1, 0, 0, 0};
  }
};

// n_s of a walk: lane s's live rows.
struct LiveRows {
  const int* __restrict__ count;
  int F;
  __device__ __forceinline__ int operator()(int s) const { return live_rows(count + s, F); }
};

// Calls visit(share) with this warp's place if it has a lane;
// warp-uniform.
template <class Rows, class Visit>
__device__ __forceinline__ void visit_share(const Rows& rows, int S, Visit visit) {
  const Share sh = LaneShares<Rows>(rows, S, grid_warps()).find(grid_warp());
  if (sh.lane >= 0) visit(sh);
}

// The grid of a batched frontier kernel: the persistent grid, or fewer
// blocks where S lanes of F rows at G lanes each fill fewer; a warp at
// least a lane.
template <class Kernel>
__host__ cudaError_t frontier_batch_grid(Kernel kernel, int* cache, int F, int G,
                                         int S, unsigned int* grid) {
  const cudaError_t err =
      frontier_grid(kernel, cache, static_cast<long long>(F) * S, G, grid);
  const unsigned int lanes = (S + kThreads / 32 - 1) / (kThreads / 32);
  if (*grid < lanes) *grid = lanes;
  return err;
}
