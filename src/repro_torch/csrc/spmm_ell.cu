// ELL SpMM, the neighbour aggregation of the GNN layers.  Two entries:
// the row entry (spmm_ell_launch), the TPU function's own (R, d) rows,
//
//   sum:  out[r, :] = sum_s x[col[r, s], :] * wgt[r, s]   (s = 0 .. W-1 in order)
//   max:  out[r, :] = max of x[col[r, s], :] over the s with wgt[r, s] > 0,
//                     -inf where there is none; a NaN wins, as in jnp.max
//
// and the vertex sum (spmm_ell_vertex_launch, further below), GIN's
// neighbour sum straight into (n, d) over a neighbour ELL.
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

// Store a warp's chunk of 32 vectors (j = j0 + lane) of one output row
// that starts at `row`.  SHIFT: rows are as unaligned as those of x, so
// the warp stores 32 consecutive features a step, feature
// 4*j0 + 32i + lane from lane 8i + lane/4.  All lanes of the warp must
// call it: SHIFT shuffles.
template <int V, bool SHIFT>
__device__ __forceinline__ void store_chunk(float* __restrict__ row, int d, int j0,
                                            int lane, bool active, const float (&acc)[V]) {
  if constexpr (SHIFT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int src = 8 * i + lane / 4;
      const float a0 = __shfl_sync(0xffffffffu, acc[0], src);
      const float a1 = __shfl_sync(0xffffffffu, acc[1], src);
      const float a2 = __shfl_sync(0xffffffffu, acc[2], src);
      const float a3 = __shfl_sync(0xffffffffu, acc[3], src);
      const int k = lane & 3;
      const long long f = 4LL * j0 + 32 * i + lane;
      if (f < d) row[f] = k == 0 ? a0 : k == 1 ? a1 : k == 2 ? a2 : a3;
    }
  } else if (active) {
    store_vec<V>(row + static_cast<long long>(j0 + lane) * V, acc);
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
    store_chunk<V, SHIFT>(out + row * d, d, j0, lane, active, acc);
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

// ---------------------------------------------------------------------
// The vertex sum (spmm_ell_vertex_launch): GIN's neighbour sum written
// straight into (n, d),
//
//   out[v]    = (((+0 + rowsum(r0)) + rowsum(r1)) + ...)  over v's rows in order
//   rowsum(r) = sum over r's live slots s, in order, of x[col[r, s]] * wgt[r, s]
//
// each product and sum rounded: the row entry above followed by a
// combine of each vertex's rows in row order, the same bits from launch
// to launch (no atomics).  The neighbour ELL is built by a stable sort on
// the destination, so v's rows row_ptr[v] .. row_ptr[v+1]-1 are
// contiguous and all but the last are full: its live slots are the one
// run [row_ptr[v] W, row_ptr[v] W + deg[v]) of the flat (R W) col and wgt,
// and only that run is read.  Skipping the padding changes no bit: a
// padding slot of the row entry adds x * 0 = +0 (the zero row), and a sum
// that starts at +0 is never -0 in round-to-nearest, so acc + (+0) ==
// acc.  No zero row is read, so x needs none.  Masked edges (weight 0, a
// real col) are live slots and are multiplied: inf * 0 is NaN, as in the
// reference.
//
// 65.6% of the GIN graph's slots are padding, the median in-degree is 1
// (852,403 of its 2,097,152 vertices have none), and one vertex has
// 102,632 in-edges (1,604 rows).  A warp a vertex pays three dependent
// round trips to memory (row_ptr, then col, then x) for a median of one
// slot, and a long vertex keeps its warp for milliseconds.  So a warp
// walks a *stream*: the live slots of 32 segments, one a lane, taken in
// lane order as one run, 32 slots at a time.  A segment is a vertex of at
// most split_rows rows (its output row), or one row of a fatter vertex
// (a scratch row).  Lane k of each batch finds its segment by a binary
// search over the lanes' running slot counts, loads the slot's col and
// wgt (coalesced where segments are, evict-first: they are read once;
// the rows of x are what L2 should keep), and the warp then issues the
// gathers of kUnroll slots before it adds any of them, folding the row
// sum into the segment's sum at each of its W-slot boundaries and
// storing the segment's sum where the next one starts.  The fold kernel
// then adds each fat vertex's scratch rows in row order.  Segments with
// no live slot (a vertex without in-edges, or a scratch row past its
// vertex's last edge) get their +0 row from the same warp.

// What bounds the stream is gathers in flight: resident warps times
// kUnroll.  Measured on an H100 (scripts/spmm_ab.py, PERF.md): 4 gathers a
// lane at 6 resident blocks (40 registers) beat 8 at 4 blocks (64) by 12%
// at d = 64 and trail it by 1% at d = 100; 16 a lane, or 8 blocks, are
// slower still (scripts/spmm_ab.py builds those from an edited copy of
// this file).  The shifted instance (odd d >= 128) keeps its registers.
constexpr int kUnroll = 4;           // gathers a lane issues before its adds
constexpr int kVertexMinBlocks = 6;  // resident blocks asked of ptxas
constexpr int kFoldUnroll = 16;      // scratch rows a lane loads before its adds
constexpr int kNew = 1;              // stream marks: a segment starts
constexpr int kRowEnd = 2;           //   a row of the segment ends before this slot

// Features of row c of x (V a lane, vector j): load_vec, or load_shifted
// when SHIFT; zeros on an inactive lane.  All lanes must call it: SHIFT
// shuffles.
template <int V, bool SHIFT>
__device__ __forceinline__ void load_feat(const float* __restrict__ x, long long c, int d,
                                          int j, bool active, int lane, float (&v)[V]) {
  if constexpr (SHIFT) {
    load_shifted(x, c * d, j, d, lane, v);
  } else if (active) {
    load_vec<V>(x + c * d + static_cast<long long>(j) * V, v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.f;
  }
}

// One warp, feature chunk j0: lane i's segment is the flat slots [p0,
// p0 + live) (p0 a row start) and the output row dst + i d.  Writes
// every segment of live > 0: the sum, in order and from +0, of its row
// sums, each the sum of its live slots in order.  All lanes call it.
template <int V, bool SHIFT>
__device__ __forceinline__ void sum_segments(const float* __restrict__ x,
                                             const int* __restrict__ col,
                                             const float* __restrict__ wgt, long long p0,
                                             int live, float* __restrict__ dst, int W, int d,
                                             int j0, int lane) {
  const int nv = SHIFT ? (d + 3) / 4 : d / V;
  const int j = j0 + lane;
  const bool active = j < nv;
  int incl = live;  // slots of segments 0 .. lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const int excl = incl - live;
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  float acc[V], row[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = row[i] = 0.f;
  int cur = -1;  // the segment being summed
  for (int k0 = 0; k0 < total; k0 += 32) {
    const int k = k0 + lane;  // this lane's slot of the stream
    int seg = 0;              // lanes whose running count is <= k: k's segment
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(0xffffffffu, incl, seg + step - 1) <= k) seg += step;
    }
    seg &= 31;  // past the stream's end: any segment, unused
    const int kin = k - __shfl_sync(0xffffffffu, excl, seg);
    const long long p = __shfl_sync(0xffffffffu, p0, seg) + kin;
    const int n = total - k0 < 32 ? total - k0 : 32;
    int my_col = 0, mark = 0;
    float my_w = 0.f;
    if (lane < n) {
      my_col = __ldcs(col + p);
      my_w = __ldcs(wgt + p);
      mark = kin == 0 ? (seg << 2) | kNew : kin % W == 0 ? kRowEnd : 0;
    }
    for (int t0 = 0; t0 < n; t0 += kUnroll) {
      float v[kUnroll][V];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = __shfl_sync(0xffffffffu, my_col, (t0 + u) & 31);
        w[u] = __shfl_sync(0xffffffffu, my_w, (t0 + u) & 31);
        if (t0 + u < n) load_feat<V, SHIFT>(x, c, d, j, active, lane, v[u]);  // uniform
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u >= n) break;
        const int mk = __shfl_sync(0xffffffffu, mark, (t0 + u) & 31);
        if (mk != 0) {  // fold the row that ends here into its segment's sum
#pragma unroll
          for (int i = 0; i < V; ++i) {
            acc[i] = __fadd_rn(acc[i], row[i]);
            row[i] = 0.f;
          }
        }
        if (mk & kNew) {  // the previous segment is done
          if (cur >= 0) store_chunk<V, SHIFT>(dst + static_cast<long long>(cur) * d, d, j0,
                                              lane, active, acc);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = 0.f;
          cur = mk >> 2;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) row[i] = __fadd_rn(row[i], __fmul_rn(v[u][i], w[u]));
      }
    }
  }
  if (cur >= 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], row[i]);
    store_chunk<V, SHIFT>(dst + static_cast<long long>(cur) * d, d, j0, lane, active, acc);
  }
}

// Grid x: fat_blocks blocks whose warps each take 32 rows of fat
// vertices (fat_row, fat_live: the ELL row and live slots of each
// scratch row) into scratch, then blocks whose warps each take 32
// vertices into out, a vertex of more than split_rows rows being left
// to vertex_fold_kernel.  Grid y: feature chunks of 32 vectors, as the
// row entry's.
template <int V, bool SHIFT>
__global__ void __launch_bounds__(kBlockThreads, SHIFT ? 1 : kVertexMinBlocks)
vertex_sum_kernel(const float* __restrict__ x, const int* __restrict__ col,
                  const float* __restrict__ wgt, const long long* __restrict__ row_ptr,
                  const int* __restrict__ deg, const long long* __restrict__ fat_row,
                  const int* __restrict__ fat_live, float* __restrict__ scratch,
                  float* __restrict__ out, int n, int W, int d, int split_rows,
                  int n_fat_rows, long long fat_blocks) {
  const int lane = threadIdx.x & 31;
  const long long block = blockIdx.x;
  long long p0 = 0;
  int live = 0;
  bool empty = false;  // a segment without live slots: +0
  float* dst;
  if (block < fat_blocks) {
    const long long i0 = (block * kRowsPerBlock + (threadIdx.x >> 5)) * 32;
    if (i0 >= n_fat_rows) return;  // uniform across the warp
    if (i0 + lane < n_fat_rows) {
      p0 = fat_row[i0 + lane] * W;
      live = fat_live[i0 + lane];
      empty = live == 0;
    }
    dst = scratch + i0 * d;
  } else {
    const long long v0 = ((block - fat_blocks) * kRowsPerBlock + (threadIdx.x >> 5)) * 32;
    if (v0 >= n) return;
    const long long v = v0 + lane;
    if (v < n) {
      const long long r0 = row_ptr[v];
      if (row_ptr[v + 1] - r0 <= split_rows) {  // else fat: folded later
        p0 = r0 * W;
        live = deg[v];
        empty = live == 0;
      }
    }
    dst = out + v0 * d;
  }
  const unsigned empties = __ballot_sync(0xffffffffu, empty);
  const int nv = SHIFT ? (d + 3) / 4 : d / V;
  const int step = 32 * static_cast<int>(gridDim.y);
  for (int j0 = 32 * static_cast<int>(blockIdx.y); j0 < nv; j0 += step) {
    float zero[V];
#pragma unroll
    for (int i = 0; i < V; ++i) zero[i] = 0.f;
    for (unsigned e = empties; e != 0; e &= e - 1) {
      store_chunk<V, SHIFT>(dst + static_cast<long long>(__ffs(e) - 1) * d, d, j0, lane,
                            j0 + lane < nv, zero);
    }
    sum_segments<V, SHIFT>(x, col, wgt, p0, live, dst, W, d, j0, lane);
  }
}

// One warp a fat vertex (fat_vertex[f]): the sum, in row order and
// starting at +0, of its row sums, scratch rows fat_start[f] ..
// fat_start[f+1]-1.
template <int V, bool SHIFT>
__global__ void __launch_bounds__(kBlockThreads)
vertex_fold_kernel(const float* __restrict__ scratch, const int* __restrict__ fat_vertex,
                   const long long* __restrict__ fat_start, float* __restrict__ out,
                   int n_fat, int d) {
  const int lane = threadIdx.x & 31;
  const long long f = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (f >= n_fat) return;  // uniform across the warp
  const long long s0 = fat_start[f], s1 = fat_start[f + 1];
  float* dst = out + static_cast<long long>(fat_vertex[f]) * d;
  const int nv = SHIFT ? (d + 3) / 4 : d / V;
  const int step = 32 * static_cast<int>(gridDim.y);
  for (int j0 = 32 * static_cast<int>(blockIdx.y); j0 < nv; j0 += step) {
    const int j = j0 + lane;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (long long s = s0; s < s1; s += kFoldUnroll) {
      float v[kFoldUnroll][V];
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        if (s + u < s1) load_feat<V, SHIFT>(scratch, s + u, d, j, j < nv, lane, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        if (s + u >= s1) break;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], v[u][i]);
      }
    }
    store_chunk<V, SHIFT>(dst, d, j0, lane, j < nv, acc);
  }
}

struct VertexArgs {
  const float* x;
  const int* col;
  const float* wgt;
  const long long* row_ptr;
  const int* deg;
  const long long* fat_row;
  const int* fat_live;
  const int* fat_vertex;
  const long long* fat_start;
  float* scratch;
  float* out;
  int n, W, d, split_rows, n_fat_rows, n_fat;
};

template <int V, bool SHIFT>
void launch_vertex(const VertexArgs& a, int chunks, cudaStream_t stream) {
  constexpr long long kPerBlock = 32 * kRowsPerBlock;  // segments: 32 a warp
  const long long fat_blocks = (static_cast<long long>(a.n_fat_rows) + kPerBlock - 1) /
                               kPerBlock;
  const long long vertex_blocks = (static_cast<long long>(a.n) + kPerBlock - 1) / kPerBlock;
  const dim3 grid(static_cast<unsigned int>(fat_blocks + vertex_blocks),
                  static_cast<unsigned int>(chunks));
  vertex_sum_kernel<V, SHIFT><<<grid, kBlockThreads, 0, stream>>>(
      a.x, a.col, a.wgt, a.row_ptr, a.deg, a.fat_row, a.fat_live, a.scratch, a.out, a.n,
      a.W, a.d, a.split_rows, a.n_fat_rows, fat_blocks);
  if (a.n_fat == 0) return;
  const dim3 fold(static_cast<unsigned int>((a.n_fat + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned int>(chunks));
  vertex_fold_kernel<V, SHIFT><<<fold, kBlockThreads, 0, stream>>>(
      a.scratch, a.fat_vertex, a.fat_start, a.out, a.n_fat, a.d);
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

// The vertex sum.  x (n_x, d) f32; col (R, W) int32 and wgt (R, W) f32,
// whose live slots (below) hold col in [0, n_x); row_ptr (n+1,) int64,
// vertex v's rows row_ptr[v] .. row_ptr[v+1]-1 (row_ptr[0] = 0,
// row_ptr[n] = R); deg (n,) int32, v's live slots, the first deg[v] of
// its rows' flat slots (deg[v] <= its rows times W).  The fat vertices,
// those of more than split_rows rows: fat_vertex (n_fat,) int32 and
// fat_start (n_fat+1,) int64, the first of each one's scratch rows;
// fat_row (n_fat_rows,) int64 and fat_live (n_fat_rows,) int32, the ELL
// row and live slots of each scratch row.  scratch (n_fat_rows, d) f32,
// out (n, d) f32, fully written.  All contiguous.
extern "C" int spmm_ell_vertex_launch(const float* x, const int* col, const float* wgt,
                                      const long long* row_ptr, const int* deg,
                                      const long long* fat_row, const int* fat_live,
                                      const int* fat_vertex, const long long* fat_start,
                                      float* scratch, float* out, int n, int W, int d,
                                      int split_rows, int n_fat_rows, int n_fat,
                                      cudaStream_t stream) {
  if (static_cast<long long>(n) * d == 0) return 0;
  const VertexArgs a{x, col, wgt, row_ptr, deg, fat_row, fat_live, fat_vertex, fat_start,
                     scratch, out, n, W, d, split_rows, n_fat_rows, n_fat};
  const int v = vector_width(x, out, d);
  const bool shift = v == 1 && d >= 4 * 32 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nv = shift ? (d + 3) / 4 : d / v;
  const int chunks = (nv + 31) / 32 < 65535 ? (nv + 31) / 32 : 65535;
  if (shift) {
    launch_vertex<4, true>(a, chunks, stream);
  } else if (v == 4) {
    launch_vertex<4, false>(a, chunks, stream);
  } else if (v == 2) {
    launch_vertex<2, false>(a, chunks, stream);
  } else {
    launch_vertex<1, false>(a, chunks, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
