// Other designs of the two SSSP frontier kernels, and the floor their
// atomics set, built and timed only by scripts/frontier_ab.py against
// the library's kernels (src/repro_torch/csrc/fused_superstep.cu and
// relax_push.cu) on the same frontier.  Each is bit-identical to the
// plain versions; frontier_ab.py checks that before it times them.
//
//   *_bulk_launch     a producer warp streams the next rows' 256-byte
//                     col/wgt strips into a 4-stage shared-memory ring
//                     with 1-D cp.async.bulk copies, completed on an
//                     mbarrier (the counterpart of the TPU kernel's
//                     scalar-prefetched strip DMA); four consumer warps
//                     relax from shared memory.  W % 4 == 0, 16-byte
//                     aligned bases.
//   fused_superstep_combine_launch
//                     the library's design, but equal destinations in a
//                     warp first take their min by __match_any_sync and
//                     __reduce_min_sync, one atomic a group.  VEC 4 only.
//   atomic_floor_launch
//                     the same pre-checked atomic mins on the same
//                     (column, value) pairs, listed flat: no strip loads.
#include <stdint.h>

#include "minplus.cuh"

namespace {

// ---- mbarrier and bulk-copy primitives (PTX) ---------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from 16-byte aligned global src to shared dst
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- the bulk-copy ring ------------------------------------------------

constexpr int kRows = 32;  // rows a stage, one a producer lane
constexpr int kStages = 4;
constexpr int kConsumerWarps = 4;
constexpr int kRowsPerWarp = kRows / kConsumerWarps;
constexpr int kBulkThreads = 32 * (1 + kConsumerWarps);

__host__ __device__ constexpr size_t bulk_smem(int W, bool fused) {
  return 2 * kStages * sizeof(uint64_t) + kStages * kRows * sizeof(int) +
         static_cast<size_t>(kStages) * kRows * W * 4 * (fused ? 2 : 1);
}

template <bool FUSED>
__global__ void __launch_bounds__(kBulkThreads) frontier_bulk_kernel(
    const float* __restrict__ dist, const int* __restrict__ row_idx,
    const int* __restrict__ count, const int* __restrict__ row_src,
    const int* __restrict__ col, const float* __restrict__ wgt,
    float* __restrict__ out, int F, int R, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  int* rid = reinterpret_cast<int*>(empty + kStages);
  float* wstrip = reinterpret_cast<float*>(rid + kStages * kRows);  // [stage][row][W]
  int* cstrip = reinterpret_cast<int*>(wstrip + kStages * kRows * W);
  const int live = live_rows(count, F);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kRows);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long chunks = (static_cast<long long>(live) + kRows - 1) / kRows;
  const unsigned row_bytes = static_cast<unsigned>(W) * 4;
  if (warp == 0) {  // producer: one row a lane, one row id ahead
    long long k = blockIdx.x;
    long long f = k * kRows + lane;
    int r_next = k < chunks && f < live ? clip_row(__ldg(row_idx + f), R) : 0;
    for (int i = 0; k < chunks; ++i, k += gridDim.x) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty + s, ((i / kStages) - 1) & 1);
      f = k * kRows + lane;
      const int r = r_next;
      const long long f2 = (k + gridDim.x) * kRows + lane;
      r_next = k + gridDim.x < chunks && f2 < live ? clip_row(__ldg(row_idx + f2), R) : 0;
      rid[s * kRows + lane] = r;
      const long long left = live - k * kRows;
      const unsigned n = static_cast<unsigned>(left < kRows ? left : kRows);
      if (lane == 0) {
        mbar_expect_tx(full + s, n * row_bytes * (FUSED ? 2 : 1));
      } else {
        mbar_arrive(full + s);
      }
      if (f < live) {
        const long long e = static_cast<long long>(r) * W;
        bulk_copy(wstrip + (s * kRows + lane) * W, wgt + e, row_bytes, full + s);
        if (FUSED) bulk_copy(cstrip + (s * kRows + lane) * W, col + e, row_bytes, full + s);
      }
    }
  } else {  // consumers: kRowsPerWarp rows of each stage a warp
    const int cw = warp - 1;
    const int G = group_lanes(W, 4);
    const int rpw = 32 / G;
    const int nchunk = W / 4;
    long long k = blockIdx.x;
    for (int i = 0; k < chunks; ++i, k += gridDim.x) {
      const int s = i % kStages;
      mbar_wait(full + s, (i / kStages) & 1);
      const int jl = cw * kRowsPerWarp + lane % kRowsPerWarp;
      float dl = 0.0f;
      if (lane < kRowsPerWarp && k * kRows + jl < live)
        dl = __ldg(dist + __ldg(row_src + rid[s * kRows + jl]));
      for (int t = 0; t < kRowsPerWarp; t += rpw) {
        const int tj = t + lane / G;
        const float d = __shfl_sync(kFullMask, dl, tj % kRowsPerWarp);
        const int j = cw * kRowsPerWarp + tj;
        const long long f = k * kRows + j;
        if (tj >= kRowsPerWarp || f >= live) continue;
        const float4* ws = reinterpret_cast<const float4*>(wstrip + (s * kRows + j) * W);
        const int4* cs = reinterpret_cast<const int4*>(cstrip + (s * kRows + j) * W);
        for (int c = lane % G; c < nchunk; c += G) {
          const float4 v = add_chunk(d, ws[c]);
          if (FUSED) {
            if (v.x == INFINITY && v.y == INFINITY && v.z == INFINITY && v.w == INFINITY)
              continue;
            const int4 cc = cs[c];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (elem(v, q) != INFINITY) atomic_min_f32(out + elem(cc, q), elem(v, q));
          } else {
            *reinterpret_cast<float4*>(out + f * W + 4 * c) = v;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
  }
  if (!FUSED) {  // rows past count: +inf, streamed past the caches
    float4* tail = reinterpret_cast<float4*>(out + static_cast<long long>(live) * W);
    const long long n = static_cast<long long>(F - live) * W / 4;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x)
      __stcs(tail + i, inf_chunk<4>());
  }
}

template <bool FUSED>
int launch_bulk(const float* dist, const int* row_idx, const int* count, const int* row_src,
                const int* col, const float* wgt, float* out, int F, int R, int W,
                cudaStream_t stream) {
  static int cache[kMaxDevices];
  static int cached_w = -1;
  const size_t smem = bulk_smem(W, FUSED);
  if (W != cached_w) {  // the grid depends on W through the ring's size
    const cudaError_t err = cudaFuncSetAttribute(
        frontier_bulk_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int& c : cache) c = 0;
    cached_w = W;
  }
  int blocks = 0;
  const cudaError_t err =
      persistent_blocks(frontier_bulk_kernel<FUSED>, kBulkThreads, smem, cache, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(F) + kRows - 1) / kRows;
  const unsigned grid = static_cast<unsigned>(need < blocks ? need : blocks);
  frontier_bulk_kernel<FUSED><<<grid, kBulkThreads, smem, stream>>>(
      dist, row_idx, count, row_src, col, wgt, out, F, R, W);
  return static_cast<int>(cudaGetLastError());
}

// ---- the warp combine --------------------------------------------------

// Signed-int view of a NaN-free float that orders like the float.
__device__ __forceinline__ int ordered(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

struct CombineOp {
  const int* __restrict__ col;
  const float* __restrict__ wgt;
  float* __restrict__ out;

  __device__ __forceinline__ float4 load(long long e, bool ok) const {
    return ok ? load_chunk<4>(wgt + e) : inf_chunk<4>();
  }

  __device__ __forceinline__ void apply(long long, long long e, float d, const float4& w,
                                        bool ok) const {
    const float4 v = add_chunk(d, w);
    const bool any = ok && (v.x != INFINITY || v.y != INFINITY || v.z != INFINITY ||
                            v.w != INFINITY);
    const int4 c = any ? load_chunk<4>(col + e) : make_int4(0, 0, 0, 0);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool mine = any && elem(v, q) != INFINITY;
      const int key = mine ? elem(c, q) : -1 - lane;  // a lane of its own
      const unsigned group = __match_any_sync(kFullMask, key);
      const int m = __reduce_min_sync(group, mine ? ordered(elem(v, q)) : 0x7fffffff);
      if (mine && lane == __ffs(group) - 1) atomic_min_f32(out + key, unordered(m));
    }
  }
};

__global__ void __launch_bounds__(kThreads) fused_superstep_combine_kernel(
    const float* __restrict__ dist, const int* __restrict__ row_idx,
    const int* __restrict__ count, const int* __restrict__ row_src,
    const int* __restrict__ col, const float* __restrict__ wgt,
    float* __restrict__ out, int F, int R, int W, int G) {
  CombineOp op{col, wgt, out};
  walk_frontier<4>(dist, row_idx, row_src, live_rows(count, F), R, W, G, op, grid_warp(),
                   grid_warps());
}

__global__ void atomic_floor_kernel(const int* __restrict__ cols,
                                    const float* __restrict__ vals,
                                    float* __restrict__ out, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    atomic_min_f32(out + __ldg(cols + i), __ldg(vals + i));
}

}  // namespace

extern "C" int fused_superstep_bulk_launch(const float* dist, const int* row_idx,
                                           const int* count, const int* row_src,
                                           const int* col, const float* wgt, float* out,
                                           int F, int R, int W, cudaStream_t stream) {
  if (static_cast<long long>(F) * W == 0) return 0;
  return launch_bulk<true>(dist, row_idx, count, row_src, col, wgt, out, F, R, W, stream);
}

extern "C" int relax_push_gather_bulk_launch(const float* dist, const int* row_idx,
                                             const int* count, const int* row_src,
                                             const float* wgt, float* out, int F, int R,
                                             int W, cudaStream_t stream) {
  if (static_cast<long long>(F) * W == 0) return 0;
  return launch_bulk<false>(dist, row_idx, count, row_src, nullptr, wgt, out, F, R, W,
                            stream);
}

extern "C" int fused_superstep_combine_launch(const float* dist, const int* row_idx,
                                              const int* count, const int* row_src,
                                              const int* col, const float* wgt, float* out,
                                              int F, int R, int W, cudaStream_t stream) {
  if (static_cast<long long>(F) * W == 0) return 0;
  static int cache[kMaxDevices];
  const int G = group_lanes(W, 4);
  unsigned int grid = 0;
  const cudaError_t err = frontier_grid(fused_superstep_combine_kernel, cache, F, G, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_superstep_combine_kernel<<<grid, kThreads, 0, stream>>>(
      dist, row_idx, count, row_src, col, wgt, out, F, R, W, G);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int atomic_floor_launch(const int* cols, const float* vals, float* out,
                                   long long n, cudaStream_t stream) {
  if (n == 0) return 0;
  static int cache[kMaxDevices];
  int blocks = 0;
  const cudaError_t err =
      persistent_blocks(atomic_floor_kernel, kThreads, 0, cache, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (n + kThreads - 1) / kThreads;
  atomic_floor_kernel<<<static_cast<unsigned>(need < blocks ? need : blocks), kThreads, 0,
                        stream>>>(cols, vals, out, n);
  return static_cast<int>(cudaGetLastError());
}
