// Shared pieces of the min-plus kernels: launch shape and an exact
// fp32 atomic min on device memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

constexpr int kThreads = 256;

// Exact fp32 atomic min for NaN-free values.  Non-negative floats order
// like their int bits, so atomicMin on the int view is the float min;
// negative floats order inversely to their uint bits, and every
// negative float's uint view exceeds every non-negative one's, so
// atomicMax on the uint view is the float min.  min does not depend on
// the order of the updates, so the result is bit-identical to any
// sequential scatter-min.  Values at an address only ever decrease, so
// a stale plain read that is already <= v proves the update moot.
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
