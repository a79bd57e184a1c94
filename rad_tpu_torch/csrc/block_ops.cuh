// Block-wide helpers shared by the one-block kernels of candidates.cu and
// scalar_probe.cu: a block of kThreads threads, an exclusive count in thread
// order (the ordered compaction both files build on) and a sum.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // 32: one warp scans the warp totals

// Exclusive count of `flag` over the block's threads in thread order;
// *total receives the block's sum. Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_count(bool flag, int* sums,
                                                     int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) sums[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int v = sums[lane];
    int inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += t;
    }
    sums[lane] = inc - v;
    if (lane == 31) sums[kWarps] = inc;
  }
  __syncthreads();
  const int out = sums[warp] + __popc(ballot & ((1u << lane) - 1u));
  *total = sums[kWarps];
  __syncthreads();  // sums is rewritten by the next call
  return out;
}

// Sum of `v` over the block's threads, returned to every thread.
// `warp_sums` holds kWarps values of T in shared memory; every thread of
// the block must call it. The order is fixed (a shuffle tree inside each
// warp, then over the warp totals), so a floating-point sum repeats.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  T total = warp_sums[lane];  // kWarps == 32: one value per lane
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_down_sync(0xffffffffu, total, off);
  total = __shfl_sync(0xffffffffu, total, 0);
  __syncthreads();  // warp_sums is rewritten by the next call
  return total;
}

}  // namespace
