// Block-wide helpers shared by the kernels of candidates.cu and
// scalar_probe.cu: a block of kThreads threads, an exclusive count or sum in
// thread order (the ordered compaction both files build on) and a sum.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // K1/K2's block
constexpr int kWarps = kThreads / 32;

// Every helper takes the block's size kBlock (a multiple of 32 up to 1024:
// one warp scans or sums the warp totals) and must be called by every
// thread of the block.

// Inclusive sum of `v` over the lanes of a warp, in lane order.
__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// The middle of a block-wide exclusive scan: on entry sums[w] is warp w's
// total; on return it is the sum of the warps before w, and
// sums[kBlock / 32] the block's total.
template <int kBlock = kThreads>
__device__ __forceinline__ void scan_warp_totals(int* sums) {
  constexpr int kBlockWarps = kBlock / 32;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int v = threadIdx.x < kBlockWarps ? sums[threadIdx.x] : 0;
    const int inc = warp_inclusive_sum(v);
    if (threadIdx.x < kBlockWarps) sums[threadIdx.x] = inc - v;
    if (threadIdx.x == 31) sums[kBlockWarps] = inc;
  }
  __syncthreads();
}

// Exclusive count of `flag` over the block's threads in thread order;
// *total receives the block's sum.
template <int kBlock = kThreads>
__device__ __forceinline__ int block_exclusive_count(bool flag, int* sums,
                                                     int* total) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) sums[threadIdx.x >> 5] = __popc(ballot);
  scan_warp_totals<kBlock>(sums);
  const int out = sums[threadIdx.x >> 5] + __popc(ballot & ((1u << lane) - 1u));
  *total = sums[kBlock / 32];
  __syncthreads();  // sums is rewritten by the next call
  return out;
}

// Exclusive sum of `v` (>= 0) over the block's threads in thread order;
// *total receives the block's sum.
template <int kBlock = kThreads>
__device__ __forceinline__ int block_exclusive_sum(int v, int* sums,
                                                   int* total) {
  const int inc = warp_inclusive_sum(v);
  if ((threadIdx.x & 31) == 31) sums[threadIdx.x >> 5] = inc;
  scan_warp_totals<kBlock>(sums);
  const int out = sums[threadIdx.x >> 5] + inc - v;
  *total = sums[kBlock / 32];
  __syncthreads();  // sums is rewritten by the next call
  return out;
}

// Sum of `v` over the block's threads, returned to every thread.
// `warp_sums` holds kBlock / 32 values of T in shared memory. The order is
// fixed (a shuffle tree inside each warp, then over the warp totals), so a
// floating-point sum repeats.
template <int kBlock = kThreads, typename T>
__device__ __forceinline__ T block_sum(T v, T* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  T total = lane < kBlock / 32 ? warp_sums[lane] : T(0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_down_sync(0xffffffffu, total, off);
  total = __shfl_sync(0xffffffffu, total, 0);
  __syncthreads();  // warp_sums is rewritten by the next call
  return total;
}

}  // namespace
