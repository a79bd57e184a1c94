// The open-addressing set that candidates.cu (K1/K2) and scalar_probe.cu
// use to find the distinct values of a batch: a table of 2^L slots keyed by
// the value (>= 0; -1 marks an empty slot), a value's home slot the top L
// bits of a multiplicative hash, collisions resolved by linear probing. The
// callers keep the table at most half full, so a probe ends. Here: the
// hash, the probe, the warp's vote on who bids, and the table's clear.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

#include "block_ops.cuh"

namespace {

// Home slot of `key` in a table of 2^(32 - shift) slots.
__device__ __forceinline__ int hash_slot(int key, int shift) {
  return (int)(((uint32_t)key * 0x9E3779B1u) >> shift);
}

// Claims the slot of `key` (>= 0) by linear probing from slot s and
// returns it: the first slot that was empty or already held the key.
// `key_at(s)` is the address of slot s's key. (K1/K2 bid one key at a
// time; claim_slots below with N = 1 costs K2's global instance a spill.)
template <typename KeyAt>
__device__ __forceinline__ int claim_slot(KeyAt key_at, int mask, int s,
                                          int key) {
  for (;;) {
    const int prev = atomicCAS(key_at(s), -1, key);
    if (prev == -1 || prev == key) return s;
    s = (s + 1) & mask;
  }
}

// The same for the keys of a thread's N items at once: each item e
// in `todo` holds key[e] >= 0, whose atomicCAS(key_at(slot[e]), -1, key[e])
// returned prev[e]. Every item that met another key walks on to the next
// slot, one atomicCAS a round for all of them together, so that a thread's
// probes overlap. On return slot[e] is key[e]'s slot; the result is the
// mask of items whose atomicCAS found their slot empty. `key_at(s)` is the
// address of slot s's key.
template <int N, typename KeyAt>
__device__ __forceinline__ unsigned claim_slots(KeyAt key_at, int mask,
                                             int (&slot)[N], int (&prev)[N],
                                             const int (&key)[N],
                                             unsigned todo) {
  unsigned fresh = 0;
  while (todo) {
    unsigned next = 0;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (!((todo >> e) & 1u)) continue;
      if (prev[e] == -1)
        fresh |= 1u << e;
      else if (prev[e] != key[e])
        next |= 1u << e;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (!((next >> e) & 1u)) continue;
      slot[e] = (slot[e] + 1) & mask;
      prev[e] = atomicCAS(key_at(slot[e]), -1, key[e]);
    }
    todo = next;
  }
  return fresh;
}

// Whether this lane bids for `key` (-1: none) on behalf of its warp: the
// lowest lane that holds the key, which has the warp's least position.
// Every lane of the warp calls it.
__device__ __forceinline__ bool warp_bidder(int key) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  return key >= 0 && (__ffs(peers) - 1) == (int)(threadIdx.x & 31);
}

// Sets `count` 16-byte words of `p` to `v`, the kBlock threads in turn.
template <int kBlock = kThreads>
__device__ __forceinline__ void block_fill(int4* p, int count, int4 v) {
  for (int i = threadIdx.x; i < count; i += kBlock) p[i] = v;
}

}  // namespace
