// The three per-candidate probes of the scalar-loop microbenchmark for
// NVIDIA Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes).
//
// Replaces the three Pallas TPU kernels of benchmarks/bench_scalar_probe.py
// (the closures gather_kernel, checkset_kernel and chain_kernel of main(),
// launched at :118, :125 and :133):
//   * rad_scalar_gather    <- gather:   sum of tab[idx[i]] (int32, wrapping);
//   * rad_scalar_checkset  <- checkset: how many idx[i] found their bit of
//     the bitmap clear at their turn, bits set in a scratch copy, so a
//     duplicate id counts once: the number of distinct ids whose bit is
//     clear;
//   * rad_scalar_chain     <- chain: the whole per-candidate work of one
//     traversal step: the scored test with a compacted emit of the unscored
//     ids in candidate order (duplicates included), the enqueue
//     test-and-set on a scratch copy, and the score lookup summed over the
//     distinct ids whose enqueue bit was clear.
//
// Bound. Not bytes: at k = 8,192 over n = 2^20 a call moves ~0.3 MB (the
// ids, one 32-byte sector per distinct bitmap or score sector touched, the
// emit), ~0.1 us at 3.35 TB/s, all of it resident in the 50 MB L2. What a
// call waits on is latency (each pass is one dependent round trip to L2)
// and the launch. The TPU kernels are serial loops with a VMEM scratch
// copy of the bitmap, so that the loop can test-and-set without writing its
// input; the function needs only "distinct ids whose bit is clear".
//
// Design:
//   * gather: each thread holds up to kItems consecutive ids of a round
//     (two 16-byte loads) and issues every table load before it adds any;
//     the CTA's uint32 sum goes to rank 0 through distributed shared
//     memory (cluster_total), which stores the one int32: no global atomic
//     and no memset launch. uint32 addition wraps as the int32 sum does and
//     does not depend on the order, so the result is the serial loop's.
//   * No bitmap copy. The bitmaps are read in place and read-only (__ldg),
//     one 32-bit word per candidate: nothing sized by n is read, written or
//     allocated.
//   * "Distinct" from a set keyed by the id and sized by k (dedup.cuh, the
//     hash, probe and vote of K1/K2 in candidates.cu): 2^ceil(log2 4k)
//     slots of one 32-bit key, at most a quarter full (a half-full set
//     costs more second probes, each a round trip to another SM, than its
//     clear saves). The atomicCAS that finds a key's slot empty counts the
//     id and, in chain, loads scores[j]; __match_any_sync lets one lane of
//     a warp bid for a repeated id.
//   * Blocks of 512 threads; a thread holds up to kItems = 8 consecutive
//     candidates of a round (as many as the CTA's share needs, so that no
//     warp votes for candidates it does not hold; eight are two 16-byte
//     loads) and issues all their loads of a pass before it uses any: the
//     ids, then every bitmap word (chain: scored and enq together), then
//     the first atomicCAS of every bid, then the items that met another key
//     probe on together (dedup.cuh), then the scores. chain's emit is one
//     block scan of per-thread counts, with a carry from round to round.
//     The set's clear overlaps the first round's loads, the score loads
//     the emit's scan.
//   * The candidates spread over a thread-block cluster of kCluster CTAs
//     (cudaLaunchKernelEx): rank r takes the r-th contiguous share of a
//     round, so 8 SMs issue the random accesses instead of one. The set is
//     partitioned over the CTAs' shared memory by the hash's top bits,
//     reached through distributed shared memory (map_shared_rank); a probe
//     runs on across owners, so a skewed share cannot fill. The emit's
//     carry across CTAs is each CTA's total, stored into every CTA's
//     shared memory before a cluster.sync; the float64 partial sums go to
//     rank 0 and are added in rank order. A final cluster.sync keeps every
//     CTA's shared memory alive until the last remote access.
//   * Above the shared memory (k > 8,192 at kCluster 1, k > 65,536 at 8)
//     the set is a per-call global buffer that the wrapper allocates
//     (kGlobal).
//   * The wrapper picks kCluster from k (candidate_ops._probe_cluster): one
//     CTA below 2,048 candidates, eight from there on; both instances
//     compute the same result.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 2
// and python -m rad_tpu_torch.bench_scalar_probe --split --clusters, in
// turns with one-block kernels that copy the bitmap into shared memory,
// as the TPU kernels do into VMEM): at k = 8,192 over n = 2^20, device
// time (CUDA-graph replay) chain 9.9-10.6 us against 14.6-14.9, checkset
// 6.9-7.0 us against 4.8-5.0. There the copy is one coalesced 128 KB
// stream into one SM and every test-and-set a local shared atomic, while
// these kernels pay a cluster launch, random word reads from L2 and
// atomics in other SMs' shared memory; at n = 2^24 the copy goes through a
// 2 MB global buffer and takes 48.5 / 59.9-60.4 us (checkset / chain)
// against 7.4-7.5 / 9.9-10.1. On one CTA at k = 8,192: 15.1 / 23.6-24.0
// us. The host's path is 11-15 us a call (checkset) and 27-40 us (chain,
// four output allocations), so a caller's eager time, 0.013-0.018 and
// 0.029-0.049 ms, is the host's more than the kernel's. gather at k =
// 8,192 over n = 2^20, in turns with the one-block loop it replaced
// (--split): device time 3.2 us against 6.2; eager and host time are the
// host's launch path and did not separate (0.013-0.023 ms, 11-21 us a
// call on either side). On one CTA it takes 6.1-6.2 us; at k = 1,024 one
// CTA is faster (2.3-2.4 against 2.6-2.9 us) and at 2,048 the two tie
// (--clusters).
//
// The score sum. The TPU loop adds f32 scores in candidate order; a parallel
// sum cannot repeat that rounding. The kernel adds in float64 (per thread,
// a fixed shuffle tree per CTA, the CTAs in rank order) and rounds once to
// f32, which is within one f32 unit in the last place of the exactly
// rounded sum; the plain twin does the same, so the two agree to one ulp,
// and both lie within k * 2^-24 * sum of the TPU loop's f32 result.
//
// Contract (checked by the Python wrapper): idx int32 [k], tables int32 or
// f32 of n entries, bitmaps int32 of n / 32 words (bit b of word w is id
// 32 w + b), n a multiple of 32, all contiguous on one device. Ids outside
// [0, n) are skipped; the bitmaps are not written. `set` is null (the set
// in shared memory, 4 << log2_slots bytes over the cluster) or a buffer of
// 1 << log2_slots int32; `cluster` is 1 or 8; 2^log2_slots >= 2 * max(k, 1)
// (the wrapper gives 4k) and at least 4 slots a CTA. Each entry point
// launches on the given stream, does not synchronise, and returns the
// launch's CUDA error.

#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "dedup.cuh"
#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

// the probes' block: 512 threads (fewer warps to launch and to
// pass each barrier than 1,024; two candidates a thread at k = 8,192 on 8
// CTAs)
constexpr int kBlock = 512;
constexpr int kBlockWarps = kBlock / 32;
constexpr int kItems = 8;                // candidates a thread holds a round
constexpr int kRound = kItems * kBlock;  // at most 4,096 a CTA a round
constexpr int kMaxCluster = 8;           // the portable cluster size

__host__ __device__ constexpr int log2_of(int c) {
  return c <= 1 ? 0 : 1 + log2_of(c / 2);
}

// The set of distinct ids: 2^log2_slots keys, CTA r of the cluster owning
// slots [r << local_log2, (r + 1) << local_log2) in its dynamic shared
// memory, or all of them in a global buffer (kGlobal).
template <int kCluster, bool kGlobal>
struct IdSet {
  int* keys;  // this CTA's slots, or the whole global table
  int local_log2, mask, shift;

  __device__ __forceinline__ IdSet(int* global_set, int log2_slots)
      : local_log2(log2_slots - log2_of(kCluster)),
        mask((1 << log2_slots) - 1),
        shift(32 - log2_slots) {
    if constexpr (kGlobal) {
      keys = global_set;
    } else {
      extern __shared__ __align__(16) int set_slots[];
      keys = set_slots;
    }
  }

  // Address of slot s's key: local, global, or in another CTA's shared
  // memory.
  __device__ __forceinline__ int* at(int s) const {
    if constexpr (kGlobal || kCluster == 1) {
      return keys + s;
    } else {
      return cg::this_cluster().map_shared_rank(
          keys + (s & ((1 << local_log2) - 1)), s >> local_log2);
    }
  }

  // Empties this CTA's share of the slots.
  __device__ __forceinline__ void clear() const {
    int* mine = kGlobal ? keys + (blockIdx.x << local_log2) : keys;
    block_fill<kBlock>(reinterpret_cast<int4*>(mine), (1 << local_log2) / 4,
                       make_int4(-1, -1, -1, -1));
  }
};

template <int kCluster>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kCluster == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// This thread's part of a round of the cluster from candidate `base`: the
// CTA's share is an even part of what is left (a multiple of kItems, at
// most kRound), and a thread takes `items` consecutive candidates of it,
// [first, last); `items` is the same in every thread of the cluster.
struct Round {
  int first, last, items, step;
};

template <int kCluster>
__device__ __forceinline__ Round round_at(int base, int k, int rank) {
  const int left = (k - base + kCluster - 1) / kCluster;
  const int share = min(kRound, (left + kItems - 1) / kItems * kItems);
  const int start = base + rank * share;
  Round r;
  r.items = (share + kBlock - 1) / kBlock;
  r.first = start + r.items * threadIdx.x;
  r.last = min(r.first + r.items, min(start + share, k));
  r.step = kCluster * share;
  return r;
}

// This thread's candidates of a round: id[e] = idx[first + e] below
// `last`, else -1. Two 16-byte loads when the thread holds kItems and idx
// is 16-byte aligned (`first` is then a multiple of kItems).
__device__ __forceinline__ void load_ids(const int* __restrict__ idx,
                                         bool aligned, const Round& r,
                                         int (&id)[kItems]) {
  if (aligned && r.first + kItems <= r.last) {
    const int4* v = reinterpret_cast<const int4*>(idx + r.first);
    const int4 a = __ldg(v), b = __ldg(v + 1);
    id[0] = a.x, id[1] = a.y, id[2] = a.z, id[3] = a.w;
    id[4] = b.x, id[5] = b.y, id[6] = b.z, id[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      id[e] = r.first + e < r.last ? __ldg(idx + r.first + e) : -1;
  }
}

// The bitmap words of valid ids (all ones for an id outside [0, n)).
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ bm,
                                           int n, const int (&id)[kItems],
                                           uint32_t (&word)[kItems]) {
#pragma unroll
  for (int e = 0; e < kItems; ++e)
    word[e] = id[e] >= 0 && id[e] < n ? __ldg(bm + (id[e] >> 5)) : ~0u;
}

__device__ __forceinline__ bool bit_set(uint32_t word, int id) {
  return (word >> (id & 31)) & 1u;
}

// Bids every key[e] >= 0 of the round's `items` into the set, one lane a
// distinct key of a warp; returns the mask of items whose atomicCAS found
// the slot empty: the first arrival of each distinct key in the whole call.
// Every thread of the block calls it.
template <class Set>
__device__ __forceinline__ unsigned bid_keys(const Set& set,
                                             const int (&key)[kItems],
                                             int items) {
  int slot[kItems], prev[kItems];
  unsigned todo = 0;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    slot[e] = prev[e] = -1;
    if (e < items && warp_bidder(key[e])) {
      slot[e] = hash_slot(key[e], set.shift);
      prev[e] = atomicCAS(set.at(slot[e]), -1, key[e]);
      todo |= 1u << e;
    }
  }
  return claim_slots([&set](int s) { return set.at(s); }, set.mask, slot,
                     prev, key, todo);
}

// Sum over the cluster's CTAs of `v` (the same in every thread of a CTA),
// in rank order; the result is valid in thread 0 of rank 0. Every thread
// of the cluster calls it. It ends with the cluster's last barrier: no
// CTA's shared memory is reached from another after it.
template <int kCluster, typename T>
__device__ __forceinline__ T cluster_total(T v, T* partials) {
  if constexpr (kCluster == 1) {
    return v;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0)
      *cluster.map_shared_rank(partials + blockIdx.x, 0) = v;
    cluster.sync();
    T total = 0;
    if (blockIdx.x == 0 && threadIdx.x == 0)
      for (int r = 0; r < kCluster; ++r) total += partials[r];
    return total;
  }
}

// gather: every thread issues the table loads of all its candidates of a
// round before it adds any, so a CTA waits on one id round trip and one
// table round trip a round; uint32 addition wraps as the int32 sum does and
// is order-free, so the CTAs' partials add up to the serial loop's bits.
template <int kCluster>
__global__ void __launch_bounds__(kBlock)
scalar_gather_kernel(const int* __restrict__ idx, int k,
                     const uint32_t* __restrict__ tab, int n,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[kBlockWarps];
  __shared__ uint32_t partials[kCluster];
  const int rank = kCluster == 1 ? 0 : blockIdx.x;
  const bool aligned = ((uintptr_t)idx & 15) == 0;
  uint32_t acc = 0;
  for (int base = 0; base < k;) {
    const Round r = round_at<kCluster>(base, k, rank);
    base += r.step;
    int id[kItems];
    uint32_t v[kItems];
    load_ids(idx, aligned, r, id);
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      v[e] = id[e] >= 0 && id[e] < n ? __ldg(tab + id[e]) : 0u;
#pragma unroll
    for (int e = 0; e < kItems; ++e) acc += v[e];
  }
  acc = block_sum<kBlock>(acc, warp_sums);
  acc = cluster_total<kCluster>(acc, partials);
  if (rank == 0 && threadIdx.x == 0) out[0] = acc;
}

template <int kCluster, bool kGlobal>
__global__ void __launch_bounds__(kBlock)
scalar_checkset_kernel(int* global_set, int log2_slots,
                       const int* __restrict__ idx, int k,
                       const uint32_t* __restrict__ bm, int n,
                       int* __restrict__ out) {
  __shared__ int warp_sums[kBlockWarps];
  __shared__ int partials[kCluster];
  const IdSet<kCluster, kGlobal> set(global_set, log2_slots);
  const int rank = kCluster == 1 ? 0 : blockIdx.x;
  const bool aligned = ((uintptr_t)idx & 15) == 0;
  int count = 0;
  for (int base = 0; base < k;) {
    const Round r = round_at<kCluster>(base, k, rank);
    int id[kItems];
    uint32_t word[kItems];
    load_ids(idx, aligned, r, id);
    if (base == 0) set.clear();  // the first round's loads fly meanwhile
    load_words(bm, n, id, word);
    if (base == 0) cluster_sync<kCluster>();  // empty before the first bid
    base += r.step;
#pragma unroll
    for (int e = 0; e < kItems; ++e)  // the key: a valid id, its bit clear
      if (bit_set(word[e], id[e])) id[e] = -1;
    count += __popc(bid_keys(set, id, r.items));
  }
  count = block_sum<kBlock>(count, warp_sums);
  count = cluster_total<kCluster>(count, partials);
  if (rank == 0 && threadIdx.x == 0) out[0] = count;
}

template <int kCluster, bool kGlobal>
__global__ void __launch_bounds__(kBlock)
scalar_chain_kernel(int* global_set, int log2_slots,
                    const int* __restrict__ idx, int k,
                    const uint32_t* __restrict__ scored,
                    const uint32_t* __restrict__ enq,
                    const float* __restrict__ scores, int n,
                    float* __restrict__ out, float* __restrict__ ssum,
                    int* __restrict__ n_new, int* __restrict__ emit) {
  __shared__ int sums[kBlockWarps + 1];
  __shared__ double warp_sums[kBlockWarps];
  __shared__ int totals[2][kCluster];  // each CTA's emits, by round parity
  __shared__ double partials[kCluster];
  const IdSet<kCluster, kGlobal> set(global_set, log2_slots);
  const int rank = kCluster == 1 ? 0 : blockIdx.x;
  const bool aligned = ((uintptr_t)idx & 15) == 0;
  double acc = 0.0;
  int carry = 0;  // unscored candidates of earlier rounds, every CTA's
  int parity = 0;
  for (int base = 0; base < k;) {
    const Round r = round_at<kCluster>(base, k, rank);
    int id[kItems], key[kItems];
    uint32_t sw[kItems], ew[kItems];
    load_ids(idx, aligned, r, id);
    if (base == 0) set.clear();  // the first round's loads fly meanwhile
    load_words(scored, n, id, sw);
    load_words(enq, n, id, ew);
    if (base == 0) cluster_sync<kCluster>();  // empty before the first bid
    base += r.step;
    unsigned unscored = 0;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      if (!bit_set(sw[e], id[e])) unscored |= 1u << e;
      key[e] = bit_set(ew[e], id[e]) ? -1 : id[e];
    }
    const unsigned fresh = bid_keys(set, key, r.items);
    float s[kItems];  // loaded here, added after the emit's scan
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      s[e] = (fresh >> e) & 1u ? __ldg(scores + id[e]) : 0.0f;
    // the emit: after every unscored candidate of earlier rounds, of
    // earlier CTAs in this round and of earlier threads in this CTA
    int in_cta;
    int pos = block_exclusive_sum<kBlock>(__popc(unscored), sums, &in_cta);
    int before = 0, in_round = in_cta;
    if constexpr (kCluster > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x < kCluster)
        *cluster.map_shared_rank(&totals[parity][rank], threadIdx.x) = in_cta;
      cluster.sync();
      in_round = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const int t = totals[parity][r];
        before += r < rank ? t : 0;
        in_round += t;
      }
      parity ^= 1;  // the next round's totals land in the other half
    }
    pos += carry + before;
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      if ((unscored >> e) & 1u) emit[pos++] = id[e];
    carry += in_round;
#pragma unroll
    for (int e = 0; e < kItems; ++e) acc += s[e];
  }
  for (int i = carry + rank * kBlock + threadIdx.x; i < k;
       i += kCluster * kBlock)
    emit[i] = -1;
  acc = block_sum<kBlock>(acc, warp_sums);
  acc = cluster_total<kCluster>(acc, partials);
  if (rank == 0 && threadIdx.x == 0) {
    const float sum = (float)acc;
    n_new[0] = carry;
    ssum[0] = sum;
    out[0] = sum + (float)carry;
  }
}

using Granted = std::atomic<int>[rad_launch::kMaxDevices];

// Launches `kernel` on one CTA of kBlock threads, or on one cluster of
// `cluster` CTAs (cudaLaunchKernelEx), with `smem` bytes of dynamic shared
// memory.
template <typename Kernel, typename... Args>
cudaError_t launch_ctas(Kernel kernel, int cluster, int smem,
                        cudaStream_t stream, Args... args) {
  if (cluster == 1) {
    kernel<<<1, kBlock, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(kBlock);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? err : last;
}

// Launches the instance for `cluster` CTAs with the set in shared memory
// (set == null; `granted[cluster > 1]` is that instance's allowance, see
// launch.cuh) or in `set`. `kernels` lists the instances <1, false>,
// <1, true>, <8, false>, <8, true>.
template <typename Kernel, typename... Args>
cudaError_t launch_probe(const Kernel (&kernels)[4], Granted (&granted)[2],
                         void* set, int log2_slots, int cluster,
                         cudaStream_t stream, Args... args) {
  if (cluster != 1 && cluster != kMaxCluster) return cudaErrorInvalidValue;
  const int wide = cluster > 1;
  const int local_log2 = log2_slots - log2_of(cluster);
  if (local_log2 < 2 || log2_slots > 30) return cudaErrorInvalidValue;
  const Kernel kernel = kernels[2 * wide + (set != nullptr)];
  const int smem = set != nullptr ? 0 : 4 << local_log2;
  const cudaError_t err =
      rad_launch::allow_dynamic_smem(kernel, smem, granted[wide]);
  if (err != cudaSuccess) return err;
  return launch_ctas(kernel, cluster, smem, stream, (int*)set, log2_slots,
                     args...);
}

}  // namespace

extern "C" {

int rad_scalar_gather(const void* idx, int k, const void* tab, int n,
                      int cluster, void* out, void* stream) {
  if (cluster != 1 && cluster != kMaxCluster)
    return (int)cudaErrorInvalidValue;
  return (int)launch_ctas(cluster == 1 ? scalar_gather_kernel<1>
                                       : scalar_gather_kernel<kMaxCluster>,
                          cluster, 0, (cudaStream_t)stream, (const int*)idx,
                          k, (const uint32_t*)tab, n, (uint32_t*)out);
}

int rad_scalar_checkset(const void* idx, int k, const void* bm, int n,
                        void* set, int log2_slots, int cluster, void* out,
                        void* stream) {
  static Granted granted[2];
  static decltype(&scalar_checkset_kernel<1, false>) const kernels[4] = {
      scalar_checkset_kernel<1, false>, scalar_checkset_kernel<1, true>,
      scalar_checkset_kernel<kMaxCluster, false>,
      scalar_checkset_kernel<kMaxCluster, true>};
  return (int)launch_probe(kernels, granted, set, log2_slots, cluster,
                           (cudaStream_t)stream, (const int*)idx, k,
                           (const uint32_t*)bm, n, (int*)out);
}

int rad_scalar_chain(const void* idx, int k, const void* scored,
                     const void* enq, const void* scores, int n, void* set,
                     int log2_slots, int cluster, void* out, void* ssum,
                     void* n_new, void* emit, void* stream) {
  static Granted granted[2];
  static decltype(&scalar_chain_kernel<1, false>) const kernels[4] = {
      scalar_chain_kernel<1, false>, scalar_chain_kernel<1, true>,
      scalar_chain_kernel<kMaxCluster, false>,
      scalar_chain_kernel<kMaxCluster, true>};
  return (int)launch_probe(kernels, granted, set, log2_slots, cluster,
                           (cudaStream_t)stream, (const int*)idx, k,
                           (const uint32_t*)scored, (const uint32_t*)enq,
                           (const float*)scores, n, (float*)out,
                           (float*)ssum, (int*)n_new, (int*)emit);
}

}  // extern "C"
