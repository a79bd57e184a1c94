// Fused candidate kernels of the device-scored traversal for NVIDIA Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the two Pallas TPU kernels behind the engine's fused_candidates
// flag:
//   * rad_candidate_filter      <- rad_tpu/traverse/pallas_ops.py
//     candidate_filter_pallas (K1): [K] candidate ids -> the unique
//     unscored ids, compacted to the front in candidate order, -1 padded;
//   * rad_integrate_candidates  <- rad_tpu/traverse/pallas_ops.py
//     integrate_candidates_pallas (K2): scored-set insert-if-absent and
//     score writes (phase A), then the enqueued check-and-set and the push
//     score lookup (phase B), updating the state tables in place.
//
// The TPU kernels are one serial scalar loop over VMEM-resident tables, and
// the loop order is the semantics: a later duplicate sees the mark its
// first occurrence set. Here one block of 1024 threads computes the same
// result: "first occurrence" is the least position that bids for a value.
//
// Bound. Not bytes (K1 moves ~16 KB at K = 2,048, 5 ns at 3.35 TB/s; K2
// ~54 KB, 16 ns) and not operations: latency. A pass costs one dependent
// round trip to L2 (~0.5 us: the candidates, then the table bytes they
// index, which stay resident in the 50 MB L2), and the launch costs the
// host more than all passes together. So the design counts round trips:
//   * Dedup in shared memory, keyed by value and sized by K (dedup.cuh's
//     hash, probe and vote, shared with scalar_probe.cu): an
//     open-addressing table of 2^ceil(log2(2K)) slots of (key, least
//     position), 8 bytes each, cleared by the block at entry. A bidder
//     claims its key's slot with atomicCAS (linear probing; the table is at
//     most half full, so a probe ends), lowers the position with atomicMin,
//     and keeps the slot in a register: after one __syncthreads it reads
//     the position back and knows whether it won, with no second probe. No
//     table sized by N or R, no restore pass, no state between calls.
//   * A thread holds kItems = 8 candidates a round (K <= 8,192 is one
//     round) and issues all their loads (ids, then the table bytes they
//     index) before it uses any: one round trip a pass, not one a
//     candidate. K1 is two passes (bid; emit through block_exclusive_count),
//     K2 four (phase A bid and write; phase B, on the cleared table, bid
//     and write). Larger K runs more rounds: a round's winners are final
//     when it ends, because later rounds bid later positions.
//   * __match_any_sync elects the lowest lane of each distinct value in a
//     warp to bid for it: in a batch of one repeated id it cuts K
//     same-address atomics to K / 32. On an NVIDIA H100 80GB HBM3 at
//     700.00 W (python -m rad_tpu_torch.bench_candidates, K = 2,048, against
//     the same kernels without the vote) that batch took K1 4.2-4.4 us
//     instead of 6.5-7.0 and K2 5.6 instead of 10.6, and the step's recipe
//     paid at most 0.6 us for the vote (K1 5.9-6.0 vs 5.8, K2 11.0-11.1 vs
//     10.3-10.5): a bounded worst case for a fraction of a microsecond.
//   * Above the shared memory a block may take (K > 8,192), the same kernel
//     keeps its table in a per-call global buffer that the wrapper
//     allocates (kGlobal: reads back through L2 with __ldcg).
//   * One block: K is small and the step is bound by the host's launches;
//     a thread-block cluster would add a cross-SM barrier to every pass
//     for work that one SM finishes in a few round trips.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (python -m
// rad_tpu_torch.bench_candidates): at K = 2,048 over the 1M graph K1 takes
// 5.8-6.0 us and K2 11.1 us of device time (4.3 and 6.7 us on the
// device-scored step's real batches), at K = 1 already 3.3 and 4.7 us: a
// 1024-thread block's fixed cost (launch, table clear, barriers, the emit
// scans) now weighs more than the round trips.
//
// Contract (checked by the Python wrapper): ids and rows int32, new scores
// and the score table f32, boolean tables one byte (0/1) per entry, all
// contiguous on one device. `n` and `r_rows` are the tables' logical sizes
// (the engine's trailing sentinel slots are never touched). Ids outside
// [0, n) and rows outside [0, r_rows) count as invalid. `table` is null for
// a table in shared memory (8 << log2_slots bytes of it), else a buffer of
// 1 << log2_slots int2; 2^log2_slots >= 2 * max(K, 1). Each entry point
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "block_ops.cuh"
#include "dedup.cuh"
#include "launch.cuh"

namespace {

constexpr int kItems = 8;                  // candidates a thread holds a round
constexpr int kRound = kItems * kThreads;  // 8,192

template <bool kGlobal>
__device__ __forceinline__ int2* dedup_table(int2* global_table) {
  if constexpr (kGlobal) {
    return global_table;
  } else {
    extern __shared__ __align__(16) int2 shared_table[];
    return shared_table;
  }
}

// Every slot to (empty key, no position).
__device__ __forceinline__ void table_clear(int2* tab, int n_slots) {
  block_fill(reinterpret_cast<int4*>(tab), n_slots / 2,
             make_int4(-1, INT_MAX, -1, INT_MAX));
}

// Claims the slot of `key` (>= 0) and lowers its position to `pos`;
// returns the slot.
__device__ __forceinline__ int table_bid(int2* tab, int mask, int shift,
                                         int key, int pos) {
  const int s = claim_slot([tab](int t) { return &tab[t].x; }, mask,
                           hash_slot(key, shift), key);
  atomicMin(&tab[s].y, pos);
  return s;
}

// The least position that bid for slot s (after the bids' barrier).
template <bool kGlobal>
__device__ __forceinline__ int table_pos(const int2* tab, int s) {
  if constexpr (kGlobal) return __ldcg(&tab[s].y);
  return tab[s].y;
}

// Candidates this round gives each thread (uniform over the block).
__device__ __forceinline__ int round_items(int k, int base) {
  return min(kItems, (k - base + kThreads - 1) / kThreads);
}

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
candidate_filter_kernel(int2* global_table, int log2_slots,
                        const int* __restrict__ cand, int k,
                        const uint8_t* __restrict__ scored, int n,
                        int* __restrict__ out) {
  __shared__ int sums[kWarps + 1];
  int2* tab = dedup_table<kGlobal>(global_table);
  const int mask = (1 << log2_slots) - 1, shift = 32 - log2_slots;
  table_clear(tab, mask + 1);
  __syncthreads();
  int carry = 0;  // ids emitted by earlier rounds
  for (int base = 0; base < k; base += kRound) {
    const int items = round_items(k, base);
    int id[kItems], slot[kItems];
    uint8_t hit[kItems];
    bool bid[kItems], emit[kItems];
    // pass 1: every valid unscored id bids its position
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = base + e * kThreads + threadIdx.x;
      id[e] = e < items && i < k ? __ldg(cand + i) : -1;
    }
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      hit[e] = id[e] >= 0 && id[e] < n ? __ldg(scored + id[e]) : 1;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      bid[e] = false;
      if (e >= items) continue;
      bid[e] = warp_bidder(hit[e] ? -1 : id[e]);
      if (bid[e])
        slot[e] = table_bid(tab, mask, shift, id[e],
                            base + e * kThreads + threadIdx.x);
    }
    __syncthreads();
    // pass 2: the least bidder emits; emitted ids keep candidate order
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      emit[e] = bid[e] && table_pos<kGlobal>(tab, slot[e]) ==
                              base + e * kThreads + (int)threadIdx.x;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      if (e >= items) break;
      int total;
      const int pos = carry + block_exclusive_count(emit[e], sums, &total);
      if (emit[e]) out[pos] = id[e];
      carry += total;
    }
  }
  for (int i = carry + threadIdx.x; i < k; i += kThreads) out[i] = -1;
}

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
integrate_candidates_kernel(int2* global_table, int log2_slots,
                            const int* __restrict__ to_score,
                            const float* __restrict__ new_scores, int kt,
                            const int* __restrict__ cand,
                            const int* __restrict__ row, int kc,
                            uint8_t* scored, float* scores, int n,
                            uint8_t* enqueued, int r_rows,
                            uint8_t* __restrict__ fresh,
                            uint8_t* __restrict__ push,
                            float* __restrict__ cand_score) {
  int2* tab = dedup_table<kGlobal>(global_table);
  const int mask = (1 << log2_slots) - 1, shift = 32 - log2_slots;
  table_clear(tab, mask + 1);
  __syncthreads();

  // -- phase A: scored insert-if-absent. The least position of an id that
  // was unscored before this call is fresh and writes its score.
  for (int base = 0; base < kt; base += kRound) {
    const int items = round_items(kt, base);
    int id[kItems], slot[kItems];
    float ns[kItems];
    uint8_t hit[kItems];
    bool bid[kItems];
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = base + e * kThreads + threadIdx.x;
      const bool in = e < items && i < kt;
      id[e] = in ? __ldg(to_score + i) : -1;
      ns[e] = in ? __ldg(new_scores + i) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      hit[e] = id[e] >= 0 && id[e] < n ? scored[id[e]] : 1;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      bid[e] = false;
      if (e >= items) continue;
      bid[e] = warp_bidder(hit[e] ? -1 : id[e]);
      if (bid[e])
        slot[e] = table_bid(tab, mask, shift, id[e],
                            base + e * kThreads + threadIdx.x);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      if (e >= items) break;
      const int i = base + e * kThreads + threadIdx.x;
      const bool f = bid[e] && table_pos<kGlobal>(tab, slot[e]) == i;
      if (i < kt) fresh[i] = f;
      if (f) {
        scored[id[e]] = 1;
        scores[id[e]] = ns[e];
      }
    }
  }
  __syncthreads();  // phase A's table is read out and its writes visible
  table_clear(tab, mask + 1);
  __syncthreads();

  // -- phase B: enqueue check-and-set at the candidate's row; a pushed
  // candidate reads its score from the table as phase A left it.
  for (int base = 0; base < kc; base += kRound) {
    const int items = round_items(kc, base);
    int id[kItems], r[kItems], slot[kItems];
    uint8_t hit[kItems];
    bool bid[kItems], p[kItems];
    float s[kItems];
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = base + e * kThreads + threadIdx.x;
      const bool in = e < items && i < kc;
      id[e] = in ? __ldg(cand + i) : -1;
      r[e] = in ? __ldg(row + i) : -1;
    }
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      if (id[e] < 0 || id[e] >= n || r[e] >= r_rows) r[e] = -1;
      hit[e] = r[e] >= 0 ? enqueued[r[e]] : 1;
    }
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      bid[e] = false;
      if (e >= items) continue;
      bid[e] = warp_bidder(hit[e] ? -1 : r[e]);
      if (bid[e])
        slot[e] = table_bid(tab, mask, shift, r[e],
                            base + e * kThreads + threadIdx.x);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      p[e] = bid[e] && table_pos<kGlobal>(tab, slot[e]) ==
                           base + e * kThreads + (int)threadIdx.x;
#pragma unroll
    for (int e = 0; e < kItems; ++e) s[e] = p[e] ? scores[id[e]] : INFINITY;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      if (e >= items) break;
      const int i = base + e * kThreads + threadIdx.x;
      if (p[e]) enqueued[r[e]] = 1;
      if (i < kc) {
        push[i] = p[e];
        cand_score[i] = s[e];
      }
    }
  }
}

// Launches the instance with the table in shared memory (table == null;
// `granted` is that instance's allowance, see launch.cuh) or in `table`.
template <typename Kernel, typename... Args>
cudaError_t launch_dedup(Kernel shared_kernel, Kernel global_kernel,
                         std::atomic<int> (&granted)[rad_launch::kMaxDevices],
                         void* table, int log2_slots, cudaStream_t stream,
                         Args... args) {
  if (log2_slots < 1 || log2_slots > 30) return cudaErrorInvalidValue;
  if (table != nullptr) {
    global_kernel<<<1, kThreads, 0, stream>>>((int2*)table, log2_slots,
                                              args...);
    return cudaGetLastError();
  }
  const int smem = 8 << log2_slots;
  const cudaError_t err =
      rad_launch::allow_dynamic_smem(shared_kernel, smem, granted);
  if (err != cudaSuccess) return err;
  shared_kernel<<<1, kThreads, smem, stream>>>(nullptr, log2_slots, args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int rad_candidate_filter(const void* cand, int k, const void* scored, int n,
                         void* table, int log2_slots, void* out,
                         void* stream) {
  if (k <= 0) return (int)cudaGetLastError();
  static std::atomic<int> granted[rad_launch::kMaxDevices];
  return (int)launch_dedup(
      candidate_filter_kernel<false>, candidate_filter_kernel<true>, granted,
      table, log2_slots, (cudaStream_t)stream, (const int*)cand, k,
      (const uint8_t*)scored, n, (int*)out);
}

int rad_integrate_candidates(const void* to_score, const void* new_scores,
                             int kt, const void* cand, const void* row,
                             int kc, void* scored, void* scores, int n,
                             void* enqueued, int r_rows, void* table,
                             int log2_slots, void* fresh, void* push,
                             void* cand_score, void* stream) {
  if (kt <= 0 && kc <= 0) return (int)cudaGetLastError();
  static std::atomic<int> granted[rad_launch::kMaxDevices];
  return (int)launch_dedup(
      integrate_candidates_kernel<false>, integrate_candidates_kernel<true>,
      granted, table, log2_slots, (cudaStream_t)stream,
      (const int*)to_score, (const float*)new_scores, kt, (const int*)cand,
      (const int*)row, kc, (uint8_t*)scored, (float*)scores, n,
      (uint8_t*)enqueued, r_rows, (uint8_t*)fresh, (uint8_t*)push,
      (float*)cand_score);
}

}  // extern "C"
