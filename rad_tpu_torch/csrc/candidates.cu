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
// Design. Both TPU kernels are one serial scalar loop over VMEM-resident
// tables, and the loop order is the semantics: a later duplicate sees the
// mark its first occurrence set. Here one block of 1024 threads computes
// the same result in parallel. "First occurrence" becomes an atomicMin of
// the position into an int32 scratch table indexed by id (or row), read
// back after a barrier; the compaction is a block-wide exclusive count
// (warp ballots, one warp scanning the 32 warp totals) with a carry across
// 1024-candidate chunks. Afterwards the winners put their scratch slots
// back to INT_MAX, which is the scratch's value between calls (the Python
// wrapper allocates it once per device and size and owns that invariant).
// K2's two phases are separated by __syncthreads inside the one block, so
// phase B reads the score table as phase A left it.
//
// Bound. Latency, not bandwidth or arithmetic: each candidate costs a few
// dependent random 1-byte or 4-byte accesses into tables of 1-4 MB at 1M
// molecules (scored [N] u8, scores [N] f32, enqueued [R] u8, two int32
// scratch tables), which stay resident in the 50 MB L2; plus the launch
// itself. With K = 2048 a block makes ~6 such dependent round trips per
// phase, each a few hundred cycles. One block uses one SM of 132; the
// design does not try to fill the card (K is small) and is not tuned yet.
//
// Contract (checked by the Python wrapper): ids and rows int32, new scores
// and the score table f32, boolean tables one byte (0/1) per entry, all
// contiguous on one device. `n` and `r_rows` are the tables' logical sizes
// (the engine's trailing sentinel slots are never touched). Ids outside
// [0, n) and rows outside [0, r_rows) count as invalid. Each entry point
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(kThreads)
candidate_filter_kernel(const int* __restrict__ cand, int k,
                        const uint8_t* __restrict__ scored, int n,
                        int* first_pos, int* __restrict__ out) {
  __shared__ int sums[kWarps + 1];
  // every valid unscored candidate bids its position for its id
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int j = cand[i];
    if (j >= 0 && j < n && !scored[j]) atomicMin(&first_pos[j], i);
  }
  __syncthreads();
  // the lowest bidder emits; emitted ids keep candidate order
  int carry = 0;
  for (int base = 0; base < k; base += kThreads) {
    const int i = base + threadIdx.x;
    int j = -1;
    bool emit = false;
    if (i < k) {
      j = cand[i];
      emit = j >= 0 && j < n && __ldcg(&first_pos[j]) == i;
    }
    int total;
    const int pos = carry + block_exclusive_count(emit, sums, &total);
    if (emit) out[pos] = j;
    carry += total;
  }
  for (int i = carry + threadIdx.x; i < k; i += kThreads) out[i] = -1;
  __syncthreads();
  // the emitted ids are exactly the slots that hold a position
  for (int p = threadIdx.x; p < carry; p += kThreads)
    first_pos[out[p]] = INT_MAX;
}

__global__ void __launch_bounds__(kThreads)
integrate_candidates_kernel(const int* __restrict__ to_score,
                            const float* __restrict__ new_scores, int kt,
                            const int* __restrict__ cand,
                            const int* __restrict__ row, int kc,
                            uint8_t* scored, float* scores, int n,
                            uint8_t* enqueued, int r_rows, int* first_id,
                            int* first_row, uint8_t* fresh, uint8_t* push,
                            float* __restrict__ cand_score) {
  // -- phase A: scored insert-if-absent. The first position of an id that
  // was unscored before this call is fresh; a later duplicate is not.
  for (int i = threadIdx.x; i < kt; i += kThreads) {
    const int j = to_score[i];
    if (j >= 0 && j < n && !scored[j]) atomicMin(&first_id[j], i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kt; i += kThreads) {
    const int j = to_score[i];
    const bool f = j >= 0 && j < n && __ldcg(&first_id[j]) == i;
    fresh[i] = f;
    if (f) {
      scored[j] = 1;
      scores[j] = new_scores[i];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kt; i += kThreads)
    if (fresh[i]) first_id[to_score[i]] = INT_MAX;

  // -- phase B: enqueue check-and-set at the candidate's row; a pushed
  // candidate reads its score from the table as phase A left it.
  for (int i = threadIdx.x; i < kc; i += kThreads) {
    const int j = cand[i];
    if (j < 0 || j >= n) continue;
    const int r = row[i];
    if (r >= 0 && r < r_rows && !enqueued[r]) atomicMin(&first_row[r], i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kc; i += kThreads) {
    const int j = cand[i];
    bool p = false;
    float s = INFINITY;
    if (j >= 0 && j < n) {
      const int r = row[i];
      p = r >= 0 && r < r_rows && __ldcg(&first_row[r]) == i;
      if (p) {
        enqueued[r] = 1;
        s = scores[j];
      }
    }
    push[i] = p;
    cand_score[i] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kc; i += kThreads)
    if (push[i]) first_row[row[i]] = INT_MAX;
}

}  // namespace

extern "C" {

int rad_candidate_filter(const void* cand, int k, const void* scored, int n,
                         void* first_pos, void* out, void* stream) {
  if (k <= 0) return (int)cudaGetLastError();
  candidate_filter_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)cand, k, (const uint8_t*)scored, n, (int*)first_pos,
      (int*)out);
  return (int)cudaGetLastError();
}

int rad_integrate_candidates(const void* to_score, const void* new_scores,
                             int kt, const void* cand, const void* row,
                             int kc, void* scored, void* scores, int n,
                             void* enqueued, int r_rows, void* first_id,
                             void* first_row, void* fresh, void* push,
                             void* cand_score, void* stream) {
  if (kt <= 0 && kc <= 0) return (int)cudaGetLastError();
  integrate_candidates_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)to_score, (const float*)new_scores, kt, (const int*)cand,
      (const int*)row, kc, (uint8_t*)scored, (float*)scores, n,
      (uint8_t*)enqueued, r_rows, (int*)first_id, (int*)first_row,
      (uint8_t*)fresh, (uint8_t*)push, (float*)cand_score);
  return (int)cudaGetLastError();
}

}  // extern "C"
