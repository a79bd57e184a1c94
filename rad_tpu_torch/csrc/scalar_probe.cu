// The three per-candidate probes of the scalar-loop microbenchmark for
// NVIDIA Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes).
//
// Replaces the three Pallas TPU kernels of benchmarks/bench_scalar_probe.py
// (the closures gather_kernel, checkset_kernel and chain_kernel of main()):
//   * rad_scalar_gather    <- gather:   sum of tab[idx[i]] (int32, wrapping);
//   * rad_scalar_checkset  <- checkset: how many idx[i] found their bit of
//     the bitmap clear at their turn, bits set in a scratch copy, so a
//     duplicate id counts once;
//   * rad_scalar_chain     <- chain: the whole per-candidate work of one
//     traversal step: the scored test with a compacted emit of the unscored
//     ids in candidate order, the enqueue test-and-set on a scratch copy,
//     and the score lookup summed over the ids whose enqueue bit was clear.
//
// Design. On the TPU each probe is one serial loop of k iterations, because
// Mosaic offers only scalar dynamic indexing; the loop's order is what makes
// a duplicate id find the bit its first occurrence set. Here one block of
// 1024 threads takes the candidates 1024 at a time. The scratch copy of the
// bitmap (128 KB at n = 2^20) lives in the block's dynamic shared memory, the
// counterpart of the TPU kernel's VMEM scratch; a bitmap too large for one
// block's shared memory is copied into a global scratch buffer the wrapper
// passes instead. Test-and-set is atomicOr: of several threads holding the
// same id exactly one sees the bit clear. Which one is free, and nothing
// depends on it: checkset counts, and chain sums scores[j], once per
// distinct id whose bit was clear, whichever duplicate wins. The emit of
// chain reads only the read-only scored bitmap, so every duplicate emits, in
// candidate order, through the block-wide exclusive count of block_ops.cuh
// with a carry from one 1024-candidate chunk to the next.
//
// The score sum. The TPU loop adds f32 scores in candidate order; a parallel
// sum cannot repeat that rounding. The kernel adds in float64 (per thread,
// then a fixed shuffle tree) and rounds once to f32, which is within one f32
// unit in the last place of the exactly rounded sum; the plain twin does the
// same, so the two agree to one ulp, and both lie within k * 2^-24 * sum of
// the TPU loop's f32 result.
//
// Bound. Latency and the launch: a call reads idx once (4k bytes), one
// 32-byte sector per random access, and the bitmap copies once, some
// hundreds of KB in all, tens of nanoseconds at the card's memory rate. One
// block on one SM does not try to fill the card.
//
// Contract (checked by the Python wrapper): idx int32 [k], tables int32 or
// f32 of n entries, bitmaps int32 of n / 32 words (bit b of word w is id
// 32 w + b), n a multiple of 32, all contiguous on one device. Ids outside
// [0, n) are skipped. `scratch` is NULL (the bitmap copy goes to shared
// memory) or a buffer of n / 32 words. Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_ops.cuh"

namespace {

// The block's working copy of a bitmap: shared memory, or `scratch`.
__device__ __forceinline__ uint32_t* copy_bitmap(
    const uint32_t* __restrict__ src, int words, uint32_t* scratch) {
  extern __shared__ uint32_t dyn_words[];
  uint32_t* bits = scratch != nullptr ? scratch : dyn_words;
  for (int w = threadIdx.x; w < words; w += kThreads) bits[w] = src[w];
  __syncthreads();
  return bits;
}

__global__ void __launch_bounds__(kThreads)
scalar_gather_kernel(const int* __restrict__ idx, int k,
                     const uint32_t* __restrict__ tab, int n,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[kWarps];
  uint32_t acc = 0;  // unsigned: wraps as the int32 sum does
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int j = idx[i];
    if (j >= 0 && j < n) acc += tab[j];
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) out[0] = acc;
}

__global__ void __launch_bounds__(kThreads)
scalar_checkset_kernel(const int* __restrict__ idx, int k,
                       const uint32_t* __restrict__ bm, int n,
                       uint32_t* scratch, int* __restrict__ out) {
  __shared__ int warp_sums[kWarps];
  uint32_t* bits = copy_bitmap(bm, n >> 5, scratch);
  int acc = 0;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int j = idx[i];
    if (j < 0 || j >= n) continue;
    const uint32_t bit = 1u << (j & 31);
    acc += (atomicOr(&bits[j >> 5], bit) & bit) == 0;
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) out[0] = acc;
}

__global__ void __launch_bounds__(kThreads)
scalar_chain_kernel(const int* __restrict__ idx, int k,
                    const uint32_t* __restrict__ scored,
                    const uint32_t* __restrict__ enq,
                    const float* __restrict__ scores, int n,
                    uint32_t* scratch, float* __restrict__ out_f,
                    int* __restrict__ out_i, int* __restrict__ emit) {
  __shared__ int sums[kWarps + 1];
  __shared__ double warp_sums[kWarps];
  uint32_t* bits = copy_bitmap(enq, n >> 5, scratch);
  double acc = 0.0;
  int carry = 0;  // unscored candidates before this chunk
  for (int base = 0; base < k; base += kThreads) {
    const int i = base + threadIdx.x;
    int j = -1;
    bool unscored = false;
    if (i < k) {
      j = idx[i];
      if (j >= 0 && j < n) {
        const uint32_t bit = 1u << (j & 31);
        unscored = (scored[j >> 5] & bit) == 0;
        if ((atomicOr(&bits[j >> 5], bit) & bit) == 0) acc += scores[j];
      }
    }
    int total;
    const int pos = carry + block_exclusive_count(unscored, sums, &total);
    if (unscored) emit[pos] = j;
    carry += total;
  }
  for (int i = carry + threadIdx.x; i < k; i += kThreads) emit[i] = -1;
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    const float ssum = (float)acc;
    out_i[0] = carry;
    out_f[0] = ssum + (float)carry;
    out_f[1] = ssum;
  }
}

// Dynamic shared memory for the bitmap copy: none with a global scratch.
// Above 48 KB a kernel has to be given the right first.
template <typename Kernel>
cudaError_t bitmap_smem(Kernel kernel, int n, const void* scratch,
                        size_t* bytes) {
  *bytes = scratch != nullptr ? 0 : (size_t)(n >> 5) * sizeof(uint32_t);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace

extern "C" {

int rad_scalar_gather(const void* idx, int k, const void* tab, int n,
                      void* out, void* stream) {
  scalar_gather_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, k, (const uint32_t*)tab, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

int rad_scalar_checkset(const void* idx, int k, const void* bm, int n,
                        void* scratch, void* out, void* stream) {
  size_t smem;
  const cudaError_t err = bitmap_smem(scalar_checkset_kernel, n, scratch,
                                      &smem);
  if (err != cudaSuccess) return (int)err;
  scalar_checkset_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)idx, k, (const uint32_t*)bm, n, (uint32_t*)scratch,
      (int*)out);
  return (int)cudaGetLastError();
}

int rad_scalar_chain(const void* idx, int k, const void* scored,
                     const void* enq, const void* scores, int n,
                     void* scratch, void* out_f, void* out_i, void* emit,
                     void* stream) {
  size_t smem;
  const cudaError_t err = bitmap_smem(scalar_chain_kernel, n, scratch,
                                      &smem);
  if (err != cudaSuccess) return (int)err;
  scalar_chain_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)idx, k, (const uint32_t*)scored, (const uint32_t*)enq,
      (const float*)scores, n, (uint32_t*)scratch, (float*)out_f,
      (int*)out_i, (int*)emit);
  return (int)cudaGetLastError();
}

}  // extern "C"
