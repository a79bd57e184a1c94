// Check and rate of the 1-bit tensor-core product that the Tanimoto kernels
// multiply with (wgmma.mma_async ... m64n128k256.s32.b1.b1.and.popc). Prints
// one JSON object a line. Built and run by
// `python -m rad_tpu_torch.bench_mma_rate`.
//
// `check_b1` multiplies ragged tiles through the staging, descriptor and
// accumulator maps of csrc/tanimoto_mma.cuh and compares every count with
// the host's popcount. The rate then runs the instruction from shared
// memory alone, every SM busy, and counts 2 * M * N * K operations an
// instruction, K in bits, so that it compares with 2 * Q * N * D of a
// Tanimoto problem of D-bit fingerprints: the peak behind the kernels'
// bound by operations.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include <vector>

#include "../csrc/tanimoto_mma.cuh"

using namespace rad_mma;

#define CHECK(x)                                                       \
  do {                                                                 \
    cudaError_t e_ = (x);                                              \
    if (e_ != cudaSuccess) {                                           \
      fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,                \
              cudaGetErrorString(e_));                                 \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu;
  return x ^ (x >> 16);
}

// Two warpgroups a block, each 64 rows of A (its own tile) against one
// shared 128-row B tile, `batch` products a commit.
constexpr int kWgmmaSmem = 2 * kWgRows * kChunkBytes + kTileN * kChunkBytes;
constexpr int kBatch = 16;

__global__ void __launch_bounds__(256)
wgmma_rate_kernel(int iters, int* out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < kWgmmaSmem / 4; i += 256)
    words[i] = mix(i + blockIdx.x);
  fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint64_t da =
      tile_desc(smem_u32(smem) + wg * kWgRows * kChunkBytes);
  const uint64_t db = tile_desc(smem_u32(smem) + 2 * kWgRows * kChunkBytes);
  int acc[kAccRegs];
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) acc[i] = 0;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int ks = u & 3;
      wgmma_b1(acc, da + 2 * ks, db + 2 * ks, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_accumulators(acc);
  int s = 0;
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) s += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

// One 128 x 128 x (32 * w)-bit tile through the package's staging and maps.
__global__ void __launch_bounds__(256)
check_b1_kernel(const uint32_t* a, int n_a, const uint32_t* b, int n_b, int w,
                bool vec, int* out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t a_tile = smem_u32(smem);
  const uint32_t b_tile = a_tile + 2 * kWgRows * kChunkBytes;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  int acc[kAccRegs];
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) acc[i] = 0;
  for (int w0 = 0; w0 < w; w0 += kChunkWords) {
    __syncthreads();
    stage_chunk(a_tile, a, n_a, w, 0, w0, 2 * kWgRows, vec, threadIdx.x, 256);
    stage_chunk(b_tile, b, n_b, w, 0, w0, kTileN, vec, threadIdx.x, 256);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
    tile_chunk_b1(acc, a_tile + wg * kWgRows * kChunkBytes, b_tile,
                  min(kChunkWords, w - w0), w0 == 0);
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_accumulators(acc);
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i)
    out[(wg * kWgRows + acc_row(i, t)) * kTileN + acc_col(i, t)] = acc[i];
}

static int check_b1(int n_a, int n_b, int w, int pad_words) {
  // pad_words shifts the arrays off 16-byte alignment to take the 4-byte path
  std::vector<uint32_t> ha((size_t)n_a * w), hb((size_t)n_b * w);
  uint32_t s = 12345u + n_a * 7 + n_b * 13 + w;
  auto next = [&s]() { s = s * 1664525u + 1013904223u; return s ^ (s >> 13); };
  for (auto& v : ha) v = next() & next();
  for (auto& v : hb) v = next() | (next() & next());
  uint32_t *da, *db;
  int* dout;
  CHECK(cudaMalloc(&da, (ha.size() + 8) * 4));
  CHECK(cudaMalloc(&db, (hb.size() + 8) * 4));
  CHECK(cudaMalloc(&dout, 128 * 128 * 4));
  CHECK(cudaMemcpy(da + pad_words, ha.data(), ha.size() * 4,
                   cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(db + pad_words, hb.data(), hb.size() * 4,
                   cudaMemcpyHostToDevice));
  const bool vec = (w % 4 == 0) && pad_words % 4 == 0;
  check_b1_kernel<<<1, 256, kWgmmaSmem>>>(da + pad_words, n_a, db + pad_words,
                                          n_b, w, vec, dout);
  CHECK(cudaGetLastError());
  CHECK(cudaDeviceSynchronize());
  std::vector<int> got(128 * 128);
  CHECK(cudaMemcpy(got.data(), dout, got.size() * 4, cudaMemcpyDeviceToHost));
  int bad = 0;
  for (int i = 0; i < 128; ++i)
    for (int j = 0; j < 128; ++j) {
      int want = 0;
      if (i < n_a && j < n_b)
        for (int k = 0; k < w; ++k)
          want += __builtin_popcount(ha[(size_t)i * w + k] &
                                     hb[(size_t)j * w + k]);
      if (got[i * 128 + j] != want && bad++ < 4)
        fprintf(stderr, "check_b1 n_a=%d n_b=%d w=%d: [%d][%d] = %d, want %d\n",
                n_a, n_b, w, i, j, got[i * 128 + j], want);
    }
  printf("{\"check_b1\": {\"n_a\": %d, \"n_b\": %d, \"w\": %d, \"vec\": %s, "
         "\"mismatches\": %d}}\n", n_a, n_b, w, vec ? "true" : "false", bad);
  cudaFree(da); cudaFree(db); cudaFree(dout);
  return bad;
}

template <typename Launch>
static void time_rate(const char* name, double ops_per_launch, Launch launch) {
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  launch();
  CHECK(cudaDeviceSynchronize());
  float best = 1e30f;
  for (int rep = 0; rep < 5; ++rep) {
    CHECK(cudaEventRecord(e0));
    launch();
    CHECK(cudaEventRecord(e1));
    CHECK(cudaEventSynchronize(e1));
    CHECK(cudaGetLastError());
    float ms;
    CHECK(cudaEventElapsedTime(&ms, e0, e1));
    if (ms < best) best = ms;
  }
  printf("{\"probe\": \"%s\", \"ms\": %.4f, \"tera_ops_per_s\": %.1f}\n", name,
         best, ops_per_launch / (best * 1e-3) / 1e12);
}

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  const int sms = prop.multiProcessorCount;
  printf("{\"device\": \"%s\", \"sms\": %d, \"clock_mhz\": %d}\n", prop.name,
         sms, prop.clockRate / 1000);

  int bad = 0;
  const int shapes[][4] = {{128, 128, 32, 0}, {128, 128, 32, 1},
                           {65, 100, 8, 0},   {1, 64, 6, 0},
                           {65, 128, 1, 0}, {128, 77, 64, 0}};
  CHECK(cudaFuncSetAttribute(check_b1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWgmmaSmem));
  for (auto& s : shapes) bad += check_b1(s[0], s[1], s[2], s[3]);

  int* out;
  const int blocks = sms * 2, iters = 2048;
  CHECK(cudaMalloc(&out, (size_t)blocks * 256 * 4));
  CHECK(cudaFuncSetAttribute(wgmma_rate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWgmmaSmem));
  time_rate("wgmma_b1_m64n128k256",
            (double)blocks * 2 * iters * kBatch * 2.0 * 64 * 128 * 256, [&] {
              wgmma_rate_kernel<<<blocks, 256, kWgmmaSmem>>>(iters, out);
            });
  cudaFree(out);
  return bad ? 1 : 0;
}
