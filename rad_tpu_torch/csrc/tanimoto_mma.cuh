// Exact intersections of packed binary fingerprints on Hopper's tensor
// cores: the 1-bit warpgroup product
//   wgmma.mma_async ... m64n128k256.s32.b1.b1.and.popc
// takes the fingerprints' own packed 32-bit words as both operands, so
// D[i][j] += popc(A[i] & B[j]) over 256 bits a step, summed in s32. The
// counts are exact integers, whatever the order of the bits inside a step.
//
// Shared-memory layout. A tile is rows of one K chunk: 32 packed words =
// 128 bytes a row, rows 128 bytes apart, in the 128-byte swizzle that the
// wgmma descriptors name: the 16-byte piece c of row r lies at piece
// c ^ (r & 7). A tile starts on a 1024-byte boundary. A 1024-bit
// fingerprint is one chunk and four k-steps of 256 bits (32 bytes); a k-step
// is addressed by adding its byte offset to the descriptor's start. Both
// operands are K-major (a row's words are contiguous), which is how the
// fingerprints lie in device memory, so nothing is unpacked or transposed.
// Rows past the end of the array and words past W are staged as zeros and
// add nothing to a count.
//
// Interface for a kernel built on this body:
//   * stage_chunk()  fills one [rows x 128 B] swizzled tile from device
//     memory (16-byte cp.async with zero fill where rows are 16-byte
//     aligned, 4-byte loads otherwise);
//   * tile_chunk_b1() starts the k-steps of one chunk for one warpgroup: 64
//     rows of A against kTileN = 128 rows of B, into 64 s32 accumulators a
//     thread (or 256 rows of B into 128);
//   * acc_row() / acc_col() give the (row, column) in that 64 x 128 (or
//     64 x 256) tile of accumulator i of a thread, so an epilogue (a
//     distance, a bucket max, a running best) can sit on the accumulators
//     directly.
// wgmma is asynchronous: wgmma_fence() before the first product of a batch,
// wgmma_commit() after the last, wgmma_wait<0>() and fence_accumulators()
// before the accumulators are read or the operands' tiles are overwritten.
// Tiles written by threads (cp.async or st.shared) are made visible to the
// tensor cores by fence_proxy_async() on the writer's side, before the
// barrier that hands the tile over.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rad_mma {

constexpr int kChunkWords = 32;   // packed words of a row in one K chunk
constexpr int kChunkBytes = 128;  // = one swizzle row
constexpr int kStepWords = 8;     // 256 bits: the depth of one wgmma
constexpr int kWgRows = 64;       // rows of A a warpgroup multiplies
constexpr int kTileN = 128;       // rows of B in one product
constexpr int kAccRegs = kTileN / 2;  // s32 accumulators a thread

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- barriers and asynchronous copies -------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes, of which the first `bytes` (0 or 16) come from `src` and the
// rest are zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory writes before reads that the tensor
// cores make of them (wgmma reads through the asynchronous proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- staging --------------------------------------------------------------

__device__ __forceinline__ bool rows_are_16b_aligned(const void* p, int w) {
  return (w & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Stage words [w0, w0 + 32) of rows [r0, r0 + rows) of `src` ([n_rows, w]
// packed words) into the swizzled tile at shared address `tile`; rows past
// n_rows and words past w become zeros. Called by `nthreads` threads with
// tid in [0, nthreads). With `vec` (rows_are_16b_aligned) the copies are
// cp.async and complete with the caller's cp.async group; otherwise they
// are plain stores, complete on return.
__device__ __forceinline__ void stage_chunk(uint32_t tile,
                                            const uint32_t* __restrict__ src,
                                            int n_rows, int w, int r0, int w0,
                                            int rows, bool vec, int tid,
                                            int nthreads) {
  if (vec) {
    for (int idx = tid; idx < rows * 8; idx += nthreads) {
      const int r = idx >> 3;
      const int c = idx & 7;
      const int gr = r0 + r;
      const int word = w0 + c * 4;
      const bool valid = gr < n_rows && word < w;
      const uint32_t* from = valid ? src + (size_t)gr * w + word : src;
      cp_async16(tile + r * kChunkBytes + ((c ^ (r & 7)) << 4), from,
                 valid ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < rows * kChunkWords; idx += nthreads) {
      const int r = idx >> 5;
      const int c = idx & 31;
      const int gr = r0 + r;
      const int word = w0 + c;
      const uint32_t v =
          (gr < n_rows && word < w) ? src[(size_t)gr * w + word] : 0u;
      const uint32_t dst = tile + r * kChunkBytes +
                           (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
    }
  }
}

// stage_chunk for kRows rows with every copy a cp.async, called by kThreads
// threads (a multiple of 128): all of it completes with the caller's
// cp.async group, so a producer keeps chunks in flight at any row width.
// Rows that are not 16-byte aligned take 4-byte copies (zero fill past the
// data), unrolled: warp p copies rows p, p + kThreads / 32, ..., lane c
// word w0 + c of each; a row's swizzle is one of two values, so a copy
// costs its pointer step and the copy itself.
template <int kRows, int kThreads>
__device__ __forceinline__ void stage_chunk_async(
    uint32_t tile, const uint32_t* __restrict__ src, int n_rows, int w,
    int r0, int w0, bool vec, int tid) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kWarps % 4 == 0 && kRows % kWarps == 0,
                "a warp's rows alternate between two swizzles");
  if (vec) {
    stage_chunk(tile, src, n_rows, w, r0, w0, kRows, true, tid, kThreads);
    return;
  }
  const int c = tid & 31;
  const int p = tid >> 5;
  const uint32_t lane = (c & 3) << 2;
  const uint32_t sw0 = (((c >> 2) ^ (p & 7)) << 4) | lane;
  const uint32_t sw1 = (((c >> 2) ^ ((p + kWarps) & 7)) << 4) | lane;
  const uint32_t base = tile + p * kChunkBytes;
  // rows p + kWarps * i with i < `live` / kWarps hold data for this lane
  const int live = w0 + c < w ? n_rows - r0 - p : 0;
  const uint32_t* from = src + (size_t)(r0 + p) * w + w0 + c;
  const size_t step = (size_t)kWarps * w;
#pragma unroll
  for (int i = 0; i < kRows / kWarps; ++i, from += step) {
    const bool valid = kWarps * i < live;
    cp_async4(base + i * kWarps * kChunkBytes + ((i & 1) ? sw1 : sw0),
              valid ? from : src, valid ? 4 : 0);
  }
}

// ---- the product ----------------------------------------------------------

// Descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle:
// start address, leading offset 1 (unused inside one swizzle row), 1024
// bytes from one group of 8 rows to the next, swizzle mode 1 (128 B).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading accumulators before wgmma_wait.
template <int kRegs>
__device__ __forceinline__ void fence_accumulators(int (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define RAD_MMA_D8(d, o)                                            \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),        \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])
#define RAD_MMA_D64(d)                                                  \
  RAD_MMA_D8(d, 0), RAD_MMA_D8(d, 8), RAD_MMA_D8(d, 16),                \
      RAD_MMA_D8(d, 24), RAD_MMA_D8(d, 32), RAD_MMA_D8(d, 40),          \
      RAD_MMA_D8(d, 48), RAD_MMA_D8(d, 56)
// One m64n128 warpgroup product with 64 s32 accumulators a thread; TYPES is
// the instruction's shape-and-type suffix. d = (scale_d ? d : 0) + A x B.
#define RAD_MMA_WGMMA_N128(TYPES, d, desc_a, desc_b, scale_d)               \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned." TYPES " "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"   \
      "}\n"                                                                 \
      : RAD_MMA_D64(d)                                                      \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define RAD_MMA_D128(d)                                                 \
  RAD_MMA_D64(d), RAD_MMA_D8(d, 64), RAD_MMA_D8(d, 72), RAD_MMA_D8(d, 80), \
      RAD_MMA_D8(d, 88), RAD_MMA_D8(d, 96), RAD_MMA_D8(d, 104),            \
      RAD_MMA_D8(d, 112), RAD_MMA_D8(d, 120)
// The same with n = 256: 128 s32 accumulators a thread.
#define RAD_MMA_WGMMA_N256(TYPES, d, desc_a, desc_b, scale_d)              \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                        \
      "wgmma.mma_async.sync.aligned." TYPES " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "  \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "  \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "  \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
      "%127}, %128, %129, p;\n"                                            \
      "}\n"                                                                \
      : RAD_MMA_D128(d)                                                    \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

// acc[i] (+)= popc(A[row] & B[col]) over 256 bits: 64 rows of the tile
// behind desc_a, 128 rows of the tile behind desc_b (or 256 rows, with 128
// accumulators a thread).
__device__ __forceinline__ void wgmma_b1(int (&acc)[kAccRegs],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  RAD_MMA_WGMMA_N128("m64n128k256.s32.b1.b1.and.popc", acc, desc_a, desc_b,
                     scale_d);
}

__device__ __forceinline__ void wgmma_b1(int (&acc)[2 * kAccRegs],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  RAD_MMA_WGMMA_N256("m64n256k256.s32.b1.b1.and.popc", acc, desc_a, desc_b,
                     scale_d);
}

// One K chunk for one warpgroup: the k-steps that hold words [0, kw) of the
// chunk, A = 64 rows at shared address a_tile, B = 2 * kRegs rows (128 or
// 256) at b_tile. `first` zeroes the accumulators. The caller brackets a
// batch of chunks with wgmma_fence() and wgmma_commit().
template <int kRegs>
__device__ __forceinline__ void tile_chunk_b1(int (&acc)[kRegs],
                                              uint32_t a_tile,
                                              uint32_t b_tile, int kw,
                                              bool first) {
  const uint64_t da = tile_desc(a_tile);
  const uint64_t db = tile_desc(b_tile);
  const int ksteps = (kw + kStepWords - 1) / kStepWords;
  for (int ks = 0; ks < ksteps; ++ks)  // 32 bytes a step: 2 descriptor units
    wgmma_b1(acc, da + 2 * ks, db + 2 * ks, (first && ks == 0) ? 0 : 1);
}

// Accumulator i of a thread is the count of row acc_row(i) and column
// acc_col(i) of the warpgroup's 64 x 128 tile (t = thread in the warpgroup):
// a warp owns 16 rows, a quad of lanes one row pair (r, r + 8), a lane two
// neighbouring columns in every block of 8.
__device__ __forceinline__ int acc_row(int i, int t) {
  return (t >> 5) * 16 + ((t & 31) >> 2) + ((i >> 1) & 1) * 8;
}

__device__ __forceinline__ int acc_col(int i, int t) {
  return (i >> 2) * 8 + (t & 3) * 2 + (i & 1);
}

}  // namespace rad_mma
