// Warp-level tensor-core and async-copy helpers shared by the bf16 kernels
// (flash_attention.cu, mamba2_ssd.cu), as inline PTX for sm_90a.
//
// mma.sync.m16n8k16 (bf16 operands, f32 sums), one warp each. Fragments,
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major), 4 registers of 2 bf16: a0 = (g, 2t..2t+1),
//     a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..);
//   B (16 x 8, k x n), 2 registers: b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., g);
//   C (16 x 8, f32), 4 registers: c0, c1 = (g, 2t), (g, 2t+1);
//     c2, c3 = (g + 8, 2t), (g + 8, 2t+1).
// Two neighbouring C tiles of one row block are, rounded to bf16, the A
// fragment of one 16-deep k step: P = softmax(S) feeds P.V without leaving
// registers.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices from shared memory; lanes
// 8m..8m+7 give the row addresses of matrix m, each row 16 contiguous
// bytes. Without .trans, register m of a lane holds row g, columns 2t..2t+1
// of matrix m; with .trans, rows 2t..2t+1 of column g.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared, asynchronous, zero-filling as above.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// d += a . b on the tensor cores: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows r0..r0+kRows-1 (columns 0..kCols-1) of a bf16 matrix in global
// memory, whose row r starts at src + r * row_stride, into shared memory
// at dst with a pitch of kPitch elements. Rows at or past n_rows and
// columns at or past n_cols are zeros. With `vec` (n_cols and row_stride
// multiples of 8 and src 16-byte aligned) the copy is 16-byte cp.async,
// to be waited for by the caller; otherwise element by element.
template <int kRows, int kCols, int kPitch, int kThreads>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          size_t row_stride, int r0,
                                          int n_rows, int n_cols, bool vec) {
  if (vec) {
    constexpr int kPieces = kCols / 8;
    for (int i = threadIdx.x; i < kRows * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int col = (i - r * kPieces) * 8;
      const bool ok = r0 + r < n_rows && col < n_cols;
      const __nv_bfloat16* from =
          ok ? src + static_cast<size_t>(r0 + r) * row_stride + col : src;
      cp_async16(dst + r * kPitch + col, from, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols;
      const int col = i - r * kCols;
      dst[r * kPitch + col] =
          r0 + r < n_rows && col < n_cols
              ? src[static_cast<size_t>(r0 + r) * row_stride + col]
              : __float2bfloat16_rn(0.0f);
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// What the compiler and the card made of a kernel, for a launch of
// `threads` threads and `smem` bytes of dynamic shared memory: info[0]
// registers a thread, [1] static and [2] dynamic shared memory a block,
// [3] local (spill) bytes a thread, [4] blocks resident on one SM, [5]
// threads a block. The caller has set the dynamic shared-memory limit.
template <typename Kernel>
int kernel_info(Kernel* kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes);
  info[2] = static_cast<int>(smem);
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = blocks;
  info[5] = threads;
  return 0;
}

}  // namespace tc
