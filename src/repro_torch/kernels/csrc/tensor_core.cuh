// Warp-level tensor-core and async-copy helpers shared by the bf16 kernels
// (flash attention, SSD and WKV, forward and backward), as inline PTX for
// sm_90a.
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

// x0, x1 as bf16 pairs hi and lo with x = hi + lo to about 16 bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// Two neighbouring bf16 values (4-byte aligned) as f32, and a packed pair
// stored.
__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ void st_bf16x2(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// Fragments from bf16 tiles in shared memory (row pitch a multiple of 8
// elements; m0, n0, k0 multiples of 8), through ldmatrix:
//   lda:   A (16 x 16) at rows m0.., columns k0.. of a row-major (m, k) tile;
//   lda_t: the same of the transpose of a row-major (k, m) tile;
//   ldb:   B of two 8-column tiles, columns n0.. and n0 + 8.. (b[0], b[1]
//          then b[2], b[3]), k0..k0+15, from a row-major (n, k) tile;
//   ldb_t: the same from a row-major (k, n) tile.
__device__ __forceinline__ void lda(uint32_t (&a)[4],
                                    const __nv_bfloat16* tile, int pitch,
                                    int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (m0 + (lane & 15)) * pitch + k0 + (lane >> 4) * 8);
}

__device__ __forceinline__ void lda_t(uint32_t (&a)[4],
                                      const __nv_bfloat16* tile, int pitch,
                                      int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(a, tile + (k0 + (lane >> 4) * 8 + (lane & 7)) * pitch + m0 +
                       ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void ldb(uint32_t (&b)[4],
                                    const __nv_bfloat16* tile, int pitch,
                                    int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * pitch + k0 +
                 ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void ldb_t(uint32_t (&b)[4],
                                      const __nv_bfloat16* tile, int pitch,
                                      int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * pitch +
                       n0 + (lane >> 4) * 8);
}

// acc[2 i], acc[2 i + 1] += a . (b[i][0..1], b[i][2..3]) for i < kN.
template <int kN>
__device__ __forceinline__ void mma_pairs(float (*acc)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    mma_bf16(acc[2 * i], a, b[i][0], b[i][1]);
    mma_bf16(acc[2 * i + 1], a, b[i][2], b[i][3]);
  }
}

// The A fragment of k step kk of a 16-row block held as C tiles (c0 the
// tile of columns 16 kk.., c1 that of 16 kk + 8..), split into hi and lo.
__device__ __forceinline__ void c_to_a_split(const float (&c0)[4],
                                             const float (&c1)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// C tiles acc[j] of a 16-row block (rows r0 + g and r0 + g + 8, columns
// 8 j + 2 t..) into bf16 tiles hi and lo (x = hi + lo) at rows r0...
template <int kNT>
__device__ __forceinline__ void store_split(const float (*acc)[4],
                                            __nv_bfloat16* hi,
                                            __nv_bfloat16* lo, int pitch,
                                            int r0) {
  const int lane = threadIdx.x & 31;
  const int off = (r0 + (lane >> 2)) * pitch + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    uint32_t h, l;
    split_bf16(acc[j][0], acc[j][1], h, l);
    *reinterpret_cast<uint32_t*>(hi + off + 8 * j) = h;
    *reinterpret_cast<uint32_t*>(lo + off + 8 * j) = l;
    split_bf16(acc[j][2], acc[j][3], h, l);
    *reinterpret_cast<uint32_t*>(hi + off + 8 * j + 8 * pitch) = h;
    *reinterpret_cast<uint32_t*>(lo + off + 8 * j + 8 * pitch) = l;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Row sums of a warp's 8 rows, lane l holding dp[i] of row i (its own
// columns), by a fixed tree of shuffles: halving over lane bits 16, 8, 4
// leaves lane l row row8_of(l) = 4 b4 + 2 b3 + b2 (b the bits of l) summed
// over 8 lanes, then bits 2 and 1 finish it. Returns that row's sum (the
// same in the four lanes of a quad); dp is overwritten.
__device__ __forceinline__ int row8_of(int lane) {
  return 4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1);
}

template <int kW, int kBit>
__device__ __forceinline__ void halve_rows(float (&dp)[8], int lane) {
  const bool upper = (lane & kBit) != 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const float send = upper ? dp[i] : dp[i + kW];
    const float keep = upper ? dp[i + kW] : dp[i];
    dp[i] = keep + __shfl_xor_sync(0xffffffffu, send, kBit);
  }
}

__device__ __forceinline__ float row_sums8(float (&dp)[8]) {
  const int lane = threadIdx.x & 31;
  halve_rows<4, 16>(dp, lane);
  halve_rows<2, 8>(dp, lane);
  halve_rows<1, 4>(dp, lane);
  const float sum = dp[0] + __shfl_xor_sync(0xffffffffu, dp[0], 2);
  return sum + __shfl_xor_sync(0xffffffffu, sum, 1);
}

// The sum over the 8 lanes g of one t (the rows of a C tile's column).
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
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
