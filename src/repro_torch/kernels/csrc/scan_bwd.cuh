// Pieces shared by the bf16 routes of the SSD and WKV backward kernels
// (mamba2_ssd_bwd.cu, rwkv6_wkv_bwd.cu): the load of a chunk's start state
// S and its end state's gradient dS' into bf16 hi + lo tiles, and f32 pair
// stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace scan {

// Four consecutive f32 of a (rows, cols) state from element i: one 16-byte
// load where cols % 4 == 0 (so the four share a row), else four (zeros
// past n_elems).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int i,
                                        int n_elems, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p + i);
  float4 v;
  v.x = i < n_elems ? p[i] : 0.0f;
  v.y = i + 1 < n_elems ? p[i + 1] : 0.0f;
  v.z = i + 2 < n_elems ? p[i + 2] : 0.0f;
  v.w = i + 3 < n_elems ? p[i + 3] : 0.0f;
  return v;
}

// A chunk's S and dS' (f32, rows x cols, row-major at s and d) into bf16 hi
// and lo tiles (kD x kD, pitch kD + 8, zeros past rows and cols), and each
// row's sum of S o dS' into rowsum[0..kD). A thread takes four consecutive
// elements (16-byte loads where cols % 4 == 0), up to four such loads of
// each in flight; the kD / 4 threads of a row sum it by shuffles.
template <int kD, int kThreads>
__device__ __forceinline__ void load_states(
    const float* __restrict__ s, const float* __restrict__ d, int rows,
    int cols, __nv_bfloat16* s_hi, __nv_bfloat16* s_lo, __nv_bfloat16* d_hi,
    __nv_bfloat16* d_lo, float* rowsum) {
  constexpr int kPitch = kD + 8;
  constexpr int kQ = kD / 4;                  // quads a row
  constexpr int kQuads = kD * kQ;
  constexpr int kPer = (kQuads + kThreads - 1) / kThreads;
  constexpr int kBatch = kPer < 4 ? kPer : 4;
  const bool vec = cols % 4 == 0;
#pragma unroll
  for (int q0 = 0; q0 < kPer; q0 += kBatch) {
    float4 sv[kBatch], dv[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i4 = threadIdx.x + (q0 + q) * kThreads;
      const int n = i4 / kQ;
      const int m = 4 * (i4 - n * kQ);
      sv[q] = dv[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i4 < kQuads && n < rows && m < cols) {
        const int o = n * cols + m;
        const int end = n * cols + cols;
        sv[q] = load4(s, o, end, vec);
        dv[q] = load4(d, o, end, vec);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i4 = threadIdx.x + (q0 + q) * kThreads;
      const int n = i4 / kQ;
      const int m = 4 * (i4 - n * kQ);
      float part = fmaf(sv[q].x, dv[q].x, fmaf(sv[q].y, dv[q].y,
                   fmaf(sv[q].z, dv[q].z, sv[q].w * dv[q].w)));
      if (i4 < kQuads) {
        uint32_t h0, l0, h1, l1;
        const int o = n * kPitch + m;
        tc::split_bf16(sv[q].x, sv[q].y, h0, l0);
        tc::split_bf16(sv[q].z, sv[q].w, h1, l1);
        *reinterpret_cast<uint2*>(s_hi + o) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(s_lo + o) = make_uint2(l0, l1);
        tc::split_bf16(dv[q].x, dv[q].y, h0, l0);
        tc::split_bf16(dv[q].z, dv[q].w, h1, l1);
        *reinterpret_cast<uint2*>(d_hi + o) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(d_lo + o) = make_uint2(l0, l1);
      }
#pragma unroll
      for (int off = 1; off < kQ; off <<= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (i4 < kQuads && m == 0) rowsum[n] = part;
    }
  }
}

// Two neighbouring f32 values (columns col, col + 1 of a row at p) where
// they fall within cols: one 8-byte store where cols is even.
__device__ __forceinline__ void store_pair(float* __restrict__ p, int col,
                                           int cols, float v0, float v1) {
  if ((cols & 1) == 0) {
    if (col < cols) *reinterpret_cast<float2*>(p + col) = make_float2(v0, v1);
  } else {
    if (col < cols) p[col] = v0;
    if (col + 1 < cols) p[col + 1] = v1;
  }
}

}  // namespace scan
