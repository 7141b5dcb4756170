// AnEn analog-similarity distance for Hopper (sm_90a).
//
//   d2[h, n] = sum_v (f_hist[h, v, n] - f_now[v, n])^2
//
// Replaces the Pallas TPU kernel kernels/anen_distance.py::anen_distance
// of the JAX package (body _distance_kernel, pallas_call at :81).
//
// Bound: memory. The function reads f_hist (H*V*N) and f_now (V*N) once
// and writes d2 (H*N), all f32: 4*(H*V*N + V*N + H*N) bytes against
// 3*H*V*N flops. At the AnEn main path's (365, 3, 1024) that is about
// 6.0 MB, about 1.8 us at 3.35 TB/s, so one launch is dominated by launch
// latency rather than by the bytes.
//
// Design: one pass over f_hist and no (H, V, N) temporary beyond the
// input. One thread owns one column n: it loads f_now[:, n] into
// registers once and walks a run of rows_per_block rows of h, so every
// load and store is coalesced along the contiguous N axis. The grid is
// (ceil(N / 128), ceil(H / rows_per_block)) and the kernel masks the
// ragged edges itself: no padding and no slicing back, since Hopper has no
// (8, 128) tile to honour. The sum runs in the Pallas body's order
// (v = 0..V-1, acc = acc + d*d) with round-to-nearest intrinsics, so nvcc
// contracts nothing into an FMA and the result is bit-equal to the plain
// PyTorch loop in anen_distance.py.
//
// Fusing the location gather f_hist[:, :, ys, xs] into these loads is
// left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxVars = 16;

__global__ void anen_distance_kernel(const float* __restrict__ f_hist,
                                     const float* __restrict__ f_now,
                                     float* __restrict__ out,
                                     int H, int V, int N,
                                     int rows_per_block) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float fn[kMaxVars];
#pragma unroll
  for (int v = 0; v < kMaxVars; ++v) {
    fn[v] = v < V ? f_now[static_cast<size_t>(v) * N + n] : 0.0f;
  }
  const int h0 = blockIdx.y * rows_per_block;
  const int h1 = min(h0 + rows_per_block, H);
  for (int h = h0; h < h1; ++h) {
    const float* row = f_hist + static_cast<size_t>(h) * V * N + n;
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < kMaxVars; ++v) {
      if (v < V) {
        const float d = __fsub_rn(row[static_cast<size_t>(v) * N], fn[v]);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
    }
    out[static_cast<size_t>(h) * N + n] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes (V <= 16), types and contiguity.
extern "C" int anen_distance_launch(const float* f_hist, const float* f_now,
                                    float* out, int H, int V, int N,
                                    int rows_per_block, void* stream) {
  if (H <= 0 || N <= 0) return 0;
  if (V < 1 || V > kMaxVars || rows_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kThreads - 1) / kThreads,
                  (H + rows_per_block - 1) / rows_per_block);
  anen_distance_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      f_hist, f_now, out, H, V, N, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
