// AnEn analog-similarity distance for Hopper (sm_90a).
//
//   d2[h, n] = sum_v (f_hist[h, v, n] - f_now[v, n])^2
//
// Replaces the Pallas TPU kernel kernels/anen_distance.py::anen_distance
// of the JAX package (body _distance_kernel, pallas_call at :81).
//
// Bound: memory. The function reads f_hist (H*V*N) and f_now (V*N) once
// and writes d2 (H*N), all f32: 4*(H*V*N + V*N + H*N) bytes against
// 3*H*V*N flops. At the AnEn main path's (365, 3, 512) that is about
// 3.0 MB, about 0.9 us at 3.35 TB/s, so one launch costs about as much as
// its launch latency. What keeps a small launch from that bound is the
// latency of its loads: a thread that walks rows one dependent load after
// another, in a grid of a few warps an SM, waits on memory most of the
// time.
//
// Design: one pass over f_hist, no (H, V, N) temporary beyond the input,
// and every load of a thread independent of the others. One thread owns
// one row h and four neighbouring columns n..n+3: it issues its V loads of
// f_hist and of f_now at once (16 bytes each where N % 4 == 0 and the
// pointers are 16-byte aligned; else four masked scalar loads), reads the
// f_now quad straight from memory (L1 and L2 serve the reuse across rows),
// and writes its four sums with one 16-byte store. The grid is one thread
// per (h, column quad), linear over h * ceil(N / 4) with neighbouring
// threads on neighbouring quads of a row, so every load and store is
// coalesced along the contiguous N axis; at (365, 3, 512) that is 46,720
// threads. The ragged edge is masked in the kernel: no padding and no
// slicing back, since Hopper has no (8, 128) tile to honour. The sum runs
// in the Pallas body's order (v = 0..V-1, acc = acc + d*d) with
// round-to-nearest intrinsics, so nvcc contracts nothing into an FMA and
// the result is bit-equal to the plain PyTorch loop in anen_distance.py.
//
// Fusing the location gather f_hist[:, :, ys, xs] into these loads would
// change the function the TPU kernel computes, and is left out.

#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVars = 16;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
anen_distance_kernel(const float* __restrict__ f_hist,
                     const float* __restrict__ f_now,
                     float* __restrict__ out, int H, int V, int N,
                     int quads) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(H) * quads) return;
  const int h = static_cast<int>(i / quads);
  const int n = static_cast<int>(i - static_cast<long long>(h) * quads) * 4;
  const float* hist = f_hist + static_cast<size_t>(h) * V * N + n;
  const float* now = f_now + n;
  // no load depends on a sum, so the unrolled loop is free to issue them
  // all before the first subtraction
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int v = 0; v < kMaxVars; ++v) {
    if (v < V) {
      const size_t off = static_cast<size_t>(v) * N;
      float a[4], b[4];
      if (kVec) {
        const float4 x = *reinterpret_cast<const float4*>(hist + off);
        const float4 y = *reinterpret_cast<const float4*>(now + off);
        a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
        b[0] = y.x; b[1] = y.y; b[2] = y.z; b[3] = y.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = n + j < N;
          a[j] = ok ? hist[off + j] : 0.0f;
          b[j] = ok ? now[off + j] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = __fsub_rn(a[j], b[j]);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
      }
    }
  }
  float* o = out + static_cast<size_t>(h) * N + n;
  if (kVec) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n + j < N) o[j] = acc[j];
    }
  }
}

bool use_vec(const float* f_hist, const float* f_now, const float* out,
             int N) {
  return N % 4 == 0 && tc::aligned16(f_hist) && tc::aligned16(f_now) &&
         tc::aligned16(out);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes (V <= 16), types and contiguity.
extern "C" int anen_distance_launch(const float* f_hist, const float* f_now,
                                    float* out, int H, int V, int N,
                                    void* stream) {
  if (H <= 0 || N <= 0) return 0;
  if (V < 1 || V > kMaxVars) return static_cast<int>(cudaErrorInvalidValue);
  const int quads = (N + 3) / 4;
  const long long blocks =
      (static_cast<long long>(H) * quads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_vec(f_hist, f_now, out, N)) {
    anen_distance_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 st>>>(f_hist, f_now, out, H, V, N, quads);
  } else {
    anen_distance_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  st>>>(f_hist, f_now, out, H, V, N, quads);
  }
  return static_cast<int>(cudaGetLastError());
}

// The compiled kernel that N takes with aligned pointers (16-byte loads
// where N % 4 == 0): info[0..5] as tc::kernel_info gives them (registers,
// static and dynamic shared memory, spill bytes, blocks an SM, threads a
// block). Returns a CUDA error code (0 on success).
extern "C" int anen_distance_info(int N, int* info) {
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N % 4 == 0) {
    return tc::kernel_info(anen_distance_kernel<true>, kThreads, 0, info);
  }
  return tc::kernel_info(anen_distance_kernel<false>, kThreads, 0, info);
}
