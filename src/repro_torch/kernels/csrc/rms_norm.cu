// Residual add and RMSNorm for Hopper (sm_90a), in one pass.
//
//   h = bf16(x + delta)                                     (with delta)
//   y = bf16((h_f32 * rsqrt(mean(h_f32^2) + eps)) * scale)
//
// over the rows of x (rows, D) bf16, scale (D,) f32. Without delta, h is x
// itself and only y is written: the plain norm.
//
// Replaces no Pallas kernel: the JAX package leaves the models' pre-norms
// (src/repro/models/mlp.py::rms_norm) to XLA, which fuses the residual
// add, the f32 upcast, the sum of squares, the rsqrt and both products
// into one pass. In eager PyTorch the same arithmetic is eight launches a
// norm (upcast, square, mean, + eps, rsqrt, two broadcast products,
// downcast) and one more for the residual add, each over the whole (rows,
// D) tensor, with f32 intermediates: about 44 bytes of traffic an element
// plus 6 for the add. This kernel is that chain and the add as one launch.
//
// Bound: memory. The kernel reads x (and delta) and writes y (and h), 2
// bytes each, once: 8 bytes an element with delta, 4 without, against
// about 5 f32 operations an element. At (8192, 4096) that is 268 MB with
// delta (0.080 ms at 3.35 TB/s) and 134 MB without (0.040 ms); scale (16
// KB) stays in L2 and L1.
//
// Design: one block a row; each thread owns kVpt 16-byte vectors of it
// (8 bf16 each), neighbouring threads on neighbouring vectors, so every
// load and store is a coalesced 16-byte access. A thread issues all its
// loads before its first operation, keeps its part of the row in registers
// as packed bf16 (h is rounded to bf16 before the norm reads it, so no f32
// copy is kept) between the reduction and the write, and so reads each
// byte once. The sum of squares is a warp's xor tree of shuffles, then one
// shared word a warp, summed in warp order by every thread: a fixed order,
// so a second call gives the same bits. scale is read through the
// read-only path. Blocks: with many rows (more than kWideRows) a block of
// at most 128 threads, kVpt = 1, 2, 4 or 8 vectors a thread (4 at D =
// 4096: 55 registers, 9 blocks an SM, 4 or 8 loads of 16 bytes in flight
// a thread); with a few rows (the final norm of a prefill, decode) one
// vector a thread and up to 1024 threads a row, so the few blocks still
// spread their loads. Two rows a block, 256-thread blocks, the scale
// loaded before the reduction, evict-first or L2-prefetch loads and a
// floor on blocks an SM (which spills) all timed within 2 % of this at
// (8192, 4096) on an H100, or slower.
//
// Arithmetic: the plain chain's, in its order. h is the f32 sum of the two
// bf16 values rounded once to bf16 (what `x + delta` gives in PyTorch);
// each square is rounded to f32 before it is added (__fmul_rn, __fadd_rn:
// no contraction into an FMA, as the chain materialises xf * xf); the mean
// is the sum times fl(1 / D), as PyTorch's mean multiplies by its factor;
// rsqrtf is the rsqrt PyTorch's CUDA kernel calls; the products run in the
// chain's order (h * r) * scale, each rounded to f32, then once to bf16.
// Only the order in which the squares are summed differs from PyTorch's
// reduction, which moves y by at most one bf16 ulp; h has the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kVec = 8;             // bf16 values in a 16-byte vector
constexpr int kMaxD = 8192;         // at most 1024 vectors a row
constexpr int kNarrowThreads = 128;  // a block's threads with many rows
constexpr int kWideRows = 264;      // up to this many rows: one vector a
                                    // thread (two rows an SM)

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = tc::unpack_bf16(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[kVec]) {
  return make_uint4(tc::pack_bf16(f[0], f[1]), tc::pack_bf16(f[2], f[3]),
                    tc::pack_bf16(f[4], f[5]), tc::pack_bf16(f[6], f[7]));
}

template <int kVpt, bool kDelta>
__global__ void __launch_bounds__(kVpt == 1 ? 1024 : kNarrowThreads)
rms_norm_kernel(const __nv_bfloat16* __restrict__ x, long long x_stride,
                const __nv_bfloat16* __restrict__ delta, long long d_stride,
                const float* __restrict__ scale,
                __nv_bfloat16* __restrict__ h_out,
                __nv_bfloat16* __restrict__ y, int D, float inv_d,
                float eps) {
  __shared__ float warp_ss[32];
  const long long row = blockIdx.x;
  const int n_vec = D / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_stride);
  uint4 hv[kVpt];
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    hv[k] = v < n_vec ? xr[v] : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (kDelta) {
    const uint4* dr =
        reinterpret_cast<const uint4*>(delta + row * d_stride);
    uint4 dv[kVpt];
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      const int v = threadIdx.x + k * blockDim.x;
      dv[k] = v < n_vec ? dr[v] : make_uint4(0u, 0u, 0u, 0u);
    }
    uint4* hr = reinterpret_cast<uint4*>(h_out + row * D);
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      float a[kVec], b[kVec];
      unpack8(hv[k], a);
      unpack8(dv[k], b);
#pragma unroll
      for (int i = 0; i < kVec; ++i) a[i] = __fadd_rn(a[i], b[i]);
      hv[k] = pack8(a);
      const int v = threadIdx.x + k * blockDim.x;
      if (v < n_vec) hr[v] = hv[k];
    }
  }
  // masked vectors hold zeros and add nothing
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    float f[kVec];
    unpack8(hv[k], f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));
  }
  ss = tc::warp_sum(ss);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_ss[warp] = ss;
  __syncthreads();
  float total = 0.0f;
  const int n_warps = blockDim.x / 32;
  for (int w = 0; w < n_warps; ++w) total = __fadd_rn(total, warp_ss[w]);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_d), eps));
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    if (v < n_vec) {
      const float4 s0 = __ldg(s4 + 2 * v);
      const float4 s1 = __ldg(s4 + 2 * v + 1);
      const float s[kVec] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float f[kVec];
      unpack8(hv[k], f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        f[i] = __fmul_rn(__fmul_rn(f[i], r), s[i]);
      }
      yr[v] = pack8(f);
    }
  }
}

struct Config {
  int vpt;
  int threads;
};

// The block a launch takes: with few rows one vector a thread; else the
// fewest vectors a thread (1, 2, 4 or 8) that keep a block at or under
// kNarrowThreads. Threads are whole warps.
Config pick(int rows, int D) {
  const int n_vec = D / kVec;
  int vpt = 1;
  if (rows > kWideRows) {
    while (vpt < 8 && vpt * kNarrowThreads < n_vec) vpt *= 2;
  }
  const int threads = ((n_vec + vpt - 1) / vpt + 31) / 32 * 32;
  return {vpt, threads};
}

template <int kVpt, bool kDelta>
int launch_as(const Config& c, int rows, const void* x, long long x_stride,
              const void* delta, long long d_stride, const float* scale,
              void* h, void* y, int D, float eps, cudaStream_t st) {
  rms_norm_kernel<kVpt, kDelta><<<rows, c.threads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), x_stride,
      static_cast<const __nv_bfloat16*>(delta), d_stride, scale,
      static_cast<__nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(y), D,
      1.0f / static_cast<float>(D), eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDelta>
int launch_vpt(const Config& c, int rows, const void* x, long long x_stride,
               const void* delta, long long d_stride, const float* scale,
               void* h, void* y, int D, float eps, cudaStream_t st) {
  switch (c.vpt) {
    case 1:
      return launch_as<1, kDelta>(c, rows, x, x_stride, delta, d_stride,
                                  scale, h, y, D, eps, st);
    case 2:
      return launch_as<2, kDelta>(c, rows, x, x_stride, delta, d_stride,
                                  scale, h, y, D, eps, st);
    case 4:
      return launch_as<4, kDelta>(c, rows, x, x_stride, delta, d_stride,
                                  scale, h, y, D, eps, st);
    default:
      return launch_as<8, kDelta>(c, rows, x, x_stride, delta, d_stride,
                                  scale, h, y, D, eps, st);
  }
}

template <bool kDelta>
int info_vpt(const Config& c, int* info) {
  switch (c.vpt) {
    case 1:
      return tc::kernel_info(rms_norm_kernel<1, kDelta>, c.threads, 0, info);
    case 2:
      return tc::kernel_info(rms_norm_kernel<2, kDelta>, c.threads, 0, info);
    case 4:
      return tc::kernel_info(rms_norm_kernel<4, kDelta>, c.threads, 0, info);
    default:
      return tc::kernel_info(rms_norm_kernel<8, kDelta>, c.threads, 0, info);
  }
}

bool shape_ok(int rows, int D) {
  return rows >= 0 && D >= kVec && D <= kMaxD && D % kVec == 0;
}

}  // namespace

// x (rows, D) bf16 with `x_stride` elements between rows; delta likewise
// with `d_stride`, or null for the plain norm; scale (D,) f32; h (rows, D)
// contiguous bf16, null exactly when delta is; y (rows, D) contiguous
// bf16. Every pointer 16-byte aligned and every stride a multiple of 8,
// D a multiple of 8 up to 8192. Launches on `stream` and returns
// cudaGetLastError() (0 on success); a shape or pointer outside those
// limits launches nothing and returns cudaErrorInvalidValue.
extern "C" int rms_norm_launch(const void* x, long long x_stride,
                               const void* delta, long long d_stride,
                               const float* scale, void* h, void* y,
                               int rows, int D, float eps, void* stream) {
  const bool with_delta = delta != nullptr;
  if (!shape_ok(rows, D) || with_delta != (h != nullptr) ||
      x_stride % kVec != 0 || (with_delta && d_stride % kVec != 0) ||
      !tc::aligned16(x) || !tc::aligned16(scale) || !tc::aligned16(y) ||
      (with_delta && (!tc::aligned16(delta) || !tc::aligned16(h)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Config c = pick(rows, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_delta) {
    return launch_vpt<true>(c, rows, x, x_stride, delta, d_stride, scale, h,
                            y, D, eps, st);
  }
  return launch_vpt<false>(c, rows, x, x_stride, delta, d_stride, scale, h,
                           y, D, eps, st);
}

// The compiled kernel that (rows, D) takes, with or without delta:
// info[0..5] as tc::kernel_info gives them (registers, static and dynamic
// shared memory, spill bytes, blocks an SM, threads a block). Returns a
// CUDA error code (0 on success).
extern "C" int rms_norm_info(int rows, int D, int with_delta, int* info) {
  if (!shape_ok(rows, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Config c = pick(rows, D);
  return with_delta ? info_vpt<true>(c, info) : info_vpt<false>(c, info);
}
