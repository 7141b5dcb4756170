// Causal flash attention backward for Hopper (sm_90a).
//
// Given q, k, v, out, dout (B, S, H, hd) and the forward's lse (B, S, H):
//
//   delta[b,s,h] = sum_d dout[b,s,h,d] * out[b,s,h,d]
//   P[s,t]       = exp(q[s] . k[t] / sqrt(hd) - lse[s])      (t <= s)
//   dS[s,t]      = P[s,t] * (dout[s] . v[t] - delta[s]) / sqrt(hd)
//   dq = dS k,   dk = dS^T q,   dv = P^T dout
//
// Replaces the backward of the JAX package's flash attention: the
// custom_vjp of kernels/flash_attention.py::flash_attention (_bwd_rule at
// :153) runs models/attention.py::_flash_bwd_impl, the FlashAttention-2
// pairs scan that recomputes P from the saved lse. Sums are f32; dq, dk
// and dv are written in the input dtype (f32 or bf16, the same template).
//
// Bound on an H100 SXM: at qwen2-vl-2b's training shape (B, S, H, hd) =
// (4, 512, 12, 128) in bf16 the function reads q, k, v, out, dout and
// writes dq, dk, dv (8 B S H hd elements, 50.3 MB, plus lse): about 15 us
// at 3.35 TB/s; its five causal products (S, dP, dq, dk, dv) are about 8 us
// on the bf16 tensor cores. This first kernel runs on the CUDA cores in
// f32, where the same products take about 120 us at the f32 peak, and
// recomputes S and dP in both passes (seven products): it is right and
// simple first; mma.sync / wgmma tiles are later work.
//
// Design: three launches, no atomics, so every run gives the same bits.
//  1. delta_kernel: one warp a (b, s, h) row, delta in f32 scratch.
//  2. dkdv_kernel: one block of 256 threads per (b, h, 64-row kv tile).
//     dK and dV (64 x hd) live in registers, 4 rows x kCols columns a
//     thread; the block walks the q tiles at or after its kv tile, stages
//     Q, dO, lse and delta in shared memory, computes the 64 x 64 tiles of
//     P and dS (4 x 4 a thread) and adds P^T dO and dS^T Q.
//  3. dq_kernel: one block per (b, h, 64-row q tile). dQ lives in
//     registers; the block walks the kv tiles up to its last q row, stages
//     K and V, computes dS and adds dS K.
// Tiles are staged as f32 rows with an odd pitch (hd | 1), so the strided
// column reads of a half warp hit 16 banks; at hd 160 a dk/dv block holds
// four 64 x 161 tiles and two 64 x 65 tiles of P and dS, 198,656 bytes of
// dynamic shared memory, and a dq block four 64 x 161 tiles and one 64 x 65
// tile of dS, 182,016 bytes (1 block an SM either way).
//
// The causal mask comes from token positions (kpos <= qpos, and both < S),
// never from tile indices: the Pallas forward's j <= i skip is exact only
// for equal q and kv blocks. The last tile of a ragged S is short: rows
// past S load as zeros, are masked, and are never stored, so any S works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kBlock = 64;            // q and kv rows a tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kMaxHeadDim = 160;
constexpr int kPPitch = kBlock + 1;
constexpr int kDeltaWarps = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows r0..r0+kBlock-1 of one (b, h) slice into smem as f32; rows at or
// past S are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t base, size_t row_stride, int r0,
                                      int S, int hd, int pitch) {
  for (int i = threadIdx.x; i < kBlock * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int s = r0 + r;
    dst[r * pitch + d] =
        s < S ? to_f32(src[base + static_cast<size_t>(s) * row_stride + d])
              : 0.0f;
  }
}

// lse and delta of rows r0..r0+kBlock-1 (0 past S)
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int b, int h, int r0, int S,
                                           int H) {
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    const int s = r0 + r;
    const size_t at = (static_cast<size_t>(b) * S + s) * H + h;
    lse_s[r] = s < S ? lse[at] : 0.0f;
    delta_s[r] = s < S ? delta[at] : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kDeltaWarps)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int hd) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kDeltaWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(row) * hd;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) {
    acc = fmaf(to_f32(dout[base + d]), to_f32(out[base + d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[row] = acc;
}

// The 4 x 4 scores s = a . b^T and c = e . f^T of thread (ty, tx): rows
// ty*4+i of a and e, rows tx+16j of b and f (both tiles kBlock x hd).
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* e, const float* f,
                                             int hd, int pitch, int ty,
                                             int tx, float (&s)[4][4],
                                             float (&c)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = c[i][j] = 0.0f;
  for (int d = 0; d < hd; ++d) {
    float av[4], bv[4], ev[4], fv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty * 4 + i) * pitch + d];
      ev[i] = e[(ty * 4 + i) * pitch + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b[(tx + 16 * j) * pitch + d];
      fv[j] = f[(tx + 16 * j) * pitch + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        c[i][j] = fmaf(ev[i], fv[j], c[i][j]);
      }
  }
}

// From the raw scores qk and dp = dO . v of a 4 x 4 patch (q rows q0 +
// ty*4 + i, kv rows k0 + tx + 16j): P and dS, masked to 0 off the causal
// triangle and past S.
__device__ __forceinline__ void p_and_ds(float (&qk)[4][4], float (&dp)[4][4],
                                         const float* lse_s,
                                         const float* delta_s, int q0, int k0,
                                         int ty, int tx, int S, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool ok = qpos < S && kpos <= qpos;
      const float p = ok ? expf(qk[i][j] * scale - lse_s[r]) : 0.0f;
      qk[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[r]) * scale;
    }
  }
}

template <int kCols>
__device__ __forceinline__ void zero(float (&acc)[4][kCols]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
}

// acc[i][c] += sum_r m[r][ty*4+i] * x[r][tx+16c] over r < n (m^T x), or
// with `transpose` false, sum_r m[ty*4+i][r] * x[r][tx+16c] (m x).
template <int kCols, bool kTranspose>
__device__ __forceinline__ void add_product(float (&acc)[4][kCols],
                                            const float* m, const float* x,
                                            int n, int hd, int pitch, int ty,
                                            int tx) {
  for (int r = 0; r < n; ++r) {
    float xv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      xv[c] = col < hd ? x[r * pitch + col] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mv = kTranspose ? m[r * kPPitch + ty * 4 + i]
                                  : m[(ty * 4 + i) * kPPitch + r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(mv, xv[c], acc[i][c]);
    }
  }
}

template <typename T, int kCols>
__device__ __forceinline__ void store(T* __restrict__ dst,
                                      const float (&acc)[4][kCols],
                                      size_t base, size_t row_stride, int r0,
                                      int S, int hd, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = r0 + ty * 4 + i;
    if (s >= S) continue;
    const size_t row = base + static_cast<size_t>(s) * row_stride;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) put(dst + row + col, acc[i][c]);
    }
  }
}

// Four hd-wide tiles, `p_tiles` 64 x 64 tiles (P and dS for dk/dv, dS
// for dq), and the lse and delta rows.
size_t tiles_smem_bytes(int pitch, int p_tiles) {
  return sizeof(float) * (4 * static_cast<size_t>(kBlock) * pitch +
                          p_tiles * kBlock * kPPitch + 2 * kBlock);
}
size_t dkdv_smem_bytes(int pitch) { return tiles_smem_bytes(pitch, 2); }
size_t dq_smem_bytes(int pitch) { return tiles_smem_bytes(pitch, 1); }

// kCols: output columns a thread, kMaxHeadDim / 16 at most (8 up to hd
// 128, 10 above)
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int H, int hd,
            int pitch, float scale) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBlock * pitch;
  float* q_s = v_s + kBlock * pitch;
  float* do_s = q_s + kBlock * pitch;
  float* p_s = do_s + kBlock * pitch;     // kBlock x kPPitch
  float* ds_s = p_s + kBlock * kPPitch;
  float* lse_s = ds_s + kBlock * kPPitch;
  float* delta_s = lse_s + kBlock;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int k0 = blockIdx.x * kBlock;
  const size_t row_stride = static_cast<size_t>(H) * hd;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * hd;

  stage(k_s, k, base, row_stride, k0, S, hd, pitch);
  stage(v_s, v, base, row_stride, k0, S, hd, pitch);
  float dk_acc[4][kCols], dv_acc[4][kCols];
  zero(dk_acc);
  zero(dv_acc);

  // the q tiles whose rows reach this kv tile: from the one holding row k0
  for (int q0 = k0; q0 < S; q0 += kBlock) {
    __syncthreads();   // the previous tile's reads of Q, dO, P, dS are done
    stage(q_s, q, base, row_stride, q0, S, hd, pitch);
    stage(do_s, dout, base, row_stride, q0, S, hd, pitch);
    stage_rows(lse_s, delta_s, lse, delta, b, h, q0, S, H);
    __syncthreads();

    float qk[4][4], dp[4][4];
    two_products(q_s, k_s, do_s, v_s, hd, pitch, ty, tx, qk, dp);
    p_and_ds(qk, dp, lse_s, delta_s, q0, k0, ty, tx, S, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(ty * 4 + i) * kPPitch + tx + 16 * j] = qk[i][j];
        ds_s[(ty * 4 + i) * kPPitch + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();

    const int n = min(kBlock, S - q0);
    add_product<kCols, true>(dv_acc, p_s, do_s, n, hd, pitch, ty, tx);
    add_product<kCols, true>(dk_acc, ds_s, q_s, n, hd, pitch, ty, tx);
  }
  store(dk, dk_acc, base, row_stride, k0, S, hd, ty, tx);
  store(dv, dv_acc, base, row_stride, k0, S, hd, ty, tx);
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int H, int hd, int pitch, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBlock * pitch;
  float* k_s = do_s + kBlock * pitch;
  float* v_s = k_s + kBlock * pitch;
  float* ds_s = v_s + kBlock * pitch;     // kBlock x kPPitch
  float* lse_s = ds_s + kBlock * kPPitch;
  float* delta_s = lse_s + kBlock;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  // heaviest q tiles first: tile i reads i + 1 kv tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const size_t row_stride = static_cast<size_t>(H) * hd;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * hd;

  stage(q_s, q, base, row_stride, q0, S, hd, pitch);
  stage(do_s, dout, base, row_stride, q0, S, hd, pitch);
  stage_rows(lse_s, delta_s, lse, delta, b, h, q0, S, H);
  float dq_acc[4][kCols];
  zero(dq_acc);

  const int kv_end = min(S, q0 + kBlock);   // past the tile's last q row
  for (int k0 = 0; k0 < kv_end; k0 += kBlock) {
    __syncthreads();   // the previous tile's reads of K, V, dS are done
    stage(k_s, k, base, row_stride, k0, S, hd, pitch);
    stage(v_s, v, base, row_stride, k0, S, hd, pitch);
    __syncthreads();

    float qk[4][4], dp[4][4];
    two_products(q_s, k_s, do_s, v_s, hd, pitch, ty, tx, qk, dp);
    p_and_ds(qk, dp, lse_s, delta_s, q0, k0, ty, tx, S, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty * 4 + i) * kPPitch + tx + 16 * j] = dp[i][j];
    __syncthreads();

    add_product<kCols, false>(dq_acc, ds_s, k_s, min(kBlock, S - k0), hd,
                              pitch, ty, tx);
  }
  store(dq, dq_acc, base, row_stride, q0, S, hd, ty, tx);
}

// Dispatch on the columns a thread: 8 up to hd 128, 10 above.
template <typename Fn>
int with_cols(int hd, Fn&& fn) {
  if (hd <= 128) return fn(std::integral_constant<int, 8>{});
  return fn(std::integral_constant<int, 10>{});
}

template <typename T, int kCols>
int set_smem(int pitch) {
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkdv_smem_bytes(pitch)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<T, kCols>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem_bytes(pitch)));
  return static_cast<int>(err);
}

template <typename T, int kCols>
int launch(const void* q, const void* k, const void* v, const void* out,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int B, int S, int H, int hd, cudaStream_t stream) {
  const int pitch = hd | 1;  // odd: conflict-free strided column reads
  int err = set_smem<T, kCols>(pitch);
  if (err != 0) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const long long rows = static_cast<long long>(B) * S * H;
  const unsigned delta_blocks =
      static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps);
  delta_kernel<T><<<delta_blocks, 32 * kDeltaWarps, 0, stream>>>(
      static_cast<const T*>(out), dot, delta, rows, hd);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const dim3 grid((S + kBlock - 1) / kBlock, B * H);
  dkdv_kernel<T, kCols>
      <<<grid, kThreads, dkdv_smem_bytes(pitch), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, hd, pitch, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dq_kernel<T, kCols><<<grid, kThreads, dq_smem_bytes(pitch), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S, H, hd, pitch,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv: (B, S, H, hd) contiguous, f32 (dtype 0)
// or bf16 (dtype 1); lse and the scratch delta: (B, S, H) f32. Three
// launches on `stream` (delta, dk/dv, dq); returns the first non-zero
// cudaGetLastError() (0 on success). The caller checks shapes, types and
// contiguity.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int B, int S, int H, int hd, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd < 1 || hd > kMaxHeadDim || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return with_cols(hd, [&](auto cols) {
      return launch<float, decltype(cols)::value>(
          q, k, v, out, lse, dout, dq, dk, dv, delta, B, S, H, hd, st);
    });
  }
  if (dtype == 1) {
    return with_cols(hd, [&](auto cols) {
      return launch<__nv_bfloat16, decltype(cols)::value>(
          q, k, v, out, lse, dout, dq, dk, dv, delta, B, S, H, hd, st);
    });
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The compiled dk/dv kernel (which = 0) or dq kernel (which = 1) of the
// route that `dtype` takes at head dim `hd`: info[0..5] as tc::kernel_info
// gives them. Returns a CUDA error code (0 on success).
extern "C" int flash_attention_bwd_info(int hd, int dtype, int which,
                                        int* info) {
  if (hd < 1 || hd > kMaxHeadDim || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pitch = hd | 1;
  auto one = [&](auto tag, auto cols) {
    using T = typename decltype(tag)::type;
    constexpr int kCols = decltype(cols)::value;
    int err = set_smem<T, kCols>(pitch);
    if (err != 0) return err;
    if (which == 0) {
      return tc::kernel_info(dkdv_kernel<T, kCols>, kThreads,
                             dkdv_smem_bytes(pitch), info);
    }
    return tc::kernel_info(dq_kernel<T, kCols>, kThreads,
                           dq_smem_bytes(pitch), info);
  };
  return with_cols(hd, [&](auto cols) {
    if (dtype == 0) return one(std::common_type<float>{}, cols);
    return one(std::common_type<__nv_bfloat16>{}, cols);
  });
}
