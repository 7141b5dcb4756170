// Flash attention backward for Hopper (sm_90a), causal or full.
//
// Given q, k, v, out, dout (B, S, H, hd) and the forward's lse (B, S, H):
//
//   delta[b,s,h] = sum_d dout[b,s,h,d] * out[b,s,h,d]
//   P[s,t]       = exp(q[s] . k[t] / sqrt(hd) - lse[s])
//                  (t <= s when causal, every t < S when not)
//   dS[s,t]      = P[s,t] * (dout[s] . v[t] - delta[s]) / sqrt(hd)
//   dq = dS k,   dk = dS^T q,   dv = P^T dout
//
// Replaces the backward of the JAX package's flash attention: the
// custom_vjp of kernels/flash_attention.py::flash_attention (_bwd_rule at
// :153) runs models/attention.py::_flash_bwd_impl, the FlashAttention-2
// pairs scan that recomputes P from the saved lse. That backward always
// applies the causal mask, so its gradient of causal=False is wrong
// (ROADMAP.md C15); this one is the gradient of the forward it follows for
// both values. Sums are f32; dq, dk and dv are written in the input dtype,
// rounded once.
//
// Bound on an H100 SXM: at qwen2-vl-2b's training shape (B, S, H, hd) =
// (4, 512, 12, 128) in bf16 the function reads q, k, v, out, dout and
// writes dq, dk, dv (8 B S H hd elements, 50.3 MB, plus lse): about 15 us
// at 3.35 TB/s; its five causal products (S, dP, dq, dk, dv) are about 8 us
// on the bf16 tensor cores, and the seven that this design runs (S and dP
// twice) about 11 us. On the CUDA cores in f32 the same products take
// about 170 us at the f32 peak.
//
// Both routes take three launches and no atomics, so every run gives the
// same bits: delta; dk/dv (one block per (b, h, 64-row kv tile), walking
// the q tiles at or after it); dq (one block per (b, h, q tile), walking
// the kv tiles up to its last row, heaviest q tiles first). S and dP are
// computed in both of the last two. The dtype alone picks the route.
//
// bf16 route (the train path; delta_tc_kernel, dkdv_tc_kernel,
// dq_tc_kernel): every product on the tensor cores as mma.sync.m16n8k16
// (bf16 operands, f32 sums), 4 warps a block, each warp owning 16 rows of
// the block's own tile.
//  - delta: kTpr threads a row (16 up to hd 128, 32 above), 16-byte loads
//    of out and dout, a shuffle sum.
//  - dk/dv: K and V (64 rows) are loaded once into bf16 shared memory;
//    Q, dO, lse and delta of each q tile come through a two-stage cp.async
//    ring, so tile i + 1 loads while tile i is multiplied. A warp computes
//    S^T = K Q^T and dP^T = V dO^T for its 16 kv rows (K and V as A
//    operands, Q and dO through ldmatrix as B), forms P^T = exp(S^T scale
//    - lse) and dS^T = P^T (dP^T - delta) scale in the C fragments, and
//    packs them to bf16 straight into the A fragments of dV += P^T dO and
//    dK += dS^T Q, whose B operands come through ldmatrix.trans. P and dS
//    never go through shared memory. dK and dV (16 x hdp a warp) stay in
//    registers: hdp f32 registers a thread (128 at hd 128, 160 at hd
//    160). A warp holds 16 q columns of S^T and dP^T at once (kTcSub), 16
//    registers more; at 32 columns ptxas spills at hdp 128. Above hdp 128
//    the q tile of a ring stage is 32 rows, so the block keeps 2 blocks
//    an SM.
//  - dq: Q and dO of the block's 64-row q tile in shared memory, lse and
//    delta in registers; K and V tiles (64 rows, 32 above hdp 128) through
//    the two-stage ring; S = Q K^T and dP = dO V^T on the tensor cores,
//    dS as A fragments into dQ += dS K with K through ldmatrix.trans.
//  - Rounding: q, k, v and dout are exact bf16 operands, so S and dP are
//    as exact as on the CUDA cores; P and dS are rounded to bf16 only as
//    operands, and delta and lse stay f32. The TPU reference multiplies
//    its f32 einsums at the matrix unit's default precision (bf16 passes),
//    so this is no looser (tests/test_torch_tensor_core_rounding.py holds
//    the rounding within the JAX tolerances).
//  - A warp skips a sub-step whose rows all lie above the diagonal or past
//    S. The head dim is padded to a multiple of 16 (hdp) with zeros in
//    shared memory only, rows of hdp + 8 elements (16-byte aligned,
//    ldmatrix conflict-free). Where hd is not a multiple of 8 or an input
//    is not 16-byte aligned, tiles are filled element by element.
//  - Shared memory at hdp 128: 105,472 bytes (dk/dv) and 104,448 (dq), 2
//    blocks of 4 warps an SM; at hdp 160 86,528 and 86,016.
//
// f32 route (delta_kernel, dkdv_kernel, dq_kernel; the first port,
// unchanged): it keeps the f32 gradient tolerance (5e-4), which TF32
// tensor-core products cannot be trusted to meet. One block of 256
// threads per 64-row tile, f32 products on the CUDA cores out of shared
// memory. dK and dV (64 x hd) live in registers, 4 rows x kCols columns a
// thread; the block stages Q, dO, lse and delta (or K and V) in shared
// memory, computes the 64 x 64 tiles of P and dS (4 x 4 a thread) and
// adds the products. Tiles are staged as f32 rows with an odd pitch
// (hd | 1), so the strided column reads of a half warp hit 16 banks; at hd
// 160 a dk/dv block holds four 64 x 161 tiles and two 64 x 65 tiles of P
// and dS, 198,656 bytes of dynamic shared memory, and a dq block four 64
// x 161 tiles and one 64 x 65 tile of dS, 182,016 bytes (1 block an SM).
//
// The causal mask comes from token positions (kpos <= qpos, and both < S),
// never from tile indices: the Pallas forward's j <= i skip is exact only
// for equal q and kv blocks. The last tile of a ragged S is short: rows
// past S load as zeros, are masked, and are never stored, so any S works.
//
// Causal or not is a template parameter (kCausal) of the dk/dv and dq
// kernels of both routes, so the causal instantiations are the code they
// were before the full mode came. Without the causal mask the dk/dv
// kernel walks the q tiles from tile 0 rather than from the one holding
// its first kv row, the dq kernel walks every kv tile, and only positions
// past S are masked. The delta kernels do not depend on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

// --------------------------------------------------------------------------
// f32 route: CUDA cores (the first port, unchanged)
// --------------------------------------------------------------------------

constexpr int kBlock = 64;            // q and kv rows a tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kMaxHeadDim = 160;
constexpr int kPPitch = kBlock + 1;
constexpr int kDeltaWarps = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

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
// triangle (kCausal) and past S.
template <bool kCausal>
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
      const bool ok = qpos < S && (kCausal ? kpos <= qpos : kpos < S);
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
// 128, 10 above); kCausal: the causal mask, else every (q, kv) pair
template <typename T, int kCols, bool kCausal>
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

  // the q tiles whose rows reach this kv tile: causal, from the one
  // holding row k0; full, all of them
  for (int q0 = kCausal ? k0 : 0; q0 < S; q0 += kBlock) {
    __syncthreads();   // the previous tile's reads of Q, dO, P, dS are done
    stage(q_s, q, base, row_stride, q0, S, hd, pitch);
    stage(do_s, dout, base, row_stride, q0, S, hd, pitch);
    stage_rows(lse_s, delta_s, lse, delta, b, h, q0, S, H);
    __syncthreads();

    float qk[4][4], dp[4][4];
    two_products(q_s, k_s, do_s, v_s, hd, pitch, ty, tx, qk, dp);
    p_and_ds<kCausal>(qk, dp, lse_s, delta_s, q0, k0, ty, tx, S, scale);
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

template <typename T, int kCols, bool kCausal>
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

  // causal: past the tile's last q row
  const int kv_end = kCausal ? min(S, q0 + kBlock) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBlock) {
    __syncthreads();   // the previous tile's reads of K, V, dS are done
    stage(k_s, k, base, row_stride, k0, S, hd, pitch);
    stage(v_s, v, base, row_stride, k0, S, hd, pitch);
    __syncthreads();

    float qk[4][4], dp[4][4];
    two_products(q_s, k_s, do_s, v_s, hd, pitch, ty, tx, qk, dp);
    p_and_ds<kCausal>(qk, dp, lse_s, delta_s, q0, k0, ty, tx, S, scale);
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

template <typename T, int kCols, bool kCausal>
int set_smem(int pitch) {
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, kCols, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkdv_smem_bytes(pitch)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<T, kCols, kCausal>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem_bytes(pitch)));
  return static_cast<int>(err);
}

template <typename T, int kCols, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* out,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int B, int S, int H, int hd, cudaStream_t stream) {
  const int pitch = hd | 1;  // odd: conflict-free strided column reads
  int err = set_smem<T, kCols, kCausal>(pitch);
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
  dkdv_kernel<T, kCols, kCausal>
      <<<grid, kThreads, dkdv_smem_bytes(pitch), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, hd, pitch, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dq_kernel<T, kCols, kCausal>
      <<<grid, kThreads, dq_smem_bytes(pitch), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S, H, hd, pitch,
      scale);
  return static_cast<int>(cudaGetLastError());
}


// --------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync), cp.async ring
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;     // 4 warps of 16 rows
constexpr int kTcRows = 64;         // a block's own rows: kv (dk/dv), q (dq)
constexpr int kTcSub = 16;          // q columns of S^T a dk/dv warp holds
constexpr int kDeltaThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int kHdp>
__host__ __device__ constexpr int tc_pitch() { return kHdp + 8; }
// rows of each tile a block walks: q rows (dk/dv), kv rows (dq)
template <int kHdp>
__host__ __device__ constexpr int tc_walk() { return kHdp > 128 ? 32 : 64; }

// The block's own K and V (or Q and dO), then two stages of the walked
// pair; dk/dv adds two stages of lse and delta rows (f32).
template <int kHdp>
constexpr size_t tc_tiles_bytes() {
  return sizeof(bf16) * (2 * kTcRows + 4 * tc_walk<kHdp>()) *
         tc_pitch<kHdp>();
}
template <int kHdp>
constexpr size_t dkdv_tc_smem_bytes() {
  return tc_tiles_bytes<kHdp>() + sizeof(float) * 4 * tc_walk<kHdp>();
}
template <int kHdp>
constexpr size_t dq_tc_smem_bytes() { return tc_tiles_bytes<kHdp>(); }

// delta = rowsum(dout * out): kTpr threads a row, with `vec` (hd a
// multiple of 8, both inputs 16-byte aligned) 16 bytes of each a load.
template <int kTpr>
__global__ void __launch_bounds__(kDeltaThreads)
delta_tc_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                float* __restrict__ delta, long long rows, int hd,
                bool vec) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kDeltaThreads / kTpr) +
      threadIdx.x / kTpr;
  const int lane = threadIdx.x % kTpr;
  float acc = 0.0f;
  if (row < rows) {
    const bf16* o = out + static_cast<size_t>(row) * hd;
    const bf16* d = dout + static_cast<size_t>(row) * hd;
    if (vec) {
      for (int c = lane * 8; c < hd; c += kTpr * 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(o + c);
        const uint4 b = *reinterpret_cast<const uint4*>(d + c);
        const uint32_t av[4] = {a.x, a.y, a.z, a.w};
        const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = tc::unpack_bf16(av[i]);
          const float2 y = tc::unpack_bf16(bv[i]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    } else {
      for (int c = lane; c < hd; c += kTpr) {
        acc = fmaf(__bfloat162float(o[c]), __bfloat162float(d[c]), acc);
      }
    }
  }
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0 && row < rows) delta[row] = acc;
}

// Rows of a warp's C fragments (16 x hdp, f32) to bf16 rows row0 + g and
// row0 + g + 8 of dst (columns past hd and rows past S are not stored).
template <int kHdp>
__device__ __forceinline__ void store_tc(bf16* __restrict__ dst,
                                         const float (&acc)[kHdp / 8][4],
                                         size_t base, size_t row_stride,
                                         int row0, int S, int hd, int g,
                                         int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= S) continue;
    bf16* p = dst + base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int nd = 0; nd < kHdp / 8; ++nd) {
      const int col = nd * 8 + 2 * t;
      const float v0 = acc[nd][2 * r];
      const float v1 = acc[nd][2 * r + 1];
      if ((hd & 1) == 0) {
        if (col < hd) {
          *reinterpret_cast<uint32_t*>(p + col) = tc::pack_bf16(v0, v1);
        }
      } else {
        if (col < hd) p[col] = __float2bfloat16_rn(v0);
        if (col + 1 < hd) p[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// The A fragment of one 16-deep k step from two neighbouring C tiles,
// rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = tc::pack_bf16(c0[0], c0[1]);
  a[1] = tc::pack_bf16(c0[2], c0[3]);
  a[2] = tc::pack_bf16(c1[0], c1[1]);
  a[3] = tc::pack_bf16(c1[2], c1[3]);
}

// kHdp: the head dim padded to a multiple of 16; kCausal as above.
template <int kHdp, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
               int hd, float scale, bool vec) {
  constexpr int kPitch = tc_pitch<kHdp>();
  constexpr int kWalk = tc_walk<kHdp>();   // q rows a ring stage
  constexpr int kSub = kTcSub;             // q columns in registers
  constexpr int kSteps = kHdp / 16;        // k steps of K Q^T
  constexpr int kN = kSub / 8;             // C tiles of a sub-step
  constexpr int kTile = kWalk * kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTcRows * kPitch;
  bf16* ring = v_s + kTcRows * kPitch;
  float* rows_s = reinterpret_cast<float*>(ring + 4 * kTile);
  auto q_buf = [&](int st) { return ring + (2 * st) * kTile; };
  auto do_buf = [&](int st) { return ring + (2 * st + 1) * kTile; };
  auto lse_buf = [&](int st) { return rows_s + (2 * st) * kWalk; };
  auto delta_buf = [&](int st) { return rows_s + (2 * st + 1) * kWalk; };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int k0 = blockIdx.y * kTcRows;   // kv tile 0, the heaviest, first
  const size_t row_stride = static_cast<size_t>(H) * hd;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * hd;
  const size_t rbase = static_cast<size_t>(b) * S * H + h;  // lse, delta

  // Q, dO, lse and delta of the q tile at q0 into stage st (0 past S)
  auto load_q_tile = [&](int st, int q0) {
    tc::load_rows<kWalk, kHdp, kPitch, kTcThreads>(
        q_buf(st), q + base, row_stride, q0, S, hd, vec);
    tc::load_rows<kWalk, kHdp, kPitch, kTcThreads>(
        do_buf(st), dout + base, row_stride, q0, S, hd, vec);
    for (int r = threadIdx.x; r < kWalk; r += kTcThreads) {
      const bool ok = q0 + r < S;
      const size_t at = rbase + static_cast<size_t>(ok ? q0 + r : 0) * H;
      tc::cp_async4(lse_buf(st) + r, lse + at, ok ? 4 : 0);
      tc::cp_async4(delta_buf(st) + r, delta + at, ok ? 4 : 0);
    }
  };

  tc::load_rows<kTcRows, kHdp, kPitch, kTcThreads>(k_s, k + base, row_stride,
                                                   k0, S, hd, vec);
  tc::load_rows<kTcRows, kHdp, kPitch, kTcThreads>(v_s, v + base, row_stride,
                                                   k0, S, hd, vec);
  // the q tiles whose rows reach this kv tile: causal, from the one
  // holding row k0; full, all of them
  const int q_first = kCausal ? k0 : 0;
  load_q_tile(0, q_first);
  tc::cp_async_commit();

  float dk_acc[kHdp / 8][4], dv_acc[kHdp / 8][4];
#pragma unroll
  for (int nd = 0; nd < kHdp / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.0f;

  const int wrow = k0 + warp * 16;   // this warp's first kv row
  const float scale_log2 = scale * kLog2e;
  // ldmatrix row addresses: K and V (A, x4), Q and dO (B, x4), Q and dO
  // (B, x4.trans)
  const int a_off = (warp * 16 + (lane & 15)) * kPitch + (lane >> 4) * 8;
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * kPitch +
                    ((lane >> 3) & 1) * 8;
  const int bt_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
                     (lane >> 4) * 8;

  const int n_q = (S - q_first + kWalk - 1) / kWalk;
  for (int i = 0; i < n_q; ++i) {
    const int st = i & 1;
    const int q0 = q_first + i * kWalk;
    if (i + 1 < n_q) {
      load_q_tile(st ^ 1, q0 + kWalk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();   // tile i has landed, tile i + 1 in flight
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = q_buf(st);
    const bf16* dos = do_buf(st);
    const float* lse_s = lse_buf(st);
    const float* delta_s = delta_buf(st);

#pragma unroll 1
    for (int sub = 0; sub < kWalk / kSub; ++sub) {
      const int c0 = sub * kSub;          // first q column, in the tile
      const int qa = q0 + c0;             // its position
      // causal: every row of the warp above every column; either: every
      // column past S, or (full) every row of the warp past S
      if (kCausal ? wrow > qa + kSub - 1 || qa >= S : qa >= S || wrow >= S) {
        continue;
      }

      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x kSub q columns
      float s[kN][4], dp[kN][4];
#pragma unroll
      for (int nb = 0; nb < kN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t ka[4], va[4];
        tc::ldsm_x4(ka, k_s + a_off + kk * 16);
        tc::ldsm_x4(va, v_s + a_off + kk * 16);
#pragma unroll
        for (int nb2 = 0; nb2 < kN / 2; ++nb2) {
          const int at = b_off + (c0 + nb2 * 16) * kPitch + kk * 16;
          uint32_t bq[4], bo[4];
          tc::ldsm_x4(bq, qs + at);
          tc::ldsm_x4(bo, dos + at);
          tc::mma_bf16(s[2 * nb2], ka, bq[0], bq[1]);
          tc::mma_bf16(s[2 * nb2 + 1], ka, bq[2], bq[3]);
          tc::mma_bf16(dp[2 * nb2], va, bo[0], bo[1]);
          tc::mma_bf16(dp[2 * nb2 + 1], va, bo[2], bo[3]);
        }
      }

      // P^T and dS^T in place: row (kv) wrow + g + 8 (e >> 1), column (q)
      // qa + nb * 8 + 2t + (e & 1); masked only where the sub-step
      // crosses the diagonal (causal) or the end of S
      const bool edge = (kCausal && qa < wrow + 15) || qa + kSub > S;
#pragma unroll
      for (int nb = 0; nb < kN; ++nb) {
        const int col = c0 + nb * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          float p = exp2f(s[nb][e] * scale_log2 - lv * kLog2e);
          if (edge) {
            const int qpos = q0 + col + (e & 1);
            const int kpos = wrow + g + (e >> 1) * 8;
            if ((kCausal && kpos > qpos) || qpos >= S) p = 0.0f;
          }
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - dl) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T (rounded to bf16) as
      // A fragments straight from the C fragments
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int nd2 = 0; nd2 < kHdp / 16; ++nd2) {
          const int at = bt_off + (c0 + kk * 16) * kPitch + nd2 * 16;
          uint32_t bo[4], bq[4];
          tc::ldsm_x4_trans(bo, dos + at);
          tc::ldsm_x4_trans(bq, qs + at);
          tc::mma_bf16(dv_acc[2 * nd2], pa, bo[0], bo[1]);
          tc::mma_bf16(dv_acc[2 * nd2 + 1], pa, bo[2], bo[3]);
          tc::mma_bf16(dk_acc[2 * nd2], da, bq[0], bq[1]);
          tc::mma_bf16(dk_acc[2 * nd2 + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every read of stage st is done before its refill
  }
  store_tc<kHdp>(dk, dk_acc, base, row_stride, wrow, S, hd, g, t);
  store_tc<kHdp>(dv, dv_acc, base, row_stride, wrow, S, hd, g, t);
}

template <int kHdp, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int S, int H, int hd, float scale,
             bool vec) {
  constexpr int kPitch = tc_pitch<kHdp>();
  constexpr int kWalk = tc_walk<kHdp>();   // kv rows a ring stage
  constexpr int kSteps = kHdp / 16;        // k steps of Q K^T
  constexpr int kN = kWalk / 8;            // C tiles of one S row block
  constexpr int kTile = kWalk * kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kTcRows * kPitch;
  bf16* ring = do_s + kTcRows * kPitch;
  auto k_buf = [&](int st) { return ring + (2 * st) * kTile; };
  auto v_buf = [&](int st) { return ring + (2 * st + 1) * kTile; };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  // heaviest q tiles first: tile i reads its kv tiles up to row 64 i + 63
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;
  const size_t row_stride = static_cast<size_t>(H) * hd;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * hd;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  tc::load_rows<kTcRows, kHdp, kPitch, kTcThreads>(q_s, q + base, row_stride,
                                                   q0, S, hd, vec);
  tc::load_rows<kTcRows, kHdp, kPitch, kTcThreads>(do_s, dout + base,
                                                   row_stride, q0, S, hd,
                                                   vec);
  tc::load_rows<kWalk, kHdp, kPitch, kTcThreads>(k_buf(0), kb, row_stride, 0,
                                                 S, hd, vec);
  tc::load_rows<kWalk, kHdp, kPitch, kTcThreads>(v_buf(0), vb, row_stride, 0,
                                                 S, hd, vec);
  tc::cp_async_commit();

  // this thread's q rows: wrow + g and wrow + g + 8; their lse (log2
  // domain) and delta, 0 past S
  const int wrow = q0 + warp * 16;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + r * 8;
    const size_t at = (static_cast<size_t>(b) * S + row) * H + h;
    lse2[r] = row < S ? lse[at] * kLog2e : 0.0f;
    dl[r] = row < S ? delta[at] : 0.0f;
  }
  float dq_acc[kHdp / 8][4];
#pragma unroll
  for (int nd = 0; nd < kHdp / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[nd][e] = 0.0f;

  const float scale_log2 = scale * kLog2e;
  // ldmatrix row addresses: Q and dO (A, x4), K and V (B, x4), K (B,
  // x4.trans)
  const int a_off = (warp * 16 + (lane & 15)) * kPitch + (lane >> 4) * 8;
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * kPitch +
                    ((lane >> 3) & 1) * 8;
  const int bt_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
                     (lane >> 4) * 8;

  // causal: the kv tiles up to the q tile's last row; full: all of them
  const int kv_end = kCausal ? min(S, q0 + kTcRows) : S;
  const int n_kv = (kv_end + kWalk - 1) / kWalk;
  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    const int k0 = j * kWalk;
    if (j + 1 < n_kv) {
      tc::load_rows<kWalk, kHdp, kPitch, kTcThreads>(
          k_buf(st ^ 1), kb, row_stride, k0 + kWalk, S, hd, vec);
      tc::load_rows<kWalk, kHdp, kPitch, kTcThreads>(
          v_buf(st ^ 1), vb, row_stride, k0 + kWalk, S, hd, vec);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();   // tile j has landed, tile j + 1 in flight
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    // every row of the warp before the tile's first column (causal), or
    // past S: nothing to add
    if ((!kCausal || wrow + 15 >= k0) && wrow < S) {
      const bf16* ks = k_buf(st);
      const bf16* vs = v_buf(st);

      // S = Q K^T and dP = dO V^T: 16 q rows x kWalk kv columns
      float s[kN][4], dp[kN][4];
#pragma unroll
      for (int nb = 0; nb < kN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t qa[4], oa[4];
        tc::ldsm_x4(qa, q_s + a_off + kk * 16);
        tc::ldsm_x4(oa, do_s + a_off + kk * 16);
#pragma unroll
        for (int nb2 = 0; nb2 < kN / 2; ++nb2) {
          const int at = b_off + nb2 * 16 * kPitch + kk * 16;
          uint32_t bk[4], bv[4];
          tc::ldsm_x4(bk, ks + at);
          tc::ldsm_x4(bv, vs + at);
          tc::mma_bf16(s[2 * nb2], qa, bk[0], bk[1]);
          tc::mma_bf16(s[2 * nb2 + 1], qa, bk[2], bk[3]);
          tc::mma_bf16(dp[2 * nb2], oa, bv[0], bv[1]);
          tc::mma_bf16(dp[2 * nb2 + 1], oa, bv[2], bv[3]);
        }
      }

      // dS in place of dP: row (q) wrow + g + 8 (e >> 1), column (kv) k0 +
      // nb * 8 + 2t + (e & 1); masked only where the tile crosses the
      // diagonal (causal) or the end of S
      const bool edge = (kCausal && k0 + kWalk - 1 > wrow) || k0 + kWalk > S;
#pragma unroll
      for (int nb = 0; nb < kN; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2f(s[nb][e] * scale_log2 - lse2[r]);
          if (edge) {
            const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
            if ((kCausal && kpos > wrow + g + r * 8) || kpos >= S) p = 0.0f;
          }
          dp[nb][e] = p * (dp[nb][e] - dl[r]) * scale;
        }
      }

      // dQ += dS K: dS (rounded to bf16) as A fragments
#pragma unroll
      for (int kk = 0; kk < kWalk / 16; ++kk) {
        uint32_t da[4];
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int nd2 = 0; nd2 < kHdp / 16; ++nd2) {
          uint32_t bk[4];
          tc::ldsm_x4_trans(bk, ks + bt_off + kk * 16 * kPitch + nd2 * 16);
          tc::mma_bf16(dq_acc[2 * nd2], da, bk[0], bk[1]);
          tc::mma_bf16(dq_acc[2 * nd2 + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every read of stage st is done before its refill
  }
  store_tc<kHdp>(dq, dq_acc, base, row_stride, wrow, S, hd, g, t);
}

template <int kHdp, bool kCausal>
int set_smem_tc() {
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_tc_kernel<kHdp, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkdv_tc_smem_bytes<kHdp>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_tc_kernel<kHdp, kCausal>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_tc_smem_bytes<kHdp>()));
  return static_cast<int>(err);
}

template <int kHdp, bool kCausal>
int launch_tc(const void* q, const void* k, const void* v, const void* out,
              const float* lse, const void* dout, void* dq, void* dk,
              void* dv, float* delta, int B, int S, int H, int hd,
              cudaStream_t stream) {
  int err = set_smem_tc<kHdp, kCausal>();
  if (err != 0) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(out);
  const bf16* dot = static_cast<const bf16*>(dout);
  const bool vec = hd % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) &&
                   tc::aligned16(v) && tc::aligned16(dout);

  const long long rows = static_cast<long long>(B) * S * H;
  const bool delta_vec = hd % 8 == 0 && tc::aligned16(out) &&
                         tc::aligned16(dout);
  if (hd <= 128) {
    constexpr int kRows = kDeltaThreads / 16;
    delta_tc_kernel<16><<<static_cast<unsigned>((rows + kRows - 1) / kRows),
                          kDeltaThreads, 0, stream>>>(ot, dot, delta, rows,
                                                      hd, delta_vec);
  } else {
    constexpr int kRows = kDeltaThreads / 32;
    delta_tc_kernel<32><<<static_cast<unsigned>((rows + kRows - 1) / kRows),
                          kDeltaThreads, 0, stream>>>(ot, dot, delta, rows,
                                                      hd, delta_vec);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const dim3 grid(B * H, (S + kTcRows - 1) / kTcRows);
  dkdv_tc_kernel<kHdp, kCausal>
      <<<grid, kTcThreads, dkdv_tc_smem_bytes<kHdp>(), stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), S, H, hd, scale, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dq_tc_kernel<kHdp, kCausal>
      <<<grid, kTcThreads, dq_tc_smem_bytes<kHdp>(), stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), S, H, hd,
          scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int kHdp, bool kCausal>
int info_tc(int which, int* info) {
  int err = set_smem_tc<kHdp, kCausal>();
  if (err != 0) return err;
  if (which == 0) {
    return tc::kernel_info(dkdv_tc_kernel<kHdp, kCausal>, kTcThreads,
                           dkdv_tc_smem_bytes<kHdp>(), info);
  }
  return tc::kernel_info(dq_tc_kernel<kHdp, kCausal>, kTcThreads,
                         dq_tc_smem_bytes<kHdp>(), info);
}

// Dispatch on the head dim padded to a multiple of 16 (1..160 -> 16..160).
template <typename Fn>
int with_hdp(int hd, Fn&& fn) {
  switch ((hd + 15) / 16) {
    case 1: return fn(std::integral_constant<int, 16>{});
    case 2: return fn(std::integral_constant<int, 32>{});
    case 3: return fn(std::integral_constant<int, 48>{});
    case 4: return fn(std::integral_constant<int, 64>{});
    case 5: return fn(std::integral_constant<int, 80>{});
    case 6: return fn(std::integral_constant<int, 96>{});
    case 7: return fn(std::integral_constant<int, 112>{});
    case 8: return fn(std::integral_constant<int, 128>{});
    case 9: return fn(std::integral_constant<int, 144>{});
    case 10: return fn(std::integral_constant<int, 160>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dispatch on causal (a template parameter of the dk/dv and dq kernels).
template <typename Fn>
int with_causal(int causal, Fn&& fn) {
  if (causal) return fn(std::true_type{});
  return fn(std::false_type{});
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv: (B, S, H, hd) contiguous, f32 (dtype 0)
// or bf16 (dtype 1); lse and the scratch delta: (B, S, H) f32; causal: 1
// for the causal mask, 0 for none. Three launches on `stream` (delta,
// dk/dv, dq); returns the first non-zero cudaGetLastError() (0 on
// success). The caller checks shapes, types and contiguity.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int B, int S, int H, int hd, int dtype, int causal,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd < 1 || hd > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
    return with_cols(hd, [&](auto cols) {
      return with_causal(causal, [&](auto c) {
        return launch<float, decltype(cols)::value, decltype(c)::value>(
            q, k, v, out, lse, dout, dq, dk, dv, delta, B, S, H, hd, st);
      });
    });
  }
  if (dtype == 1) {
    if ((S + kTcRows - 1) / kTcRows > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return with_hdp(hd, [&](auto hdp) {
      return with_causal(causal, [&](auto c) {
        return launch_tc<decltype(hdp)::value, decltype(c)::value>(
            q, k, v, out, lse, dout, dq, dk, dv, delta, B, S, H, hd, st);
      });
    });
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The compiled dk/dv kernel (which = 0) or dq kernel (which = 1) of the
// route that `dtype` and `causal` take at head dim `hd`: info[0..5] as
// tc::kernel_info gives them. Returns a CUDA error code (0 on success).
extern "C" int flash_attention_bwd_info(int hd, int dtype, int which,
                                        int causal, int* info) {
  if (hd < 1 || hd > kMaxHeadDim || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1) {
    return with_hdp(hd, [&](auto hdp) {
      return with_causal(causal, [&](auto c) {
        return info_tc<decltype(hdp)::value, decltype(c)::value>(which,
                                                                 info);
      });
    });
  }
  const int pitch = hd | 1;
  return with_cols(hd, [&](auto cols) {
    return with_causal(causal, [&](auto c) {
      constexpr int kCols = decltype(cols)::value;
      constexpr bool kCausal = decltype(c)::value;
      int err = set_smem<float, kCols, kCausal>(pitch);
      if (err != 0) return err;
      if (which == 0) {
        return tc::kernel_info(dkdv_kernel<float, kCols, kCausal>, kThreads,
                               dkdv_smem_bytes(pitch), info);
      }
      return tc::kernel_info(dq_kernel<float, kCols, kCausal>, kThreads,
                             dq_smem_bytes(pitch), info);
    });
  });
}
