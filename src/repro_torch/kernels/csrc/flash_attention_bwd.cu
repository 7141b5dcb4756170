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
// Every route takes three launches and no atomics, so every run gives the
// same bits: delta; dk/dv (one block per (b, h, kv tile), walking the q
// tiles at or after it); dq (one block per (b, h, q tile), walking the kv
// tiles up to its last row, heaviest q tiles first). S and dP are
// computed in both of the last two. The dtype and shape alone pick the
// route (route()): f32 the CUDA cores; bf16 that a TMA tensor map can
// describe (hd % 8 == 0, 16-byte aligned q, k, v, out, dout) at the padded
// head dims 32, 64, 112 and 128 wgmma; other bf16 inputs (hd 150, 160,
// unaligned views) mma.sync.
//
// bf16 wgmma route (the train paths: hd 128, 112, 32; delta_tc_kernel,
// dkdv_wg_kernel, dq_wg_kernel): Hopper's TMA, mbarrier rings, warp
// specialisation and wgmma, as the forward's flash_fwd_wg_kernel.
//  - A block is 384 threads: a producer warp whose one thread issues
//    every TMA copy (setmaxnreg 24) and two consumer warpgroups (240
//    registers), each owning 64 of the block's 128 rows as wgmma's M; one
//    block an SM. Grids are (b, h) x 128-row tiles, tile by tile.
//  - dk/dv: K and V of the block come in once by TMA; a ring of 3 stages
//    brings each 64-row q tile's Q and dO (128-byte swizzled boxes) and,
//    by one bulk copy, its lse log2(e) and delta, which the delta kernel
//    writes in a chunked layout (rows_at) since a TMA box cannot gather
//    (B, S, H)'s H-strided rows. S^T = K Q^T and dP^T = V dO^T are
//    mma_ss (M 64 kv, N 64 q, both K-major); P^T and dS^T are formed in
//    the D fragments, rounded to bf16 and packed straight into the A
//    fragments of dV += P^T dO and dK += dS^T Q, mma_rs with Q and dO
//    read MN-major (N = hdp). A consumer thread holds dK and dV (hdp f32
//    each) and S^T and dP^T (32 each): 192 at hdp 128.
//    A tile's products are waited for before the next step; in full mode
//    the two warpgroups take turns to issue them (named barriers).
//  - dq: Q and dO of the block's 128 rows come in once; the ring brings
//    64-row K and V tiles; S = Q K^T and dP = dO V^T (mma_ss), P formed
//    while dP runs, dS packed into A fragments, dQ += dS K (mma_rs, K
//    MN-major) left in flight into the next tile. lse and delta sit in
//    registers, two rows a thread.
//  - dk/dv and dq are programmatic dependent launches: dk/dv's blocks
//    wait for the delta kernel (griddepcontrol.wait) and then let dq
//    start, so dq's blocks fill the SMs dk/dv's last wave leaves idle; dq
//    reads only delta's rows and waits for dk/dv before it ends, so work
//    behind it in the stream sees dK and dV.
//  - dK, dV and dQ are rounded once to bf16, staged in the block's own
//    swizzled boxes and written by TMA stores, which leave out rows past
//    S and columns past hd. Causal: a warpgroup skips a walked tile whose
//    pairs all lie above the diagonal and releases its stage all the
//    same; the mask comes from token positions where a tile crosses the
//    diagonal or S. Shared memory at hdp 128: 166,400 (dk/dv) and 164,864
//    bytes (dq).
//  - hdp 144 and 160 stay on mma.sync: dK + dV + S^T + dP^T would take 224
//    and 256 registers a consumer thread with 64-row q tiles, and no
//    train path runs them; so do hdp 16, 48, 80 and 96, which no
//    configuration of the repository takes.
//
// bf16 mma.sync route (delta_tc_kernel, dkdv_tc_kernel, dq_tc_kernel):
// every product on the tensor cores as mma.sync.m16n8k16
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

#include "hopper.cuh"
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

// The wgmma route's lse log2(e) and delta: for each (b, h) and 64-row
// tile of S, 64 of the first, then 64 of the second (S padded to 64 rows,
// 2 B H ceil(S / 64) 64 floats), so a tile's rows are one 512-byte bulk
// copy. rows_at(bh, pos, S) is the offset of position pos's lse; its delta
// is kRowsTile further.
constexpr int kRowsTile = 64;
__host__ __device__ __forceinline__ size_t rows_at(int bh, int pos, int S) {
  const int tiles = (S + kRowsTile - 1) / kRowsTile;
  return (static_cast<size_t>(bh) * tiles + pos / kRowsTile) * 2 *
             kRowsTile + pos % kRowsTile;
}

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
// kChunked (the wgmma route): delta and lse log2(e) go to the chunked
// layout that route's kernels fetch (rows_at), not to (B, S, H).
template <int kTpr, bool kChunked>
__global__ void __launch_bounds__(kDeltaThreads)
delta_tc_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                float* __restrict__ delta, long long rows, int hd,
                bool vec, const float* __restrict__ lse, int S, int H) {
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
  if (lane == 0 && row < rows) {
    if constexpr (kChunked) {
      const long long bs = row / H;
      const int b = static_cast<int>(bs / S);
      const int pos = static_cast<int>(bs - static_cast<long long>(b) * S);
      const int bh = b * H + static_cast<int>(row - bs * H);
      float* at = delta + rows_at(bh, pos, S);
      at[0] = lse[row] * kLog2e;
      at[kRowsTile] = acc;
    } else {
      delta[row] = acc;
    }
  }
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
    delta_tc_kernel<16, false>
        <<<static_cast<unsigned>((rows + kRows - 1) / kRows), kDeltaThreads,
           0, stream>>>(ot, dot, delta, rows, hd, delta_vec, nullptr, S, H);
  } else {
    constexpr int kRows = kDeltaThreads / 32;
    delta_tc_kernel<32, false>
        <<<static_cast<unsigned>((rows + kRows - 1) / kRows), kDeltaThreads,
           0, stream>>>(ot, dot, delta, rows, hd, delta_vec, nullptr, S, H);
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

// --------------------------------------------------------------------------
// bf16 route on Hopper: TMA ring, warp-specialised wgmma warpgroups
// --------------------------------------------------------------------------

constexpr int kWgThreads = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int kWgRows = 128;       // a block's own rows: 64 a consumer
constexpr int kWgTile = 64;        // rows of a walked tile (q or kv)
constexpr int kWgStages = 3;       // walked tiles in the ring
constexpr int kBoxCols = 64;       // bf16 columns a TMA box: 128 bytes
constexpr int kRowBytes = 128;     // a box row, the swizzle span
constexpr int kBox = 64 * kRowBytes;            // one 64-row box
constexpr int kRowsBytes = 2 * kRowsTile * 4;   // a tile's lse and delta

// 64-column boxes a 64-row tile holds: 1 up to hdp 64, 2 up to 128
template <int kHdp>
__host__ __device__ constexpr int wg_boxes() {
  return (kHdp + kBoxCols - 1) / kBoxCols;
}

// The block's own two 64-row tiles of two tensors (K, V or Q, dO), the
// ring's stages of two walked tiles each, the dk/dv ring's lse and delta
// rows, and 1024 bytes to align the swizzled tiles (the barriers are
// static shared memory). At hdp 128: 166,400 (dk/dv) and 164,864 (dq).
template <int kHdp>
constexpr size_t dq_wg_smem_bytes() {
  return 1024 + static_cast<size_t>(wg_boxes<kHdp>()) * kBox *
                    (4 + 2 * kWgStages);
}
template <int kHdp>
constexpr size_t dkdv_wg_smem_bytes() {
  return dq_wg_smem_bytes<kHdp>() + kWgStages * kRowsBytes;
}

// d (64 x 64) = a . b^T over depth kHdp: a warpgroup's 64 rows of A and a
// walked tile's 64 rows of B, both K-major in swizzled boxes.
template <int kHdp>
__device__ __forceinline__ void wg_scores(float (&d)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kHdp / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    hp::mma_ss(d, hp::desc_sw128(a + off, 16, 1024),
               hp::desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc (64 x kHdp) += a . b: a (64 x 64) as the A fragments of its four k
// steps, b a 64-row tile read MN-major (its leading byte offset steps one
// 64-column box).
template <int kHdp>
__device__ __forceinline__ void wg_accumulate(float (&acc)[kHdp / 2],
                                              const uint32_t (&a)[4][4],
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hp::mma_rs(acc, a[kk],
               hp::desc_sw128(b + kk * 16 * kRowBytes, kBox, 1024), 1);
  }
}

// A 64 x 64 D fragment rounded to bf16 as the A operands of four k steps:
// k step kk is D's 8-column blocks 2 kk and 2 kk + 1.
__device__ __forceinline__ void wg_pack(const float (&d)[32],
                                        uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[kk][i] = tc::pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
    }
  }
}

// A warpgroup's 64 x kHdp sums, rounded to bf16, into its 64-row boxes at
// dst, swizzled as TMA reads them for a store.
template <int kHdp>
__device__ __forceinline__ void wg_stage_out(unsigned char* dst,
                                             const float (&acc)[kHdp / 2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    unsigned char* p = dst + row * kRowBytes + 4 * (lane & 3);
#pragma unroll
    for (int nd = 0; nd < kHdp / 8; ++nd) {
      const int chunk = (nd % 8) ^ (row & 7);
      *reinterpret_cast<uint32_t*>(p + (nd / 8) * kBox + chunk * 16) =
          tc::pack_bf16(acc[4 * nd + 2 * r], acc[4 * nd + 2 * r + 1]);
    }
  }
}

// One TMA store a box of a warpgroup's 64 rows at row0 (rows past S and
// columns past hd are left out), by the warpgroup's first thread.
template <int kHdp>
__device__ __forceinline__ void wg_store(const CUtensorMap* map,
                                         uint32_t src, int h, int row0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < wg_boxes<kHdp>(); ++c) {
    hp::tma_store_4d(map, src + c * kBox, c * kBoxCols, h, row0, b);
  }
}

// The block's (b, h) and 128-row tile: blocks run tile by tile (kv tile 0
// of dk/dv, the last q tile of dq: the heaviest when causal, first), and
// in a tile (b, h) by (b, h).
struct WgBlock {
  int b, h, bh, tile, n_tiles;
};

__device__ __forceinline__ WgBlock wg_block(int S, int H) {
  WgBlock w;
  w.n_tiles = (S + kWgRows - 1) / kWgRows;
  const int n_bh = gridDim.x / w.n_tiles;
  w.tile = blockIdx.x / n_bh;
  w.bh = blockIdx.x - w.tile * n_bh;
  w.b = w.bh / H;
  w.h = w.bh - w.b * H;
  return w;
}

// dk/dv: a block owns 128 kv rows of one (b, h), 64 a consumer
// warpgroup, and walks the 64-row q tiles (causal: from the one holding
// its first kv row). Maps: q, k, v, dout, dk, dv as (hd, H, S, B) of bf16,
// 128-byte swizzled boxes of 64 columns x 64 rows. rows: lse log2(e) and
// delta as rows_at lays them out.
template <int kHdp, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
dkdv_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_dk,
               const __grid_constant__ CUtensorMap tm_dv,
               const float* __restrict__ rows, int S, int H,
               float scale_log2, float scale) {
  constexpr int kTile = wg_boxes<kHdp>() * kBox;   // a 64-row tile's bytes
  // barriers: K and V full; each stage's full and empty
  __shared__ __align__(8) uint64_t bars[1 + 2 * kWgStages];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t k_s = hp::smem_u32(smem);           // [warpgroup] 64 rows
  const uint32_t v_s = k_s + 2 * kTile;
  const uint32_t q_s = v_s + 2 * kTile;              // [stage] 64 rows
  const uint32_t do_s = q_s + kWgStages * kTile;
  const uint32_t rows_s = do_s + kWgStages * kTile;  // [stage] lse, delta
  const float* rows_f =
      reinterpret_cast<const float*>(smem + (rows_s - k_s));
  const uint32_t bar0 = hp::smem_u32(bars);
  const uint32_t kv_full = bar0;
  auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  auto empty = [&](int st) { return bar0 + 8 * (1 + kWgStages + st); };

  const WgBlock blk = wg_block(S, H);
  const int k0 = blk.tile * kWgRows;
  const int q_first = kCausal ? k0 : 0;
  const int n_q = (S - q_first + kWgTile - 1) / kWgTile;

  if (threadIdx.x == 256) {
    hp::prefetch_tensormap(&tm_q);
    hp::prefetch_tensormap(&tm_k);
    hp::prefetch_tensormap(&tm_v);
    hp::prefetch_tensormap(&tm_do);
  }
  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
    for (int st = 0; st < kWgStages; ++st) {
      hp::mbar_init(full(st), 1);
      hp::mbar_init(empty(st), 8);   // one arrival a consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  // launched early (programmatic dependent launch): the delta kernel's
  // rows must be complete; then the dq kernel, which needs no output of
  // this one, may take the SMs this grid leaves idle
  hp::griddep_wait();
  hp::griddep_launch_dependents();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread loads K and V once, then keeps the q ring full
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hp::mbar_expect_tx(kv_full, 4 * kTile);
      for (int w = 0; w < 2; ++w) {
        for (int c = 0; c < wg_boxes<kHdp>(); ++c) {
          hp::tma_load_4d(k_s + w * kTile + c * kBox, &tm_k, kv_full,
                          c * kBoxCols, blk.h, k0 + 64 * w, blk.b);
          hp::tma_load_4d(v_s + w * kTile + c * kBox, &tm_v, kv_full,
                          c * kBoxCols, blk.h, k0 + 64 * w, blk.b);
        }
      }
      for (int i = 0; i < n_q; ++i) {
        const int st = i % kWgStages;
        const int reuse = i / kWgStages - 1;   // the stage's last release
        const int q0 = q_first + i * kWgTile;
        if (reuse >= 0) hp::mbar_wait(empty(st), reuse & 1);
        hp::mbar_expect_tx(full(st), 2 * kTile + kRowsBytes);
        for (int c = 0; c < wg_boxes<kHdp>(); ++c) {
          hp::tma_load_4d(q_s + st * kTile + c * kBox, &tm_q, full(st),
                          c * kBoxCols, blk.h, q0, blk.b);
          hp::tma_load_4d(do_s + st * kTile + c * kBox, &tm_do, full(st),
                          c * kBoxCols, blk.h, q0, blk.b);
        }
        hp::bulk_load(rows_s + st * kRowsBytes,
                      rows + rows_at(blk.bh, q0, S), kRowsBytes, full(st));
      }
    }
  } else {
    // consumers: warpgroup wg owns kv rows kmin ..; per q tile S^T = K Q^T
    // and dP^T = V dO^T, then P^T and dS^T in registers, dV += P^T dO and
    // dK += dS^T Q
    hp::setmaxnreg_inc<240>();
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const bool signals = lane == 0;   // a warp's release arrival
    const int kmin = k0 + 64 * wg;
    const int krow = kmin + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const uint32_t k_mine = k_s + wg * kTile;
    const uint32_t v_mine = v_s + wg * kTile;

    float dk[kHdp / 2], dv[kHdp / 2];
#pragma unroll
    for (int i = 0; i < kHdp / 2; ++i) dk[i] = dv[i] = 0.0f;
    float s[32], dp[32];
    uint32_t pa[4][4], da[4][4];

    // Per tile: S^T and dP^T, then P^T and dS^T, then dV and dK, each
    // waited for before the next (ptxas serialises the products where
    // they are left in flight beside this many live registers: C7515).
    // Full mode: the two consumer warpgroups take turns to issue their
    // products (named barriers 3 and 4), so one's P^T and dS^T run beside
    // the other's products (2-5 % faster on an H100; causal, 4-6 %
    // slower, so it goes without)
    constexpr bool kTurns = !kCausal;
    auto turn = [&]() {
      if (kTurns) hp::bar_sync(3 + wg, 256);
    };
    auto pass = [&]() {
      if (kTurns) hp::bar_arrive(4 - wg, 256);
    };
    if (wg == 1) pass();
    hp::mbar_wait(kv_full, 0);
    for (int i = 0; i < n_q; ++i) {
      const int st = i % kWgStages;
      const int q0 = q_first + i * kWgTile;
      hp::mbar_wait(full(st), (i / kWgStages) & 1);
      // nothing to add where every kv row is past S or (causal) every pair
      // lies above the diagonal; the stage is released and the turns
      // taken all the same
      if (kmin >= S || (kCausal && kmin > q0 + kWgTile - 1)) {
        turn();
        pass();
        turn();
        pass();
        if (signals) hp::mbar_arrive(empty(st));
        continue;
      }
      const uint32_t qt = q_s + st * kTile;
      const uint32_t dot = do_s + st * kTile;
      turn();
      hp::wgmma_fence();
      wg_scores<kHdp>(s, k_mine, qt);
      wg_scores<kHdp>(dp, v_mine, dot);
      hp::wgmma_commit();
      pass();
      hp::wgmma_wait<0>();
      hp::fence_regs(s);
      hp::fence_regs(dp);

      // P^T and dS^T: row (kv) krow + 8 (e >> 1), column (q) q0 + 8 j + 2
      // t + (e & 1); masked where the tile crosses the diagonal (causal)
      // or the end of S (lse and delta there are not set)
      const float* lse2 = rows_f + st * 2 * kRowsTile;
      const float* dl = lse2 + kRowsTile;
      const bool edge = (kCausal && q0 < kmin + 63) || q0 + kWgTile > S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          float p = hp::exp2_approx(
              fmaf(s[x], scale_log2, -((e & 1) ? l2.y : l2.x)));
          float ds = p * (dp[x] - ((e & 1) ? d2.y : d2.x)) * scale;
          if (edge) {
            const int qpos = q0 + col + (e & 1);
            const int kpos = krow + 8 * (e >> 1);
            if ((kCausal && kpos > qpos) || qpos >= S) p = ds = 0.0f;
          }
          s[x] = p;
          dp[x] = ds;
        }
      }
      wg_pack(s, pa);
      wg_pack(dp, da);
      hp::fence_regs(pa);
      hp::fence_regs(da);
      hp::fence_regs(dk);
      hp::fence_regs(dv);
      turn();
      hp::wgmma_fence();
      wg_accumulate<kHdp>(dv, pa, dot);
      wg_accumulate<kHdp>(dk, da, qt);
      hp::wgmma_commit();
      pass();
      hp::wgmma_wait<0>();
      hp::fence_regs(dk);
      hp::fence_regs(dv);
      if (signals) hp::mbar_arrive(empty(st));
    }
    // warpgroup 1's first pass is one more than warpgroup 0's turns:
    // drain it
    if (wg == 0) turn();

    // epilogue: dK and dV in bf16 into this warpgroup's K and V boxes (no
    // wgmma reads them any more), then TMA stores
    hp::bar_sync(1 + wg, 128);
    wg_stage_out<kHdp>(smem + (k_mine - k_s), dk);
    wg_stage_out<kHdp>(smem + (v_mine - k_s), dv);
    hp::fence_proxy_async();
    hp::bar_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0 && kmin < S) {
      wg_store<kHdp>(&tm_dk, k_mine, blk.h, kmin, blk.b);
      wg_store<kHdp>(&tm_dv, v_mine, blk.h, kmin, blk.b);
      hp::tma_store_commit();
      hp::tma_store_wait_read();
    }
  }
}

// dq: a block owns 128 q rows of one (b, h), 64 a consumer warpgroup,
// and walks the 64-row kv tiles (causal: up to its last row). Maps as for
// dk/dv, with dq for dk and dv.
template <int kHdp, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
dq_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_dq,
             const float* __restrict__ rows, int S, int H, float scale_log2,
             float scale) {
  constexpr int kTile = wg_boxes<kHdp>() * kBox;
  // barriers: Q and dO full of each warpgroup; each stage's full, empty
  __shared__ __align__(8) uint64_t bars[2 + 2 * kWgStages];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t q_s = hp::smem_u32(smem);          // [warpgroup] 64 rows
  const uint32_t do_s = q_s + 2 * kTile;
  const uint32_t k_s = do_s + 2 * kTile;            // [stage] 64 rows
  const uint32_t v_s = k_s + kWgStages * kTile;
  const uint32_t bar0 = hp::smem_u32(bars);
  auto qd_full = [&](int w) { return bar0 + 8 * w; };
  auto full = [&](int st) { return bar0 + 8 * (2 + st); };
  auto empty = [&](int st) { return bar0 + 8 * (2 + kWgStages + st); };

  const WgBlock blk = wg_block(S, H);
  const int q0 = (kCausal ? blk.n_tiles - 1 - blk.tile : blk.tile) * kWgRows;
  const int kv_end = kCausal ? min(S, q0 + kWgRows) : S;
  const int n_kv = (kv_end + kWgTile - 1) / kWgTile;

  if (threadIdx.x == 256) {
    hp::prefetch_tensormap(&tm_q);
    hp::prefetch_tensormap(&tm_k);
    hp::prefetch_tensormap(&tm_v);
    hp::prefetch_tensormap(&tm_do);
  }
  if (threadIdx.x == 0) {
    hp::mbar_init(qd_full(0), 1);
    hp::mbar_init(qd_full(1), 1);
    for (int st = 0; st < kWgStages; ++st) {
      hp::mbar_init(full(st), 1);
      hp::mbar_init(empty(st), 8);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      // warpgroup w's Q and dO; warpgroup 0's and the first kv tile go
      // ahead of warpgroup 1's
      auto load_qd = [&](int w) {
        hp::mbar_expect_tx(qd_full(w), 2 * kTile);
        for (int c = 0; c < wg_boxes<kHdp>(); ++c) {
          hp::tma_load_4d(q_s + w * kTile + c * kBox, &tm_q, qd_full(w),
                          c * kBoxCols, blk.h, q0 + 64 * w, blk.b);
          hp::tma_load_4d(do_s + w * kTile + c * kBox, &tm_do, qd_full(w),
                          c * kBoxCols, blk.h, q0 + 64 * w, blk.b);
        }
      };
      load_qd(0);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kWgStages;
        const int reuse = j / kWgStages - 1;
        if (reuse >= 0) hp::mbar_wait(empty(st), reuse & 1);
        hp::mbar_expect_tx(full(st), 2 * kTile);
        for (int c = 0; c < wg_boxes<kHdp>(); ++c) {
          hp::tma_load_4d(k_s + st * kTile + c * kBox, &tm_k, full(st),
                          c * kBoxCols, blk.h, j * kWgTile, blk.b);
          hp::tma_load_4d(v_s + st * kTile + c * kBox, &tm_v, full(st),
                          c * kBoxCols, blk.h, j * kWgTile, blk.b);
        }
        if (j == 0) load_qd(1);
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows qmin ..; per kv tile S = Q K^T
    // and dP = dO V^T, dS in registers, dQ += dS K
    hp::setmaxnreg_inc<240>();
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const bool signals = lane == 0;
    const int qmin = q0 + 64 * wg;
    const int qrow = qmin + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const uint32_t q_mine = q_s + wg * kTile;
    const uint32_t do_mine = do_s + wg * kTile;
    // this thread's rows qrow and qrow + 8: lse log2(e) and delta (0 past
    // S)
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      const size_t at = row < S ? rows_at(blk.bh, row, S) : 0;
      lse2[r] = row < S ? __ldcg(rows + at) : 0.0f;
      dl[r] = row < S ? __ldcg(rows + at + kRowsTile) : 0.0f;
    }
    // the kv tiles with a pair for these rows: none when they all lie
    // past S; causal, up to the warpgroup's last row (warpgroup 0 skips
    // the block's last tile)
    const int n_mine =
        qmin >= S ? 0
                  : (kCausal ? (min(S, qmin + 64) + kWgTile - 1) / kWgTile
                             : n_kv);

    float dq[kHdp / 2];
#pragma unroll
    for (int i = 0; i < kHdp / 2; ++i) dq[i] = 0.0f;
    float s[32], dp[32];
    uint32_t da[4][4];

    // Per tile: S and dP issued together; P formed while dP runs; dS
    // formed and dQ's product issued, left in flight until the next
    // tile's S is done (its stage, `prev`, released then)
    int prev = -1;
    auto release_prev = [&]() {
      if (prev >= 0 && signals) hp::mbar_arrive(empty(prev));
      prev = -1;
    };
    hp::mbar_wait(qd_full(wg), 0);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % kWgStages;
      hp::mbar_wait(full(st), (j / kWgStages) & 1);
      if (j >= n_mine) {
        hp::wgmma_wait<0>();
        hp::fence_regs(dq);
        release_prev();
        if (signals) hp::mbar_arrive(empty(st));
        continue;
      }
      const uint32_t kt = k_s + st * kTile;
      const uint32_t vt = v_s + st * kTile;
      hp::wgmma_fence();
      wg_scores<kHdp>(s, q_mine, kt);
      hp::wgmma_commit();
      wg_scores<kHdp>(dp, do_mine, vt);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();   // S, and the previous tile's dQ
      hp::fence_regs(s);
      release_prev();

      // P: row (q) qrow + 8 (e >> 1), column (kv) k0 + 8 n + 2 t + (e &
      // 1); masked where the tile crosses the diagonal (causal) or S
      const int k0 = j * kWgTile;
      const bool edge = (kCausal && k0 + 63 > qmin) || k0 + kWgTile > S;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * n + e;
          float p = hp::exp2_approx(fmaf(s[x], scale_log2, -lse2[e >> 1]));
          if (edge) {
            const int kpos = k0 + 8 * n + 2 * t + (e & 1);
            if ((kCausal && kpos > qrow + 8 * (e >> 1)) || kpos >= S) {
              p = 0.0f;
            }
          }
          s[x] = p;
        }
      }
      hp::wgmma_wait<0>();   // dP
      hp::fence_regs(dp);
      // dS = P (dP - delta) scale, packed straight into A fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = 8 * kk + 2 * i;   // row qrow + 8 (i & 1)
          da[kk][i] =
              tc::pack_bf16(s[x] * (dp[x] - dl[i & 1]) * scale,
                            s[x + 1] * (dp[x + 1] - dl[i & 1]) * scale);
        }
      }
      hp::fence_regs(da);
      hp::fence_regs(dq);
      hp::wgmma_fence();
      wg_accumulate<kHdp>(dq, da, kt);
      hp::wgmma_commit();
      prev = st;
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(dq);
    release_prev();

    // epilogue: dQ in bf16 into this warpgroup's Q boxes, then TMA stores
    hp::bar_sync(1 + wg, 128);
    wg_stage_out<kHdp>(smem + (q_mine - q_s), dq);
    hp::fence_proxy_async();
    hp::bar_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0 && qmin < S) {
      wg_store<kHdp>(&tm_dq, q_mine, blk.h, qmin, blk.b);
      hp::tma_store_commit();
      hp::tma_store_wait_read();
    }
  }
  // launched beside the dk/dv kernel (it reads only the delta kernel's
  // rows, complete before any dk/dv block let it start): it ends only
  // after that kernel, so work behind it in the stream sees dk and dv
  hp::griddep_wait();
}

template <int kHdp, bool kCausal>
int set_smem_wg() {
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_wg_kernel<kHdp, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkdv_wg_smem_bytes<kHdp>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_wg_kernel<kHdp, kCausal>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_wg_smem_bytes<kHdp>()));
  return static_cast<int>(err);
}

template <int kHdp, bool kCausal>
int launch_wg(const void* q, const void* k, const void* v, const void* out,
              const float* lse, const void* dout, void* dq, void* dk,
              void* dv, float* delta, int B, int S, int H, int hd,
              cudaStream_t stream) {
  int err = set_smem_wg<kHdp, kCausal>();
  if (err != 0) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq, tm_dk, tm_dv;
  if (!hp::encode_bshd(&tm_q, q, B, S, H, hd, 64) ||
      !hp::encode_bshd(&tm_k, k, B, S, H, hd, 64) ||
      !hp::encode_bshd(&tm_v, v, B, S, H, hd, 64) ||
      !hp::encode_bshd(&tm_do, dout, B, S, H, hd, 64) ||
      !hp::encode_bshd(&tm_dq, dq, B, S, H, hd, 64) ||
      !hp::encode_bshd(&tm_dk, dk, B, S, H, hd, 64) ||
      !hp::encode_bshd(&tm_dv, dv, B, S, H, hd, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const long long rows = static_cast<long long>(B) * S * H;
  constexpr int kRows = kDeltaThreads / 16;
  delta_tc_kernel<16, true>
      <<<static_cast<unsigned>((rows + kRows - 1) / kRows), kDeltaThreads, 0,
         stream>>>(static_cast<const bf16*>(out),
                   static_cast<const bf16*>(dout), delta, rows, hd, true, lse,
                   S, H);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // dk/dv and dq as programmatic dependent launches: dk/dv's blocks start
  // as the delta kernel drains and wait for it; dq's start once every
  // dk/dv block has, filling the SMs of dk/dv's last wave
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * ((S + kWgRows - 1) / kWgRows));
  cfg.blockDim = dim3(kWgThreads);
  cfg.stream = stream;
  cfg.attrs = early;
  cfg.numAttrs = 1;
  const float* chunked = delta;
  const float scale_log2 = scale * kLog2e;
  cfg.dynamicSmemBytes = dkdv_wg_smem_bytes<kHdp>();
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, dkdv_wg_kernel<kHdp, kCausal>, tm_q, tm_k, tm_v, tm_do, tm_dk,
      tm_dv, chunked, S, H, scale_log2, scale));
  if (err != 0) return err;
  cfg.dynamicSmemBytes = dq_wg_smem_bytes<kHdp>();
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, dq_wg_kernel<kHdp, kCausal>, tm_q, tm_k, tm_v, tm_do, tm_dq,
      chunked, S, H, scale_log2, scale));
}

template <int kHdp, bool kCausal>
int info_wg(int which, int* info) {
  int err = set_smem_wg<kHdp, kCausal>();
  if (err != 0) return err;
  if (which == 0) {
    return tc::kernel_info(dkdv_wg_kernel<kHdp, kCausal>, kWgThreads,
                           dkdv_wg_smem_bytes<kHdp>(), info);
  }
  return tc::kernel_info(dq_wg_kernel<kHdp, kCausal>, kWgThreads,
                         dq_wg_smem_bytes<kHdp>(), info);
}

// Dispatch on the wgmma route's padded head dim: 32, 64, 112 and 128,
// every one a configuration of the repository pads its head dim to (hd
// 24 and 32 of the smoke configurations, 64, 112, 128). The others stay
// on mma.sync (route()): their instantiations would add to the build and
// serve no path.
template <typename Fn>
int with_wg_hdp(int hd, Fn&& fn) {
  switch ((hd + 15) / 16) {
    case 2: return fn(std::integral_constant<int, 32>{});
    case 4: return fn(std::integral_constant<int, 64>{});
    case 7: return fn(std::integral_constant<int, 112>{});
    case 8: return fn(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Whether the wgmma route has kernels at hd's padded head dim.
bool wg_hdp(int hd) {
  return with_wg_hdp(hd, [](auto) { return 0; }) == 0;
}

constexpr int kRouteCudaCores = 0;
constexpr int kRouteMmaSync = 1;
constexpr int kRouteWgmma = 2;

// The route, by dtype and shape alone: bf16 inputs a TMA tensor map can
// describe (hd % 8 == 0, every base 16-byte aligned: the forward's rule,
// applied to q, k, v, out and dout) take the wgmma kernels where they are
// built (wg_hdp: hd 24, 32, 56, 64, 104, 112, 120, 128); other bf16
// inputs, hd 150 and 160 among them, the mma.sync ones.
int route(const void* q, const void* k, const void* v, const void* out,
          const void* dout, int hd, int dtype) {
  if (dtype == 0) return kRouteCudaCores;
  const bool tma = hd % 8 == 0 && wg_hdp(hd) && tc::aligned16(q) &&
                   tc::aligned16(k) && tc::aligned16(v) &&
                   tc::aligned16(out) && tc::aligned16(dout);
  return tma ? kRouteWgmma : kRouteMmaSync;
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
// or bf16 (dtype 1); lse: (B, S, H) f32; delta: f32 scratch of 2 B H
// ceil(S / 64) 64 floats (the f32 and mma.sync routes use its first B S H
// as (B, S, H), the wgmma route all of it as rows_at lays it out); causal:
// 1 for the causal mask, 0 for none. Three launches on `stream` (delta,
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
    if (route(q, k, v, out, dout, hd, dtype) == kRouteWgmma) {
      return with_wg_hdp(hd, [&](auto hdp) {
        return with_causal(causal, [&](auto c) {
          return launch_wg<decltype(hdp)::value, decltype(c)::value>(
              q, k, v, out, lse, dout, dq, dk, dv, delta, B, S, H, hd, st);
        });
      });
    }
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

// The compiled dk/dv kernel (which = 0) or dq kernel (which = 1) that
// `dtype` and `causal` take at head dim `hd` for 16-byte aligned inputs:
// info[0..5] as tc::kernel_info gives them. Returns a CUDA error code (0
// on success).
extern "C" int flash_attention_bwd_info(int hd, int dtype, int which,
                                        int causal, int* info) {
  if (hd < 1 || hd > kMaxHeadDim || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1) {
    if (route(nullptr, nullptr, nullptr, nullptr, nullptr, hd, dtype) ==
        kRouteWgmma) {
      return with_wg_hdp(hd, [&](auto hdp) {
        return with_causal(causal, [&](auto c) {
          return info_wg<decltype(hdp)::value, decltype(c)::value>(which,
                                                                   info);
        });
      });
    }
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

// The route flash_attention_bwd_launch takes for these pointers, head dim
// and dtype: 0 the f32 CUDA-core kernels, 1 the bf16 mma.sync kernels, 2
// the bf16 wgmma kernels (hd % 8 == 0 at a padded head dim wg_hdp takes,
// every pointer 16-byte aligned).
extern "C" int flash_attention_bwd_route(const void* q, const void* k,
                                         const void* v, const void* out,
                                         const void* dout, int hd,
                                         int dtype) {
  return route(q, k, v, out, dout, hd, dtype);
}
