// Flash attention forward for Hopper (sm_90a), causal or full.
//
//   out[b,s,h,:] = sum_{t in T(s)} softmax_t(q[b,s,h,:] . k[b,t,h,:] / sqrt(hd)) v[b,t,h,:]
//   lse[b,s,h]   = log sum_{t in T(s)} exp(q . k / sqrt(hd))
//
// with T(s) = {t <= s} when causal (the models' attention) and every t < S
// when not (bidirectional attention).
//
// Replaces the Pallas TPU kernel kernels/flash_attention.py::flash_attention
// of the JAX package (forward body _flash_fwd_kernel, pallas_call at :103),
// for both values of its `causal`.
// The TPU grid walks kv blocks in order with (acc, m, l) in VMEM scratch;
// here one block owns one (b, h, q tile) and walks the kv tiles in a loop
// with (acc, m, l) in registers. One call is one CUDA launch.
//
// Bound on an H100 SXM: at zamba2-7b's prefill shape (B, S, H, hd) =
// (4, 512, 32, 112) in bf16 the function moves q, k, v and out (58.7 MB)
// plus lse: about 17.6 us
// at 3.35 TB/s. Its causal work is 2*B*H*S^2*hd ~ 7.5 GFLOP: 7.6 us on the
// bf16 tensor cores (989 TFLOP/s), 112 us in f32 on the CUDA cores
// (67 TFLOP/s). So the bf16 route is bound by bytes, and only a kernel on
// the tensor cores can get near it.
//
// bf16 route, wgmma (flash_fwd_wg_kernel, the serve and train path): the
// kernel built for Hopper, taken by every bf16 input a TMA tensor map can
// describe (hd % 8 == 0, q, k, v and out 16-byte aligned), so by every
// main-path head dim (64, 112, 128, 160). One block of 3 warpgroups (384
// threads) owns one (b, h, 128-row q tile):
//   - TMA: 4-D tensor maps over q, k, v and out as (hd, H, S, B), boxes of
//     64 columns (128 bytes, 128-byte swizzle) by 64 q rows or one kv tile;
//     hd 112 or 128 takes two boxes a row tile, 144 or 160 three. Columns
//     past hd and rows past S arrive as zeros, so the loads mask nothing.
//     The maps are encoded on the host for each call (cuTensorMapEncodeTiled
//     through cudaGetDriverEntryPoint: no -lcuda) and passed as
//     __grid_constant__ parameters.
//   - Warp specialisation: one producer thread (warpgroup 2, down to 24
//     registers by setmaxnreg) loads each consumer warpgroup's Q once and
//     keeps a ring of K and V stages full, K and V each with a full
//     (expect_tx) and an empty mbarrier a stage; two consumer warpgroups
//     (up to 240 registers) own 64 q rows each.
//   - wgmma: S = Q K^T as m64nNk16 with N the kv tile, both operands from
//     swizzled shared memory through descriptors (K-major); O += P V with P
//     from registers (the f32 fragment of S rounded to bf16 is the A
//     fragment) and V as an MN-major B operand, N the head dim padded to
//     16. The Q K^T of tile j + 1 is in flight while the softmax of tile j
//     runs, and the two warpgroups take turns to issue (named barriers), so
//     one's softmax runs beside the other's products.
//   - Tiles: kv tiles of 128 rows in 2 stages up to hdp 128 (Q 32 KB +
//     128 KB at hdp 128); at hdp 144 and 160 a row pads to 192 columns and
//     2 stages of 128 rows with Q would take 240 KB, so 64-row tiles in 3
//     stages (48 + 144 KB). One block an SM (168 launch registers); no spill.
//   - Epilogue: O / l rounded to bf16 into the warpgroup's own Q tiles
//     (swizzled as TMA wrote them), then a TMA store a box, which writes no
//     row past S and no column past hd; lse in f32.
//   - Block order: heads in groups (wg_group), and in a group q tile by q
//     tile, heaviest first when causal; this spreads each head's K and V
//     reads from device memory over the run.
// P is rounded to bf16 only as the operand of P V; the row sum l and the lse
// come from the unrounded f32 P (exp2 on the SFU, the 1/sqrt(hd) scale
// folded into its argument). The TPU reference multiplies at the matrix
// unit's default precision (bf16 passes), so this is no looser. No atomics,
// no split of kv: a second call gives equal bits.
// It replaces the mma.sync kernel on these inputs (Ampere's m16n8k16
// with a two-stage cp.async ring, up to 255 registers with 24 bytes spilled
// at hd 112). tools/time_kernels.py --only flash_fwd on an NVIDIA H100 80GB
// HBM3 at 700.00 W, in turns with it (ms, medians of 60 launches by CUDA
// events; PERF.md has all seven shapes): causal 0.0379 against
// 0.0563-0.0566 at (4, 512, 32, 112), 0.0311 against 0.0484-0.0486 at
// (4, 512, 24, 128), 0.0462 against 0.0919-0.0921 at (4, 512, 32, 160);
// full 0.0458-0.0468 against 0.1005-0.1016, 0.0379-0.0381 against
// 0.0709-0.0710, 0.0601-0.0606 against 0.1314-0.1315;
// scaled_dot_product_attention 0.0367-0.0372, 0.0311-0.0314, 0.0509-0.0514
// causal and 0.0415-0.0430, 0.0340-0.0342, 0.0596-0.0612 full on the same
// inputs. What holds it back at S = 512: a block has 4 kv tiles and fills
// its SM, so its prologue (Q and the first K tile) and epilogue are not
// hidden behind another block's work (tools/trace_flash_blocks.py: about
// 4 us of a full-mode block's 9.9 at (4, 512, 48, 128)); a
// persistent tile scheduler is the later work that would hide them.
//
// bf16 route, mma.sync (flash_fwd_tc_kernel): the inputs TMA cannot
// describe (hd % 8 != 0, or a base not 16-byte aligned), chosen by shape in
// flash_attention_launch (route()), never as a reaction to a failed build
// or launch. One block per (b, h, 128-row q tile), mma.sync.m16n8k16 from
// ldmatrix fragments, K and V tiles of 64 rows through a two-stage ring
// (the inputs are not 16-byte loadable, so its tiles fill element by
// element). Up to
// hdp 128 the causal kernel takes 4 warps of 2 16-row blocks; above it and
// in full mode 8 warps of one (two blocks' O accumulators would pass the
// 255-register cap at hdp 160).
//
// f32 route (flash_fwd_kernel, unchanged from the first port): one block
// per (b, h, 64-row q tile), 256 threads as 16 x 16, f32 on the CUDA cores
// out of shared memory. It is kept for f32 inputs because it meets the f32
// tolerance (2e-5), which TF32 tensor-core products cannot; the serve path
// draws bf16 weights and never takes it, the tests and chip_smoke.py do. Thread (ty, tx) owns q rows
// ty*4..ty*4+3; for S = Q K^T it computes the 4 x 4 scores at kv columns
// tx + 16 j, for O += P V 4 rows x 8 head columns tx + 16 c (columns past
// hd masked). Q, then K and V of each tile, are staged in shared memory as
// f32 with an odd row pitch; P goes through shared memory too.
//
// Causal or not is a template parameter of every kernel (kCausal), so each
// mode compiles to its own registers. Without the causal mask every q tile
// reads every kv tile, the diagonal mask goes, and only the ragged last kv
// tile is masked, on kpos < S.
//
// Every route: the causal skip comes from token positions: a q tile whose
// last row is s_last reads kv tiles up to s_last only, and a score is
// masked on kpos <= qpos and kpos < S (the bf16 routes mask only the kv
// tiles that cross the diagonal or the end of S). The Pallas kernel's
// tile-index skip (j <= i) is exact only for equal q and kv blocks and is
// not copied. The last tile of a ragged S is short: rows past S load as
// zeros, are masked, and are never stored, so any S works. out is written
// in the input dtype (round to nearest), lse in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

// --------------------------------------------------------------------------
// f32 route: CUDA cores (the first port, unchanged)
// --------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;          // 16 x 16
constexpr int kMaxHeadDim = 160;
constexpr int kPPitch = kBlockK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Stage rows r0..r0+kRows-1 of one (b, h) slice into smem as f32; rows at or
// past S are zero.
template <typename T, int kRows>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t base, size_t row_stride, int r0,
                                      int S, int hd, int pitch) {
  for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int s = r0 + r;
    dst[r * pitch + d] =
        s < S ? to_f32(src[base + static_cast<size_t>(s) * row_stride + d])
              : 0.0f;
  }
}

// kCols: output columns a thread, kMaxHeadDim / 16 at most (8 up to hd
// 128, 10 above); kCausal: the causal mask, else every kv tile, unmasked
// but for positions past S
template <typename T, int kCols, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int hd, int pitch,
                 float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // kBlockQ x pitch
  float* kv = qs + kBlockQ * pitch;      // kBlockK x pitch: K, then V
  float* ps = kv + kBlockK * pitch;      // kBlockQ x kPPitch

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t row_stride = static_cast<size_t>(H) * hd;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * hd;

  stage<T, kBlockQ>(qs, q, base, row_stride, q0, S, hd, pitch);

  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.0f;
  }

  // causal: past the tile's last q row
  const int kv_end = kCausal ? min(S, q0 + kBlockQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's V and P reads are done
    stage<T, kBlockK>(kv, k, base, row_stride, k0, S, hd, pitch);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kvv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * pitch + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kvv[j] = kv[(tx + 16 * j) * pitch + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kvv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[4];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S && (!kCausal || kpos <= qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[(ty * 4 + i) * kPPitch + tx + 16 * j] = p;
        row_sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= corr;
    }

    __syncthreads();  // every K read is done and P is written
    stage<T, kBlockK>(kv, v, base, row_stride, k0, S, hd, pitch);
    __syncthreads();

    const int kk_end = min(kBlockK, S - k0);
    for (int kk = 0; kk < kk_end; ++kk) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < hd ? kv[kk * pitch + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * kPPitch + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const size_t row = base + static_cast<size_t>(r) * row_stride;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) put(out + row + col, o[i][c] / l_safe);
    }
    if (tx == 0) {
      lse[(static_cast<size_t>(b) * S + r) * H + h] = m[i] + logf(l_safe);
    }
  }
}

size_t f32_smem_bytes(int pitch) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ + kBlockK) * pitch +
                          kBlockQ * kPPitch);
}

// Dispatch on the f32 route's columns a thread: 8 up to hd 128, 10 above.
template <typename Fn>
int with_cols(int hd, Fn&& fn) {
  if (hd <= 128) return fn(std::integral_constant<int, 8>{});
  return fn(std::integral_constant<int, 10>{});
}

template <typename T, int kCols, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int hd, cudaStream_t stream) {
  const int pitch = hd | 1;  // odd: conflict-free strided K reads
  const size_t smem = f32_smem_bytes(pitch);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kCols, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, kCols, kCausal><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, hd, pitch,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}


// --------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync), cp.async ring
// --------------------------------------------------------------------------

constexpr int kTcBlockQ = 128;                     // q rows a block
constexpr int kTcBlockK = 64;                      // kv rows a tile
constexpr float kLn2 = 0.6931471805599453f;

// 16-row q tiles a warp, and warps a block: 2 x 4 up to hdp 128; above
// it, where 2 tiles' O accumulators alone would take 2 * kHdp / 2 = 160
// registers a thread at hdp 160, 1 x 8 (the same 128-row q tile). The
// full (non-causal) kernel takes 1 x 8 at every hdp, and spills nothing
// (129 registers at hdp 112, 128 at 128, 178 at 160); at 2 x 4 it took
// 255 and spilled 16 bytes at hdp 112 and 32 at 128, as the causal one
// spills 24 and 8 (tools/time_kernels.py on an H100 80GB HBM3, 700 W:
// 2 x 4 took 0.0805 ms against 1 x 8's 0.1008 at (4, 512, 32, 112),
// 0.0693 against 0.0710 at (4, 512, 24, 128)).
template <int kHdp, bool kCausal>
__host__ __device__ constexpr int tc_mt() {
  return kHdp > 128 || !kCausal ? 1 : 2;
}
template <int kHdp, bool kCausal>
__host__ __device__ constexpr int tc_threads() {
  return 32 * kTcBlockQ / (16 * tc_mt<kHdp, kCausal>());
}

using bf16 = __nv_bfloat16;

template <int kHdp>
__host__ __device__ constexpr int tc_pitch() { return kHdp + 8; }

// Q (kTcBlockQ rows), then K and V of two stages (kTcBlockK rows each),
// rows of kHdp + 8 bf16
template <int kHdp>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (kTcBlockQ + 4 * kTcBlockK) * tc_pitch<kHdp>();
}

// kHdp: the head dim padded to a multiple of 16; kCausal as above.
template <int kHdp, bool kCausal>
__global__ void __launch_bounds__(tc_threads<kHdp, kCausal>())
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int S, int H, int hd,
                    float scale_log2, bool vec) {
  constexpr int kTcMt = tc_mt<kHdp, kCausal>();
  constexpr int kTcThreads = tc_threads<kHdp, kCausal>();
  constexpr int kPitch = tc_pitch<kHdp>();
  constexpr int kTile = kTcBlockK * kPitch;
  constexpr int kSteps = kHdp / 16;      // k steps of Q K^T
  constexpr int kCols = kTcBlockK / 8;   // C tiles of one S row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = q_s + kTcBlockQ * kPitch;
  auto k_buf = [&](int st) { return ring + (2 * st) * kTile; };
  auto v_buf = [&](int st) { return ring + (2 * st + 1) * kTile; };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  // causal: heaviest first; full: every tile does the same work
  const int q0 = (kCausal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) *
                 kTcBlockQ;
  const size_t row_stride = static_cast<size_t>(H) * hd;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * hd;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  tc::load_rows<kTcBlockQ, kHdp, kPitch, kTcThreads>(q_s, q + base,
                                                     row_stride, q0, S, hd,
                                                     vec);
  tc::load_rows<kTcBlockK, kHdp, kPitch, kTcThreads>(k_buf(0), kb, row_stride,
                                                     0, S, hd, vec);
  tc::load_rows<kTcBlockK, kHdp, kPitch, kTcThreads>(v_buf(0), vb, row_stride,
                                                     0, S, hd, vec);
  tc::cp_async_commit();

  // this warp's q rows: warp * 16 * kTcMt + 16 mt + g (+ 8)
  float o[kTcMt][kHdp / 8][4];
  float m_r[kTcMt][2];   // running max, log2 domain
  float l_r[kTcMt][2];
#pragma unroll
  for (int mt = 0; mt < kTcMt; ++mt) {
#pragma unroll
    for (int nd = 0; nd < kHdp / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nd][e] = 0.0f;
    m_r[mt][0] = m_r[mt][1] = kNegInf;
    l_r[mt][0] = l_r[mt][1] = 0.0f;
  }
  const int qrow = q0 + warp * 16 * kTcMt + g;
  // ldmatrix row addresses: Q (A, x4), K (B, x4), V (B, x4.trans)
  const bf16* q_row = q_s + (warp * 16 * kTcMt + (lane & 15)) * kPitch +
                      (lane >> 4) * 8;
  const int k_off = ((lane >> 4) * 8 + (lane & 7)) * kPitch +
                    ((lane >> 3) & 1) * 8;
  const int v_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
                    (lane >> 4) * 8;

  const int kv_end = kCausal ? min(S, q0 + kTcBlockQ) : S;
  const int n_kv = (kv_end + kTcBlockK - 1) / kTcBlockK;
  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {
      const int k1 = (j + 1) * kTcBlockK;
      tc::load_rows<kTcBlockK, kHdp, kPitch, kTcThreads>(
          k_buf(st ^ 1), kb, row_stride, k1, S, hd, vec);
      tc::load_rows<kTcBlockK, kHdp, kPitch, kTcThreads>(
          v_buf(st ^ 1), vb, row_stride, k1, S, hd, vec);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();   // tile j has landed, tile j + 1 in flight
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_buf(st) + k_off;
    const bf16* vs = v_buf(st) + v_off;

    // S = Q K^T: kTcMt x 16 rows x kTcBlockK kv columns a warp; each K
    // fragment serves all kTcMt row blocks
    float s[kTcMt][kCols][4];
#pragma unroll
    for (int mt = 0; mt < kTcMt; ++mt)
#pragma unroll
      for (int nb = 0; nb < kCols; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t qf[kTcMt][4];
#pragma unroll
      for (int mt = 0; mt < kTcMt; ++mt) {
        tc::ldsm_x4(qf[mt], q_row + mt * 16 * kPitch + kk * 16);
      }
#pragma unroll
      for (int nb2 = 0; nb2 < kCols / 2; ++nb2) {
        uint32_t bk[4];
        tc::ldsm_x4(bk, ks + nb2 * 16 * kPitch + kk * 16);
#pragma unroll
        for (int mt = 0; mt < kTcMt; ++mt) {
          tc::mma_bf16(s[mt][2 * nb2], qf[mt], bk[0], bk[1]);
          tc::mma_bf16(s[mt][2 * nb2 + 1], qf[mt], bk[2], bk[3]);
        }
      }
    }

    // scale to the log2 domain; mask only tiles that cross the diagonal
    // (causal) or the end of the sequence
    const int k0 = j * kTcBlockK;
    const bool edge =
        (kCausal && k0 + kTcBlockK - 1 > q0) || k0 + kTcBlockK > S;
#pragma unroll
    for (int mt = 0; mt < kTcMt; ++mt) {
#pragma unroll
      for (int nb = 0; nb < kCols; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = s[mt][nb][e] * scale_log2;
          if (edge) {
            const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
            const int qpos = qrow + mt * 16 + (e >> 1) * 8;
            if ((kCausal && kpos > qpos) || kpos >= S) val = kNegInf;
          }
          s[mt][nb][e] = val;
        }
      }
    }

    // online softmax for rows g (r = 0) and g + 8 (r = 1) of each row
    // block: the 4 threads of a quad hold one row's columns
#pragma unroll
    for (int mt = 0; mt < kTcMt; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_r[mt][r];
#pragma unroll
        for (int nb = 0; nb < kCols; ++nb) {
          mx = fmaxf(mx, fmaxf(s[mt][nb][2 * r], s[mt][nb][2 * r + 1]));
        }
        mx = tc::quad_max(mx);
        const float corr = exp2f(m_r[mt][r] - mx);
        float sum = 0.0f;
#pragma unroll
        for (int nb = 0; nb < kCols; ++nb) {
          const float p0 = exp2f(s[mt][nb][2 * r] - mx);
          const float p1 = exp2f(s[mt][nb][2 * r + 1] - mx);
          s[mt][nb][2 * r] = p0;
          s[mt][nb][2 * r + 1] = p1;
          sum += p0 + p1;
        }
        l_r[mt][r] = l_r[mt][r] * corr + tc::quad_sum(sum);
        m_r[mt][r] = mx;
#pragma unroll
        for (int nd = 0; nd < kHdp / 8; ++nd) {
          o[mt][nd][2 * r] *= corr;
          o[mt][nd][2 * r + 1] *= corr;
        }
      }
    }

    // O += P V: P (rounded to bf16) as A fragments straight from s; each
    // V fragment serves all kTcMt row blocks
#pragma unroll
    for (int kk = 0; kk < kCols / 2; ++kk) {
      uint32_t pa[kTcMt][4];
#pragma unroll
      for (int mt = 0; mt < kTcMt; ++mt) {
        pa[mt][0] = tc::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = tc::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = tc::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = tc::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int nd2 = 0; nd2 < kHdp / 16; ++nd2) {
        uint32_t bv[4];
        tc::ldsm_x4_trans(bv, vs + kk * 16 * kPitch + nd2 * 16);
#pragma unroll
        for (int mt = 0; mt < kTcMt; ++mt) {
          tc::mma_bf16(o[mt][2 * nd2], pa[mt], bv[0], bv[1]);
          tc::mma_bf16(o[mt][2 * nd2 + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every read of stage st is done before its refill
  }

#pragma unroll
  for (int mt = 0; mt < kTcMt; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + mt * 16 + r * 8;
      if (row >= S) continue;
      const float l_safe = fmaxf(l_r[mt][r], 1e-30f);
      const float inv = 1.0f / l_safe;
      bf16* dst = out + base + static_cast<size_t>(row) * row_stride;
#pragma unroll
      for (int nd = 0; nd < kHdp / 8; ++nd) {
        const int col = nd * 8 + 2 * t;
        const float v0 = o[mt][nd][2 * r] * inv;
        const float v1 = o[mt][nd][2 * r + 1] * inv;
        if ((hd & 1) == 0) {
          if (col < hd) {
            *reinterpret_cast<uint32_t*>(dst + col) = tc::pack_bf16(v0, v1);
          }
        } else {
          if (col < hd) dst[col] = __float2bfloat16_rn(v0);
          if (col + 1 < hd) dst[col + 1] = __float2bfloat16_rn(v1);
        }
      }
      if (t == 0) {
        lse[(static_cast<size_t>(b) * S + row) * H + h] =
            m_r[mt][r] * kLn2 + logf(l_safe);
      }
    }
  }
}

template <int kHdp, bool kCausal>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int H, int hd, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<kHdp>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<kHdp, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = hd % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) &&
                   tc::aligned16(v);
  const dim3 grid(B * H, (S + kTcBlockQ - 1) / kTcBlockQ);
  flash_fwd_tc_kernel<kHdp, kCausal>
      <<<grid, tc_threads<kHdp, kCausal>(), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, H, hd,
      1.4426950408889634f / sqrtf(static_cast<float>(hd)), vec);
  return static_cast<int>(cudaGetLastError());
}

template <int kHdp, bool kCausal>
int info_tc(int* info) {
  const size_t smem = tc_smem_bytes<kHdp>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<kHdp, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return tc::kernel_info(flash_fwd_tc_kernel<kHdp, kCausal>,
                         tc_threads<kHdp, kCausal>(), smem, info);
}

// --------------------------------------------------------------------------
// bf16 route on Hopper: TMA ring, warp-specialised wgmma warpgroups
// --------------------------------------------------------------------------

constexpr int kWgBlockQ = 128;     // q rows a block: 64 a consumer warpgroup
constexpr int kWgThreads = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int kBoxCols = 64;       // bf16 columns a TMA box: 128 bytes
constexpr int kRowBytes = 128;     // a box row, the swizzle span

// 64-column boxes a row, kv rows a tile and kv stages in the ring, by the
// padded head dim: up to hdp 128, tiles of 128 kv rows in 2 stages (Q
// 32 KB + 128 KB at hdp 128); above it (hdp 144, 160: 3 boxes, a row padded
// to 192 columns) 2 stages of 128 rows would take 240 KB with Q, so tiles
// of 64 rows in 3 stages (48 + 144 KB).
template <int kHdp>
__host__ __device__ constexpr int wg_boxes() {
  return (kHdp + kBoxCols - 1) / kBoxCols;
}
template <int kHdp>
__host__ __device__ constexpr int wg_block_n() {
  return wg_boxes<kHdp>() > 2 ? 64 : 128;
}
template <int kHdp>
__host__ __device__ constexpr int wg_stages() {
  return wg_boxes<kHdp>() > 2 ? 3 : 2;
}

// Q's boxes for both warpgroups, the K and V stages, and 1024 bytes to align
// the swizzled tiles (the barriers are static shared memory)
template <int kHdp>
constexpr size_t wg_smem_bytes() {
  return 1024 + static_cast<size_t>(wg_boxes<kHdp>()) * kRowBytes *
                    (kWgBlockQ + 2 * wg_stages<kHdp>() * wg_block_n<kHdp>());
}

// The online softmax of one kv tile's raw scores s (this thread's part of
// the warpgroup's 64 x kN tile: rows g and g + 8 of its warp's 16): masks
// where `edge` (kpos > qpos when causal, kpos >= S), takes the row max of
// the raw scores (scale_log2 = log2(e) / sqrt(hd) > 0 keeps their order),
// updates the running max m_r (scaled, log2 domain) and sum l_r, leaves
// P = exp2(s * scale_log2 - m) in s (one FFMA and one ex2 an element) and
// returns each row's correction of O in corr.
template <int kN, bool kCausal>
__device__ __forceinline__ void wg_softmax(float (&s)[kN / 2], float (&m_r)[2],
                                           float (&l_r)[2], float (&corr)[2],
                                           bool edge, int k0, int qrow, int S,
                                           float scale_log2) {
  const int t = threadIdx.x & 3;
  if (edge) {
#pragma unroll
    for (int nb = 0; nb < kN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
        const int qpos = qrow + (e >> 1) * 8;
        if ((kCausal && kpos > qpos) || kpos >= S) s[4 * nb + e] = kNegInf;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float raw = kNegInf;
#pragma unroll
    for (int nb = 0; nb < kN / 8; ++nb) {
      raw = fmaxf(raw, fmaxf(s[4 * nb + 2 * r], s[4 * nb + 2 * r + 1]));
    }
    const float mx = fmaxf(m_r[r], tc::quad_max(raw) * scale_log2);
    corr[r] = hp::exp2_approx(m_r[r] - mx);
    float sum = 0.0f;
#pragma unroll
    for (int nb = 0; nb < kN / 8; ++nb) {
      const float p0 =
          hp::exp2_approx(fmaf(s[4 * nb + 2 * r], scale_log2, -mx));
      const float p1 =
          hp::exp2_approx(fmaf(s[4 * nb + 2 * r + 1], scale_log2, -mx));
      s[4 * nb + 2 * r] = p0;
      s[4 * nb + 2 * r + 1] = p1;
      sum += p0 + p1;
    }
    l_r[r] = l_r[r] * corr[r] + tc::quad_sum(sum);
    m_r[r] = mx;
  }
}

// P (rounded to bf16) as the A operands of P V's k steps: k step kk is D's
// 8-column blocks 2 kk and 2 kk + 1.
template <int kN>
__device__ __forceinline__ void wg_pack_p(const float (&s)[kN / 2],
                                          uint32_t (&p)[kN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[kk][i] = tc::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    }
  }
}

// kHdp: the head dim padded to a multiple of 16 (O's width, Q K^T's depth);
// kCausal as above. Maps: q, k, v, out as (hd, H, S, B) of bf16, 128-byte
// swizzled boxes of 64 columns x 64 rows (q, out) or wg_block_n rows (k, v).
template <int kHdp, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o,
                    float* __restrict__ lse, int S, int H, float scale_log2,
                    int group) {
  constexpr int kBoxes = wg_boxes<kHdp>();
  constexpr int kN = wg_block_n<kHdp>();
  constexpr int kStages = wg_stages<kHdp>();
  constexpr int kQBox = 64 * kRowBytes;      // a warpgroup's rows of a box
  constexpr int kKvBox = kN * kRowBytes;     // a tile's rows of a box
  constexpr int kQBytes = 2 * kBoxes * kQBox;
  constexpr int kKvBytes = kBoxes * kKvBox;
  // barriers: Q full of each warpgroup; K full, K empty, V full, V empty of
  // each stage
  __shared__ __align__(8) uint64_t bars[2 + 4 * kStages];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t q_s = hp::smem_u32(smem);   // [warpgroup][box] 64 rows
  const uint32_t k_s = q_s + kQBytes;        // [stage][box] kN rows
  const uint32_t v_s = k_s + kStages * kKvBytes;
  const uint32_t bar0 = hp::smem_u32(bars);
  auto q_full = [&](int w) { return bar0 + 8 * w; };
  auto k_full = [&](int st) { return bar0 + 8 * (2 + st); };
  auto k_empty = [&](int st) { return bar0 + 8 * (2 + kStages + st); };
  auto v_full = [&](int st) { return bar0 + 8 * (2 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bar0 + 8 * (2 + 3 * kStages + st); };

  // block order: (b, h) in groups of `group`; in a group, q tile by q tile
  // (heaviest first when causal), then (b, h)
  const int nq = (S + kWgBlockQ - 1) / kWgBlockQ;
  const int n_bh = gridDim.x / nq;
  const int first = blockIdx.x / (group * nq) * group;
  const int in_group = min(group, n_bh - first);
  const int rank = blockIdx.x - first * nq;
  const int bh = first + rank % in_group;
  const int tile = rank / in_group;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (kCausal ? nq - 1 - tile : tile) * kWgBlockQ;
  const int kv_end = kCausal ? min(S, q0 + kWgBlockQ) : S;
  const int n_kv = (kv_end + kN - 1) / kN;

  if (threadIdx.x == 256) {
    hp::prefetch_tensormap(&tm_q);
    hp::prefetch_tensormap(&tm_k);
    hp::prefetch_tensormap(&tm_v);
    hp::prefetch_tensormap(&tm_o);
  }
  if (threadIdx.x == 0) {
    hp::mbar_init(q_full(0), 1);
    hp::mbar_init(q_full(1), 1);
    for (int st = 0; st < kStages; ++st) {
      hp::mbar_init(k_full(st), 1);
      hp::mbar_init(v_full(st), 1);
      hp::mbar_init(k_empty(st), 8);   // one arrival a consumer warp
      hp::mbar_init(v_empty(st), 8);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      // warpgroup w's Q rows; warpgroup 0 starts first (its turn), so its
      // Q and the first K tile go ahead of warpgroup 1's Q
      auto load_q = [&](int w) {
        hp::mbar_expect_tx(q_full(w), kQBytes / 2);
        for (int c = 0; c < kBoxes; ++c) {
          hp::tma_load_4d(q_s + (w * kBoxes + c) * kQBox, &tm_q, q_full(w),
                          c * kBoxCols, h, q0 + 64 * w, b);
        }
      };
      load_q(0);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kStages;
        const int reuse = j / kStages - 1;   // the stage's last release
        if (reuse >= 0) hp::mbar_wait(k_empty(st), reuse & 1);
        hp::mbar_expect_tx(k_full(st), kKvBytes);
        for (int c = 0; c < kBoxes; ++c) {
          hp::tma_load_4d(k_s + (st * kBoxes + c) * kKvBox, &tm_k, k_full(st),
                          c * kBoxCols, h, j * kN, b);
        }
        if (j == 0) load_q(1);
        if (reuse >= 0) hp::mbar_wait(v_empty(st), reuse & 1);
        hp::mbar_expect_tx(v_full(st), kKvBytes);
        for (int c = 0; c < kBoxes; ++c) {
          hp::tma_load_4d(v_s + (st * kBoxes + c) * kKvBox, &tm_v, v_full(st),
                          c * kBoxCols, h, j * kN, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64 wg ..; S = Q K^T and
    // O += P V on wgmma, the softmax of tile j overlapping Q K^T of j + 1
    hp::setmaxnreg_inc<240>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const bool signals = lane == 0;          // a warp's release arrival
    const int r0 = 16 * warp + (lane >> 2);  // rows r0, r0 + 8 of the 64
    const int qmin = q0 + 64 * wg;
    const int qrow = qmin + r0;
    // causal: a trailing tile wholly after this warpgroup's rows is skipped
    // (at most one, the block's last, when kN = 64); nobody waits on its
    // release
    const int n_mine =
        kCausal ? min(n_kv, (min(S, qmin + 64) + kN - 1) / kN) : n_kv;
    const uint32_t q_mine = q_s + wg * kBoxes * kQBox;

    float o[kHdp / 2];
#pragma unroll
    for (int i = 0; i < kHdp / 2; ++i) o[i] = 0.0f;
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.0f, 0.0f};
    float corr[2];
    float s[kN / 2];
    uint32_t p[kN / 16][4];

    auto issue_qk = [&](int j) {
      const uint32_t kt = k_s + (j % kStages) * kKvBytes;
#pragma unroll
      for (int kk = 0; kk < kHdp / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        hp::mma_ss(s,
                   hp::desc_sw128(q_mine + (kk / 4) * kQBox + off, 16, 1024),
                   hp::desc_sw128(kt + (kk / 4) * kKvBox + off, 16, 1024),
                   kk > 0);
      }
    };
    auto issue_pv = [&](int j) {
      const uint32_t vt = v_s + (j % kStages) * kKvBytes;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        hp::mma_rs(o, p[kk],
                   hp::desc_sw128(vt + kk * 16 * kRowBytes, kKvBox, 1024), 1);
      }
    };
    auto edge = [&](int k0) {
      return (kCausal && k0 + kN - 1 > qmin) || k0 + kN > S;
    };
    // the warpgroups take turns to issue their wgmma (named barriers 3 and
    // 4), so one's softmax runs beside the other's products; warpgroup 0
    // goes first
    auto turn = [&]() { hp::bar_sync(3 + wg, 256); };
    auto pass = [&]() { hp::bar_arrive(4 - wg, 256); };
    if (wg == 1) hp::bar_arrive(3, 256);

    hp::mbar_wait(q_full(wg), 0);
    hp::mbar_wait(k_full(0), 0);
    turn();
    hp::wgmma_fence();
    issue_qk(0);
    hp::wgmma_commit();
    pass();
    hp::wgmma_wait<0>();
    hp::fence_regs(s);
    if (signals) hp::mbar_arrive(k_empty(0));
    wg_softmax<kN, kCausal>(s, m_r, l_r, corr, edge(0), 0, qrow, S,
                            scale_log2);
    wg_pack_p<kN>(s, p);

    for (int j = 1; j < n_mine; ++j) {
      const int st = j % kStages;
      const int prev = (j - 1) % kStages;
      hp::mbar_wait(k_full(st), (j / kStages) & 1);
      turn();
      hp::fence_regs(o);
      hp::fence_regs(p);
      hp::wgmma_fence();
      issue_qk(j);
      hp::wgmma_commit();
      hp::mbar_wait(v_full(prev), ((j - 1) / kStages) & 1);
      issue_pv(j - 1);
      hp::wgmma_commit();
      pass();
      hp::wgmma_wait<1>();                   // S of tile j
      hp::fence_regs(s);
      if (signals) hp::mbar_arrive(k_empty(st));
      wg_softmax<kN, kCausal>(s, m_r, l_r, corr, edge(j * kN), j * kN, qrow,
                              S, scale_log2);
      hp::wgmma_wait<0>();                   // O += P V of tile j - 1
      hp::fence_regs(o);
      if (signals) hp::mbar_arrive(v_empty(prev));
#pragma unroll
      for (int nd = 0; nd < kHdp / 8; ++nd) {
        o[4 * nd] *= corr[0];
        o[4 * nd + 1] *= corr[0];
        o[4 * nd + 2] *= corr[1];
        o[4 * nd + 3] *= corr[1];
      }
      wg_pack_p<kN>(s, p);
    }
    const int last = n_mine - 1;
    hp::mbar_wait(v_full(last % kStages), (last / kStages) & 1);
    turn();
    hp::fence_regs(o);
    hp::fence_regs(p);
    hp::wgmma_fence();
    issue_pv(last);
    hp::wgmma_commit();
    if (wg == 0) pass();
    // turns of the tiles warpgroup 0 skipped, so both take n_kv + 1
    for (int j = n_mine; j < n_kv; ++j) {
      turn();
      pass();
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
    if (signals) hp::mbar_arrive(v_empty(last % kStages));

    // epilogue: O / l in bf16 into this warpgroup's Q boxes, swizzled as
    // TMA wrote them (no wgmma reads them any more), then one TMA store a
    // box, which leaves out rows past S and columns past hd; lse in f32
    hp::bar_sync(1 + wg, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const float l_safe = fmaxf(l_r[r], 1e-30f);
      const float inv = 1.0f / l_safe;
      unsigned char* dst = smem + (q_mine - q_s) + row * kRowBytes +
                           4 * (lane & 3);
#pragma unroll
      for (int nd = 0; nd < kHdp / 8; ++nd) {
        const int chunk = (nd % 8) ^ (row & 7);
        *reinterpret_cast<uint32_t*>(dst + (nd / 8) * kQBox + chunk * 16) =
            tc::pack_bf16(o[4 * nd + 2 * r] * inv,
                          o[4 * nd + 2 * r + 1] * inv);
      }
      if ((lane & 3) == 0 && qrow + 8 * r < S) {
        lse[(static_cast<size_t>(b) * S + qrow + 8 * r) * H + h] =
            m_r[r] * kLn2 + logf(l_safe);
      }
    }
    hp::fence_proxy_async();
    hp::bar_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0 && qmin < S) {
      for (int c = 0; c < kBoxes; ++c) {
        hp::tma_store_4d(&tm_o, q_mine + c * kQBox, c * kBoxCols, h, qmin, b);
      }
      hp::tma_store_commit();
      hp::tma_store_wait_read();
    }
  }
}

// Heads a group of the block order (blocks run group by group, and in a
// group q tile by q tile, heaviest first when causal): few heads a group
// spread each head's K and V reads from device memory over the run, one
// group of all heads orders every causal tile heaviest first. Measured on
// an H100 (PERF.md): full mode, 4 heads; causal, 16 heads once the grid
// passes 3 waves of blocks, else all.
int wg_group(bool causal, int n_bh, int blocks, int sms) {
  if (!causal) return min(4, n_bh);
  return blocks > 3 * sms ? min(16, n_bh) : n_bh;
}

template <int kHdp, bool kCausal>
int launch_wg(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int H, int hd, cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<kHdp>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wg_kernel<kHdp, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!hp::encode_bshd(&tm_q, q, B, S, H, hd, 64) ||
      !hp::encode_bshd(&tm_k, k, B, S, H, hd, wg_block_n<kHdp>()) ||
      !hp::encode_bshd(&tm_v, v, B, S, H, hd, wg_block_n<kHdp>()) ||
      !hp::encode_bshd(&tm_o, out, B, S, H, hd, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = B * H * ((S + kWgBlockQ - 1) / kWgBlockQ);
  int device = 0;
  int sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = wg_group(kCausal, B * H, grid, sms);
  flash_fwd_wg_kernel<kHdp, kCausal><<<grid, kWgThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, lse, S, H,
      1.4426950408889634f / sqrtf(static_cast<float>(hd)), group);
  return static_cast<int>(cudaGetLastError());
}

template <int kHdp, bool kCausal>
int info_wg(int* info) {
  constexpr size_t smem = wg_smem_bytes<kHdp>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wg_kernel<kHdp, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return tc::kernel_info(flash_fwd_wg_kernel<kHdp, kCausal>, kWgThreads, smem,
                         info);
}

// Dispatch on causal (a template parameter of every kernel).
template <typename Fn>
int with_causal(int causal, Fn&& fn) {
  if (causal) return fn(std::true_type{});
  return fn(std::false_type{});
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

constexpr int kRouteCudaCores = 0;
constexpr int kRouteMmaSync = 1;
constexpr int kRouteWgmma = 2;

// The route, by dtype and shape alone: bf16 inputs a TMA tensor map can
// describe take the wgmma kernel, other bf16 inputs the mma.sync one.
int route(const void* q, const void* k, const void* v, const void* out,
          int hd, int dtype) {
  if (dtype == 0) return kRouteCudaCores;
  const bool tma = hd % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) &&
                   tc::aligned16(v) && tc::aligned16(out);
  return tma ? kRouteWgmma : kRouteMmaSync;
}

}  // namespace

// q, k, v, out: (B, S, H, hd) contiguous, f32 (dtype 0) or bf16 (dtype 1);
// lse: (B, S, H) f32; causal: 1 for the causal mask, 0 for none. Launches
// on `stream` and returns cudaGetLastError() (0 on success). The caller
// checks shapes, types and contiguity.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int S, int H, int hd, int dtype,
                                      int causal, void* stream) {
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
            q, k, v, out, lse, B, S, H, hd, st);
      });
    });
  }
  if (dtype == 1) {
    if ((S + kTcBlockQ - 1) / kTcBlockQ > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool wgmma = route(q, k, v, out, hd, dtype) == kRouteWgmma;
    return with_hdp(hd, [&](auto hdp) {
      return with_causal(causal, [&](auto c) {
        constexpr int kHdp = decltype(hdp)::value;
        constexpr bool kCausal = decltype(c)::value;
        return wgmma ? launch_wg<kHdp, kCausal>(q, k, v, out, lse, B, S, H,
                                                hd, st)
                     : launch_tc<kHdp, kCausal>(q, k, v, out, lse, B, S, H,
                                                hd, st);
      });
    });
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The compiled kernel of the route that `dtype` and `causal` take at head
// dim `hd`: info[0..5] as tc::kernel_info gives them (registers, static and
// dynamic shared memory, spill bytes, blocks an SM, threads a block).
// Returns a CUDA error code (0 on success).
extern "C" int flash_attention_info(int hd, int dtype, int causal,
                                    int* info) {
  if (hd < 1 || hd > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    const size_t smem = f32_smem_bytes(hd | 1);
    return with_cols(hd, [&](auto cols) {
      return with_causal(causal, [&](auto c) {
        auto* kernel =
            flash_fwd_kernel<float, decltype(cols)::value, decltype(c)::value>;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        return tc::kernel_info(kernel, kThreads, smem, info);
      });
    });
  }
  if (dtype == 1) {
    const bool wgmma = route(nullptr, nullptr, nullptr, nullptr, hd, dtype) ==
                       kRouteWgmma;
    return with_hdp(hd, [&](auto hdp) {
      return with_causal(causal, [&](auto c) {
        constexpr int kHdp = decltype(hdp)::value;
        constexpr bool kCausal = decltype(c)::value;
        return wgmma ? info_wg<kHdp, kCausal>(info)
                     : info_tc<kHdp, kCausal>(info);
      });
    });
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The route flash_attention_launch takes for these pointers, head dim and
// dtype: 0 the f32 CUDA-core kernel, 1 the bf16 mma.sync kernel, 2 the bf16
// wgmma kernel (hd % 8 == 0 and every pointer 16-byte aligned: what a TMA
// tensor map can describe).
extern "C" int flash_attention_route(const void* q, const void* k,
                                     const void* v, const void* out, int hd,
                                     int dtype) {
  return route(q, k, v, out, hd, dtype);
}
