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
// bf16 route (flash_fwd_tc_kernel, the serve path): one block of 4 warps
// per (b, h, 128-row q tile), each warp owning 2 row blocks of 16 q rows,
// up to a padded head dim (hdp) of 128. Above it (hdp 144 and 160:
// stablelm-12b's head dim is 160) two row blocks' O accumulators alone
// would take 2 * hdp / 2 = 160 f32 registers a thread, past the 255 cap
// with the scores beside them; so the same 128-row q tile goes to 8 warps
// of 1 row block each (80 accumulator registers). ptxas gives 170
// registers and no spill at hdp 160; its 129,024 bytes of shared memory
// (Q, then two stages of K and V, at a pitch of 168) allow 1 block, 8
// warps, an SM, as many warps as 2 blocks of 4 below it.
// S = Q K^T and O += P V run on the tensor cores as mma.sync.m16n8k16
// (bf16 operands, f32 sums); Q, K and V fragments come from shared memory
// through ldmatrix (V with .trans), and each K or V fragment serves both
// row blocks of a warp. P is rounded to bf16 only as the A operand of
// P V, while the row sum l and the lse come from the unrounded f32 P. The
// TPU reference multiplies at the matrix unit's default precision (bf16
// passes), so this is no looser. Loads: Q once per block, then K and V
// tiles of 64 rows through a two-stage ring in shared memory, 16-byte
// cp.async a thread: the copy of kv tile j + 1 is in flight while the
// tensor cores work on tile j (two barriers a tile). The head dim is
// padded to a multiple of 16 with zeros in shared memory only (rows of
// hd + 8 elements: 16-byte aligned, ldmatrix conflict-free); columns past
// hd are never stored. Where hd is not a multiple of 8 or an input is not
// 16-byte aligned, the same tiles are filled element by element. Q tiles
// are launched heaviest first (the q tile is blockIdx.y, reversed): tile i
// reads 2 (i + 1) kv tiles.
// Why mma.sync and not wgmma: its fragments live in one warp's registers,
// so the online softmax, the causal mask and the P -> A-operand hand-off
// are per-thread register code. A wgmma version (A from registers, K and
// V through descriptors of unswizzled shared memory, one warpgroup a
// block) was built and was correct on the card, but slower than this one;
// swizzled tiles, TMA and warp-specialised warpgroups are the later work
// that wgmma needs to pay off.
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
// Causal or not is a template parameter of both routes' kernels (kCausal),
// so the causal instantiation is the code it was before the full mode came,
// with the same registers; a runtime branch could push the bf16 kernel at
// hdp 160 (170 registers) into spills. Without the causal mask every q
// tile reads every kv tile (the work is the same for every q tile, so the
// bf16 grid keeps plain order), the diagonal mask goes, and only the
// ragged last kv tile is masked, on kpos < S.
//
// Both routes: the causal skip comes from token positions: a q tile whose
// last row is s_last reads kv tiles up to s_last only, and a score is
// masked on kpos <= qpos and kpos < S (the bf16 route masks only the kv
// tiles that cross the diagonal or the end of S: two of a 128-row q tile). The Pallas kernel's tile-index
// skip (j <= i) is exact only for equal q and kv blocks and is not copied.
// The last tile of a ragged S is short: rows past S load as zeros, are
// masked, and are never stored, so any S works. out is written in the
// input dtype (round to nearest), lse in f32.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W), bf16 at
// (4, 512, 32, 112): 0.0564 ms a launch (0.0472 ms CUPTI busy) against
// scaled_dot_product_attention's 0.0318 ms busy on the same inputs; the
// first design, f32 on the CUDA cores, took 0.6051 ms there. ptxas: 255
// registers (24 bytes spilled), 92,160 bytes of shared memory, 2 blocks
// an SM, so the 512 blocks of that shape run in about 2 waves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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
    return with_hdp(hd, [&](auto hdp) {
      return with_causal(causal, [&](auto c) {
        return launch_tc<decltype(hdp)::value, decltype(c)::value>(
            q, k, v, out, lse, B, S, H, hd, st);
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
    return with_hdp(hd, [&](auto hdp) {
      return with_causal(causal, [&](auto c) {
        return info_tc<decltype(hdp)::value, decltype(c)::value>(info);
      });
    });
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
