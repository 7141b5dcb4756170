// RWKV-6 WKV chunked recurrence for Hopper (sm_90a).
//
// Per (batch b, head h) the (N, N) state S, keyed [key channel n, value
// channel m], follows S_t = diag(w_t) S_{t-1} + k_t v_t^T with readout
// out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T). It is evaluated chunk by
// chunk, with the clamped formulae of the Pallas body, for every chunk of
// c time steps:
//
//   logw = log(max(w, 1e-8));  cum = max(inclusive_cumsum(logw), -30)
//   r_dec  = r * exp(cum - logw)       k_over = k * exp(-cum)
//   scores = strictly_lower(r_dec . k_over^T)
//   out    = r_dec . S + scores . v + (sum_n r u k) v
//   S_next = exp(cum[c-1]) S + (k * exp(cum[c-1] - cum))^T . v
//
// with S carried from chunk to chunk, from state0, and written out at the
// end. Replaces the Pallas TPU kernel kernels/rwkv6_wkv.py::wkv of the JAX
// package (body _wkv_kernel, pallas_call at :109). The TPU grid walks the
// chunks in order with the state in VMEM scratch; here one block walks the
// chunks in a loop. The kernels index (B, T, H, N) directly and need none
// of the Pallas wrapper's (B*H, T, N) transposes. The chunk is the
// wrapper's: the largest c <= 64 that divides T; any c from 1 to 64 is
// right, and any N from 1 to 64.
//
// Bound: at (B, T, H, N) = (4, 512, 40, 64) with bf16 r, k, v, w and out,
// and f32 u and states, the function moves about 57.7 MB: about 17 us at
// 3.35 TB/s. Its work is about 2.7 GFLOP (four c x c x N or c x N x N
// products per chunk and head): 2.7 us on the bf16 tensor cores, 40 us in
// f32 on the CUDA cores. So the bf16 routes are bound by bytes once their
// products are on the tensor cores, and what stands between them and that
// bound is latency: the chunks of a head form one dependent chain.
//
// The dtype and shape pick the route (rwkv6_wkv.py::fwd_route, the
// launcher's dtype code): f32 the CUDA cores (0); bf16 at N = chunk = 64
// with r, k, v, w, out 16-byte aligned (TMA maps describe them) three
// warpgroups a (b, h) on Hopper's TMA and wgmma (2), any T a multiple of 64
// (rwkv6-3b's serve and train paths); every other bf16 input mma.sync (1).
//
// bf16 wgmma route (wkv_wg_kernel): what is serial from chunk to chunk is
// only S_c = diag(exp(cum[c-1])) (S_{c-1} + k_over^T v) and the readout
// r_dec . S_{c-1}; the scores, the intra-chunk output and k_over^T v do not
// read S. So the elementwise pass that forms r_dec and k_over (the
// latency-bound part: log-space sums, exponentials, splits) runs on two
// warpgroups of its own, a chunk ahead of the products, and a third
// warpgroup runs every product on wgmma with S in f32 registers. 160
// blocks of 384 threads at the serve shape, 2 an SM (setmaxnreg: 128
// registers for the products, 56 for each pass warpgroup; 112,896 bytes of
// shared memory), all in one wave; one (b, h) a block, since each further
// split of a head over value columns would repeat the pass and the scores.
// The decay is carried as a running product of max(w, 1e-8) clamped at
// e^-30 (two reciprocals an element instead of a log and two exponentials;
// the same clamps as max(cumsum(log w), -30)), and the diagonal bonus
// sum_n r u k rides on the scores' diagonal into scores . v. Every f32
// operand of a product is split into bf16 hi + lo as on the mma.sync route
// (below): r_dec, k_over, the masked scores (with the bonus) and S; 40
// wgmma m64n64k16 a chunk. What bounds it now is the products' warpgroup:
// about 0.73 us of tensor-core time a chunk (40 x 32 cycles, each also
// reading its two 2 KB operands from shared memory at 128 B a cycle), the
// masking and splitting of the scores and the split of S between them;
// PERF.md gives the measured phases (tools/trace_wkv_fwd.py).
// tests/test_torch_wkv_hopper_route.py emulates its arithmetic.
//
// bf16 mma.sync route (wkv_tc_kernel: chunk below 64, N below 64,
// unaligned views): the four products run on the
// tensor cores as mma.sync.m16n8k16, bf16 operands and f32 sums. Every
// operand that is f32 inside the kernel (r_dec, k_over, the masked scores
// and the carried state) is split into two bf16 parts, x = hi + lo with
// lo = bf16(x - hi), about 16 bits of x, and a product of two such
// operands takes three mma (hi.hi + hi.lo + lo.hi), one with the exact
// bf16 v two. One bf16 rounding of each operand, as the flash and SSD
// kernels do, misses the JAX package's bf16 tolerance (out 5e-2) where w
// is near 1, as the served model draws it, and by far where cum reaches
// the -30 clamp: the readout sums terms much larger than its result.
// tests/test_torch_tensor_core_rounding.py holds both against the JAX
// oracles, and shows that each of the lo parts is needed. Design, for one
// block per (b, h) with 4 warps (160 blocks at the serve shape, 2 an SM:
// one wave):
//   - the chunk's r, k, w and v are copied by cp.async (16 bytes a
//     thread) into shared memory, the next chunk's while the tensor cores
//     work on this one (v has two stages); c and N pad to 64 rows and 16,
//     32 or 64 columns with zeros in shared memory only, and where N is
//     not a multiple of 8 (or an input not 16-byte aligned) the same tiles
//     fill element by element;
//   - warp w owns chunk rows 16w..16w+15 and computes their elementwise
//     pass in f32, in base 2 (lg2 and ex2 need no scaling), in the lane
//     order of an mma A fragment: log w, the clamped cumsum (a shuffle
//     scan down the warp's rows, then the column totals of the earlier
//     warps through shared memory), two exp, and the diagonal bonus
//     sum_n r u k from the unscaled r and k (a quad shuffle sum). r_dec
//     never leaves registers: its hi and lo parts are the A fragments of
//     the scores and of the state readout. k_over goes to shared memory as
//     hi and lo tiles, with a pitch of N + 8 so that ldmatrix is free of
//     bank conflicts;
//   - scores = r_dec . k_over^T, only on the tiles at or below the
//     diagonal, masked strictly lower in f32, then split in registers as
//     the A fragments of scores . v (as flash feeds P.V);
//   - the state stays f32 in registers as C tiles, 16 state rows a warp,
//     for the whole scan. Its update is S = exp(cum[c-1]) (S + k_over^T .
//     v), row by row, the same as exp(cum[c-1]) S + k_scaled^T . v since
//     k_scaled = exp(cum[c-1]) k_over: k_over^T comes through
//     ldmatrix.trans and no k_scaled is formed. The state's hi and lo
//     copies in shared memory are the B operand of r_dec . S, written
//     after the readout behind a barrier;
//   - the part products go round all of a warp's accumulators, so that no
//     mma waits on the one before it.
//   Four barriers a chunk: data landed; the column totals of the cumsum;
//   the k_over tiles; the old state read. What sets its time is issue and
//   latency, not bytes or tensor-core rate: PERF.md gives the measured
//   parts.
//
// f32 route (wkv_kernel, unchanged from the first port): f32 on the CUDA
// cores. It is kept for f32 inputs because it meets the f32 tolerance
// (1e-4); the serve path draws bf16 weights and never takes it, the tests
// and chip_smoke.py do. The value columns m of the state are independent
// (out[t, m] and S[:, m] read only column m of v), so the grid is (column
// tile of 32, h, b), and each block recomputes the c x c scores, which
// need every key channel. 256 threads. Each chunk stages r, k, log w
// (c x N) and the block's 32 columns of v as f32 in shared memory (odd row
// pitches, so that column walks are free of bank conflicts). Then each
// warp takes every 8th key channel n and scans log w down its c rows with
// shuffles (a lane holds rows lane and lane + 32); the same lane turns r, k
// into r_dec, k_over and k_scaled in place and adds its r u k to a
// per-warp part of the diagonal. Then the scores, the readout and last the
// state update, each after a barrier, in register tiles of 4 x 4 (scores)
// and 4 x 2 (readout, state).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

// --------------------------------------------------------------------------
// f32 route: CUDA cores (the first port, unchanged)
// --------------------------------------------------------------------------


constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;
constexpr int kMaxN = 64;
constexpr int kTile = 32;           // value columns of the state per block
constexpr int kTile1 = kTile + 1;   // its row pitch in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ state0,
           T* __restrict__ out, float* __restrict__ state_out, int T_len,
           int H, int N, int c) {
  extern __shared__ float smem[];
  const int N1 = N + 1, C1 = c + 1;
  float* st = smem;               // N x kTile1: this block's state columns
  float* ra = st + N * kTile1;    // c x N1: r, then r_dec
  float* ka = ra + c * N1;        // c x N1: k, then k_over
  float* wa = ka + c * N1;        // c x N1: log w, then k_scaled
  float* vb = wa + c * N1;        // c x kTile1: this block's columns of v
  float* sc = vb + c * kTile1;    // c x C1: strictly lower scores
  float* dp = sc + c * C1;        // kWarps x c: per-warp parts of sum_n r u k
  float* dg = dp + kWarps * c;    // c: sum_n r u k
  float* pl = dg + c;             // N: exp(cum[c-1])
  float* us = pl + N;             // N: u of head h

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lo = tid & 15, hi = tid >> 4;   // a 16 x 16 thread grid
  const int m0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int mw = min(kTile, N - m0);        // valid columns of the tile
  const size_t state_base = (static_cast<size_t>(b) * H + h) * N * N;

  for (int i = tid; i < N * kTile; i += kThreads) {
    const int n = i / kTile;
    const int m = i - n * kTile;
    st[n * kTile1 + m] = m < mw ? state0[state_base + n * N + m0 + m] : 0.0f;
  }
  for (int n = tid; n < N; n += kThreads) us[n] = u[h * N + n];

  // rows of the thread's register tiles, clamped into the chunk for loads
  // (a row past c is computed on and never stored)
  int row[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) row[a] = min(hi + 16 * a, c - 1);

  for (int t0 = 0; t0 < T_len; t0 += c) {
    __syncthreads();  // the previous chunk's state update is done
    const size_t step0 = static_cast<size_t>(b) * T_len + t0;
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const size_t off = ((step0 + t) * H + h) * N + n;
      ra[t * N1 + n] = to_f32(r[off]);
      ka[t * N1 + n] = to_f32(k[off]);
      wa[t * N1 + n] = logf(fmaxf(to_f32(w[off]), 1e-8f));
    }
    for (int i = tid; i < c * kTile; i += kThreads) {
      const int t = i / kTile;
      const int m = i - t * kTile;
      vb[t * kTile1 + m] =
          m < mw ? to_f32(v[((step0 + t) * H + h) * N + m0 + m]) : 0.0f;
    }
    __syncthreads();

    // per key channel: the clamped cumsum and the scaled r and k
    {
      const int ta = lane, tb = lane + 32;
      const bool in_a = ta < c, in_b = tb < c;
      float da = 0.0f, db = 0.0f;
      for (int n = warp; n < N; n += kWarps) {
        const float lwa = in_a ? wa[ta * N1 + n] : 0.0f;
        const float lwb = in_b ? wa[tb * N1 + n] : 0.0f;
        float sa = lwa, sb = lwb;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float ya = __shfl_up_sync(kFull, sa, off);
          const float yb = __shfl_up_sync(kFull, sb, off);
          if (lane >= off) {
            sa += ya;
            sb += yb;
          }
        }
        sb += __shfl_sync(kFull, sa, 31);
        const float cuma = fmaxf(sa, -30.0f);
        const float cumb = fmaxf(sb, -30.0f);
        const float last = __shfl_sync(kFull, c <= 32 ? cuma : cumb,
                                       (c - 1) & 31);
        if (lane == 0) pl[n] = expf(last);
        const float un = us[n];
        if (in_a) {
          const float rv = ra[ta * N1 + n], kv = ka[ta * N1 + n];
          da = fmaf(rv * un, kv, da);
          ra[ta * N1 + n] = rv * expf(cuma - lwa);
          ka[ta * N1 + n] = kv * expf(-cuma);
          wa[ta * N1 + n] = kv * expf(last - cuma);
        }
        if (in_b) {
          const float rv = ra[tb * N1 + n], kv = ka[tb * N1 + n];
          db = fmaf(rv * un, kv, db);
          ra[tb * N1 + n] = rv * expf(cumb - lwb);
          ka[tb * N1 + n] = kv * expf(-cumb);
          wa[tb * N1 + n] = kv * expf(last - cumb);
        }
      }
      if (in_a) dp[warp * c + ta] = da;
      if (in_b) dp[warp * c + tb] = db;
    }
    __syncthreads();

    for (int t = tid; t < c; t += kThreads) {
      float d = 0.0f;
      for (int q = 0; q < kWarps; ++q) d += dp[q * c + t];
      dg[t] = d;
    }
    // scores[t, s] = r_dec[t] . k_over[s] for s < t; rows hi + 16a,
    // columns lo + 16b
    {
      int col[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) col[a] = min(lo + 16 * a, c - 1);
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float x[4], y[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          x[a] = ra[row[a] * N1 + n];
          y[a] = ka[col[a] * N1 + n];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = hi + 16 * a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = lo + 16 * q;
          if (t < c && s < c) sc[t * C1 + s] = s < t ? acc[a][q] : 0.0f;
        }
      }
    }
    __syncthreads();

    // readout: out[t, m] = r_dec[t] . S[:, m] + scores[t] . v[:, m]
    //                      + diag[t] v[t, m]; rows hi + 16a, columns lo + 16j
    {
      float acc[4][2] = {};
      for (int n = 0; n < N; ++n) {
        float x[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = ra[row[a] * N1 + n];
        const float y0 = st[n * kTile1 + lo], y1 = st[n * kTile1 + lo + 16];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][0] = fmaf(x[a], y0, acc[a][0]);
          acc[a][1] = fmaf(x[a], y1, acc[a][1]);
        }
      }
      for (int s = 0; s < c; ++s) {
        float x[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = sc[row[a] * C1 + s];
        const float y0 = vb[s * kTile1 + lo], y1 = vb[s * kTile1 + lo + 16];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][0] = fmaf(x[a], y0, acc[a][0]);
          acc[a][1] = fmaf(x[a], y1, acc[a][1]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = hi + 16 * a;
        if (t >= c) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = lo + 16 * j;
          if (m < mw) {
            put(out + ((step0 + t) * H + h) * N + m0 + m,
                acc[a][j] + dg[t] * vb[t * kTile1 + m]);
          }
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S[n, m] = exp(cum[c-1, n]) S[n, m] + sum_s k_scaled[s, n] v[s, m];
    // rows n = hi + 16a, columns lo + 16j
    {
      int nrow[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) nrow[a] = min(hi + 16 * a, N - 1);
      float acc[4][2] = {};
      for (int s = 0; s < c; ++s) {
        float x[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = wa[s * N1 + nrow[a]];
        const float y0 = vb[s * kTile1 + lo], y1 = vb[s * kTile1 + lo + 16];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][0] = fmaf(x[a], y0, acc[a][0]);
          acc[a][1] = fmaf(x[a], y1, acc[a][1]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int n = hi + 16 * a;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* p = st + n * kTile1 + lo + 16 * j;
          *p = *p * pl[n] + acc[a][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * mw; i += kThreads) {
    const int n = i / mw;
    const int m = i - n * mw;
    state_out[state_base + n * N + m0 + m] = st[n * kTile1 + m];
  }
}

size_t f32_smem_bytes(int N, int c) {
  return sizeof(float) * (static_cast<size_t>(N) * kTile1 + 3 * c * (N + 1) +
                          c * kTile1 + c * (c + 1) + kWarps * c + c + 2 * N);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, void* out, float* state_out,
           int B, int T_len, int H, int N, int c, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(N, c);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  wkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state0,
      static_cast<T*>(out), state_out, T_len, H, N, c);
  return static_cast<int>(cudaGetLastError());
}


// --------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync), operands split into bf16 hi and lo
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;              // chunk rows in shared memory
constexpr int kTcWarps = 4;              // 16 chunk rows a warp
constexpr int kTcThreads = 32 * kTcWarps;
static_assert(kTcWarps == 4, "the column totals are read as one float4");

template <int kD>
__host__ __device__ constexpr int tc_pitch() { return kD + 8; }

template <int kD>
constexpr size_t tc_smem_bytes() {
  // r, k, w of one chunk, v of two, k_over's hi and lo: seven 64-row
  // tiles; the state's hi and lo; the warps' column totals of log2 w; u
  return sizeof(bf16) * (7 * kTcRows + 2 * kD) * tc_pitch<kD>() +
         sizeof(float) * (kTcWarps + 1) * kD;
}

// log2(e), and the -30 clamp of cum in log2 units: the elementwise pass
// works in base 2, so that lg2 and ex2 need no scaling
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClamp2 = -30.0f * kLog2e;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

using tc::ld_bf16x2;
using tc::split_bf16;
using tc::st_bf16x2;

// acc[2 i], acc[2 i + 1] += a . (B fragment pair i) for i < n: one mma on
// each of 2 n accumulators in turn.
template <int kN>
__device__ __forceinline__ void mma_tiles(float (*acc)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[kN][4],
                                          int n = kN) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (i >= n) continue;
    tc::mma_bf16(acc[2 * i], a, b[i][0], b[i][1]);
    tc::mma_bf16(acc[2 * i + 1], a, b[i][2], b[i][3]);
  }
}

// kD: N padded to 16, 32 or 64.
template <int kD>
__global__ void __launch_bounds__(kTcThreads, 2)
wkv_tc_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ state0,
              bf16* __restrict__ out, float* __restrict__ state_out,
              int T_len, int H, int N, int c, bool vec) {
  constexpr int kPitch = tc_pitch<kD>();
  constexpr int kTile = kTcRows * kPitch;
  constexpr int kSteps = kD / 16;        // 16-column steps over N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* rs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = rs + kTile;
  bf16* ws = ks + kTile;
  bf16* vs = ws + kTile;                 // two stages
  bf16* ko_hi = vs + 2 * kTile;          // k_over
  bf16* ko_lo = ko_hi + kTile;
  bf16* s_hi = ko_lo + kTile;            // kD x kPitch: the state's parts
  bf16* s_lo = s_hi + kD * kPitch;
  // kD x warps: each warp's column total of log2 w, one 16-byte load a
  // column
  float* tot = reinterpret_cast<float*>(s_lo + kD * kPitch);
  float* us = tot + kTcWarps * kD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t stride = static_cast<size_t>(H) * N;   // between steps
  const size_t base = (static_cast<size_t>(b) * T_len * H + h) * N;
  const size_t state_base = (static_cast<size_t>(b) * H + h) * N * N;
  const int r0 = warp * 16;              // this warp's chunk rows

  for (int n = threadIdx.x; n < kD; n += kTcThreads) {
    us[n] = n < N ? u[h * N + n] : 0.0f;
  }

  // rows past the chunk and columns past N load as zeros
  auto load_rkw = [&](int t0) {
    tc::load_rows<kTcRows, kD, kPitch, kTcThreads>(rs, r + base, stride, t0,
                                                   t0 + c, N, vec);
    tc::load_rows<kTcRows, kD, kPitch, kTcThreads>(ks, k + base, stride, t0,
                                                   t0 + c, N, vec);
    tc::load_rows<kTcRows, kD, kPitch, kTcThreads>(ws, w + base, stride, t0,
                                                   t0 + c, N, vec);
  };
  auto load_v = [&](int t0, int st) {
    tc::load_rows<kTcRows, kD, kPitch, kTcThreads>(vs + st * kTile, v + base,
                                                   stride, t0, t0 + c, N, vec);
  };

  // the state: warp w < kD / 16 holds rows 16 w..16 w + 15 (all kD
  // columns) in f32 registers as C tiles, for the whole scan
  const bool has_state = warp < kD / 16;
  float sacc[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = r0 + g + (e >> 1) * 8;
      const int m = nd * 8 + 2 * t + (e & 1);
      sacc[nd][e] = has_state && n < N && m < N
                        ? state0[state_base + static_cast<size_t>(n) * N + m]
                        : 0.0f;
    }
  }
  auto store_state = [&]() {
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      const int off = (r0 + g) * kPitch + nd * 8 + 2 * t;
      uint32_t hi, lo;
      split_bf16(sacc[nd][0], sacc[nd][1], hi, lo);
      st_bf16x2(s_hi + off, hi);
      st_bf16x2(s_lo + off, lo);
      split_bf16(sacc[nd][2], sacc[nd][3], hi, lo);
      st_bf16x2(s_hi + off + 8 * kPitch, hi);
      st_bf16x2(s_lo + off + 8 * kPitch, lo);
    }
  };
  if (has_state) store_state();

  load_rkw(0);
  load_v(0, 0);
  tc::cp_async_commit();

  // ldmatrix row addresses (see tensor_core.cuh): B from a row-major
  // (n, k) tile; B from a (k, n) tile through .trans; A^T from a (k, m)
  // tile through .trans, for this warp's 16 columns m
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * kPitch +
                    ((lane >> 3) & 1) * 8;
  const int bt_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
                     (lane >> 4) * 8;
  const int at_off = ((lane >> 4) * 8 + (lane & 7)) * kPitch + r0 +
                     ((lane >> 3) & 1) * 8;

  const int n_chunks = T_len / c;
  const int s_blocks = (c + 15) / 16;    // 16-row blocks of the chunk
  const bool has_rows = r0 < c;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int st = ci & 1;
    const int t0 = ci * c;
    const bf16* vt = vs + st * kTile;
    tc::cp_async_wait<0>();
    __syncthreads();   // (1) the chunk has landed; the state's copy is in

    // The elementwise pass, in the lane order of an A fragment: element
    // [kk][q][j] is row r0 + g + 8 (q & 1), column 16 kk + 8 (q >> 1) +
    // 2 t + j. First log2 w (0 past the chunk and past N) and its
    // inclusive sum down the warp's 16 rows: a shuffle scan over g for
    // rows g and g + 8, then the upper half's total onto the lower.
    float lw[kSteps][4][2], inc[kSteps][4][2];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + g + 8 * (q & 1);
        const int col = 16 * kk + 8 * (q >> 1) + 2 * t;
        const float2 wv = ld_bf16x2(ws + row * kPitch + col);
        const bool ok = row < c;
        lw[kk][q][0] = ok && col < N ? lg2(fmaxf(wv.x, 1e-8f)) : 0.0f;
        lw[kk][q][1] = ok && col + 1 < N ? lg2(fmaxf(wv.y, 1e-8f)) : 0.0f;
      }
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float up = lw[kk][2 * ch][j];
          float dn = lw[kk][2 * ch + 1][j];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const float yu = __shfl_up_sync(0xffffffffu, up, off);
            const float yd = __shfl_up_sync(0xffffffffu, dn, off);
            if (lane >= off) {
              up += yu;
              dn += yd;
            }
          }
          dn += __shfl_sync(0xffffffffu, up, 28 + t);
          inc[kk][2 * ch][j] = up;
          inc[kk][2 * ch + 1][j] = dn;
          if (g == 7) tot[(16 * kk + 8 * ch + 2 * t + j) * 4 + warp] = dn;
        }
      }
    }
    __syncthreads();   // (2) every warp's column totals

    // cum = max(sum of the earlier warps' totals + inc, -30) (in base 2);
    // r_dec as A fragments (hi, lo), k_over to shared memory (hi, lo), the
    // diagonal bonus of rows g and g + 8
    uint32_t rh[kSteps][4], rl[kSteps][4];
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        float pre[2], un[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 16 * kk + 8 * ch + 2 * t + j;
          const float4 tv = *reinterpret_cast<const float4*>(tot + n * 4);
          pre[j] = warp > 0 ? (warp > 1 ? (warp > 2 ? tv.x + tv.y + tv.z
                                                    : tv.x + tv.y)
                                        : tv.x)
                            : 0.0f;
          un[j] = us[n];
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = 2 * ch + half;
          const int off = (r0 + g + 8 * half) * kPitch + 16 * kk + 8 * ch +
                          2 * t;
          const float2 rv = ld_bf16x2(rs + off);
          const float2 kv = ld_bf16x2(ks + off);
          const float rr[2] = {rv.x, rv.y};
          const float kq[2] = {kv.x, kv.y};
          float rd[2], ko[2], dg = 0.0f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float cum = fmaxf(pre[j] + inc[kk][q][j], kClamp2);
            rd[j] = rr[j] * ex2(cum - lw[kk][q][j]);
            ko[j] = kq[j] * ex2(-cum);
            dg = fmaf(rr[j] * un[j], kq[j], dg);
          }
          if (half == 0) d0 += dg; else d1 += dg;
          split_bf16(rd[0], rd[1], rh[kk][q], rl[kk][q]);
          uint32_t hi, lo;
          split_bf16(ko[0], ko[1], hi, lo);
          st_bf16x2(ko_hi + off, hi);
          st_bf16x2(ko_lo + off, lo);
        }
      }
    }
    d0 = tc::quad_sum(d0);
    d1 = tc::quad_sum(d1);
    __syncthreads();   // (3) k_over is in; r, k, w are read

    if (ci + 1 < n_chunks) {
      load_rkw(t0 + c);
      load_v(t0 + c, st ^ 1);
    }
    tc::cp_async_commit();

    float yacc[kD / 8][4];
    float sc[8][4];
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nd][e] = 0.0f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.0f;
    if (has_rows) {
      // out = r_dec . S, with S = s_hi + s_lo; the three part products
      // go round all the accumulators, so that no mma waits on the one
      // before it
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t bh[kD / 16][4], bl[kD / 16][4];
#pragma unroll
        for (int nd2 = 0; nd2 < kD / 16; ++nd2) {
          const int off = bt_off + kk * 16 * kPitch + nd2 * 16;
          tc::ldsm_x4_trans(bh[nd2], s_hi + off);
          tc::ldsm_x4_trans(bl[nd2], s_lo + off);
        }
        mma_tiles<kD / 16>(yacc, rh[kk], bh);
        mma_tiles<kD / 16>(yacc, rh[kk], bl);
        mma_tiles<kD / 16>(yacc, rl[kk], bh);
      }
      // scores = r_dec . k_over^T on the column tiles s <= 16 w + 15 that
      // hold chunk rows
      const int n_tiles = min(warp + 1, s_blocks);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t bh[4][4], bl[4][4];
#pragma unroll
        for (int nb2 = 0; nb2 < 4; ++nb2) {
          if (nb2 >= n_tiles) continue;
          const int off = b_off + nb2 * 16 * kPitch + kk * 16;
          tc::ldsm_x4(bh[nb2], ko_hi + off);
          tc::ldsm_x4(bl[nb2], ko_lo + off);
        }
        mma_tiles<4>(sc, rh[kk], bh, n_tiles);
        mma_tiles<4>(sc, rh[kk], bl, n_tiles);
        mma_tiles<4>(sc, rl[kk], bh, n_tiles);
      }
      // strictly lower, in f32: the diagonal is exactly 0 (u replaces it)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = r0 + g + (e >> 1) * 8;
          const int ss = nb * 8 + 2 * t + (e & 1);
          if (ss >= tt) sc[nb][e] = 0.0f;
        }
      }
    }

    // per 16-row block s of the chunk, with v's B fragments loaded once:
    // out += scores . v (the scores split as A fragments), and
    // S += k_over^T . v, then S = exp(cum[c-1]) S row by row: the same as
    // exp(cum[c-1]) S + k_scaled^T . v with k_scaled = exp(cum[c-1]) k_over
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bool pv = has_rows && kk <= warp;
      if (kk >= s_blocks || !(pv || has_state)) continue;
      uint32_t ph[4], pl[4], ah[4], al[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
      if (has_state) {
        tc::ldsm_x4_trans(ah, ko_hi + at_off + kk * 16 * kPitch);
        tc::ldsm_x4_trans(al, ko_lo + at_off + kk * 16 * kPitch);
      }
      uint32_t bv[kD / 16][4];
#pragma unroll
      for (int nd2 = 0; nd2 < kD / 16; ++nd2) {
        tc::ldsm_x4_trans(bv[nd2], vt + bt_off + kk * 16 * kPitch + nd2 * 16);
      }
      if (pv) {
        mma_tiles<kD / 16>(yacc, ph, bv);
        mma_tiles<kD / 16>(yacc, pl, bv);
      }
      if (has_state) {
        mma_tiles<kD / 16>(sacc, ah, bv);
        mma_tiles<kD / 16>(sacc, al, bv);
      }
    }
    if (has_state) {
      const float4 t0v =
          *reinterpret_cast<const float4*>(tot + (r0 + g) * 4);
      const float4 t1v =
          *reinterpret_cast<const float4*>(tot + (r0 + g + 8) * 4);
      const float e0 = ex2(fmaxf(t0v.x + t0v.y + t0v.z + t0v.w, kClamp2));
      const float e1 = ex2(fmaxf(t1v.x + t1v.y + t1v.z + t1v.w, kClamp2));
#pragma unroll
      for (int nd = 0; nd < kD / 8; ++nd) {
        sacc[nd][0] *= e0;
        sacc[nd][1] *= e0;
        sacc[nd][2] *= e1;
        sacc[nd][3] *= e1;
      }
    }

    // out += (sum_n r u k) v on the diagonal; rows past the chunk and
    // columns past N are never stored
    if (has_rows) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tt = r0 + g + 8 * half;
        if (tt >= c) continue;
        const float dg = half ? d1 : d0;
        bf16* dst = out + base + static_cast<size_t>(t0 + tt) * stride;
#pragma unroll
        for (int nd = 0; nd < kD / 8; ++nd) {
          const int m = nd * 8 + 2 * t;
          if (m >= N) continue;
          const float2 vv = ld_bf16x2(vt + tt * kPitch + m);
          const float y0 = fmaf(dg, vv.x, yacc[nd][2 * half]);
          const float y1 = fmaf(dg, vv.y, yacc[nd][2 * half + 1]);
          if ((N & 1) == 0) {
            st_bf16x2(dst + m, tc::pack_bf16(y0, y1));
          } else {
            dst[m] = __float2bfloat16_rn(y0);
            if (m + 1 < N) dst[m + 1] = __float2bfloat16_rn(y1);
          }
        }
      }
    }
    __syncthreads();   // (4) every read of the state's old copy is done
    if (has_state) store_state();
  }

  if (has_state) {
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = r0 + g + (e >> 1) * 8;
        const int m = nd * 8 + 2 * t + (e & 1);
        if (n < N && m < N) {
          state_out[state_base + static_cast<size_t>(n) * N + m] =
              sacc[nd][e];
        }
      }
    }
  }
}

template <int kD>
int set_smem_tc() {
  return static_cast<int>(cudaFuncSetAttribute(
      wkv_tc_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tc_smem_bytes<kD>())));
}

template <int kD>
int launch_tc(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* state0, void* out,
              float* state_out, int B, int T_len, int H, int N, int c,
              cudaStream_t stream) {
  const int err = set_smem_tc<kD>();
  if (err != 0) return err;
  const bool vec = N % 8 == 0 && tc::aligned16(r) && tc::aligned16(k) &&
                   tc::aligned16(v) && tc::aligned16(w);
  const dim3 grid(H, B);
  wkv_tc_kernel<kD><<<grid, kTcThreads, tc_smem_bytes<kD>(), stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(w), u, state0,
      static_cast<bf16*>(out), state_out, T_len, H, N, c, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int info_tc(int* info) {
  const int err = set_smem_tc<kD>();
  if (err != 0) return err;
  return tc::kernel_info(wkv_tc_kernel<kD>, kTcThreads, tc_smem_bytes<kD>(),
                         info);
}


// --------------------------------------------------------------------------
// bf16 wgmma route on Hopper: one warpgroup a (b, h) walks the chunks, TMA
// tiles and wgmma, every f32 operand split into bf16 hi + lo (N = chunk =
// 64, any number of chunks)
// --------------------------------------------------------------------------

using hp::desc_k;
using hp::desc_mn;
using hp::kSwTile;
using hp::ld_sw;
using hp::rcp_approx;
using hp::st_frag;
using hp::st_sw;
using hp::sw;

constexpr int kMmaThreads = 128;            // the products' warpgroup
constexpr int kPassThreads = 256;           // the two pass warpgroups
constexpr int kWgThreads = kMmaThreads + kPassThreads;
constexpr int kStages = 2;                  // of each ring
constexpr int kMmaRegs = 128;               // by setmaxnreg; 3 x 80 in all
constexpr int kPassRegs = 56;
// a stage of chunk tiles: r, k, w by TMA, then r_dec's hi and lo in place
// of r and k, k_over's in place of w and in X
constexpr int kRkwx = 4 * kSwTile;
// byte offsets from the 1024-aligned base: the r, k, w, X stages, v's
// stages, the state's hi and lo tiles, out's tile, the pass's column
// products of w (two sets of 8 x 64 f32), each stage's vectors
// (exp(cum[c-1]) and the diagonal bonus, 2 x 64 f32) and u
constexpr int kOffV = kStages * kRkwx;
constexpr int kOffS = kOffV + kStages * kSwTile;
constexpr int kOffOut = kOffS + 2 * kSwTile;
constexpr int kOffTot = kOffOut + kSwTile;
constexpr int kOffVec = kOffTot + 2 * 8 * 64 * static_cast<int>(sizeof(float));
constexpr int kOffU = kOffVec + kStages * 128 * static_cast<int>(sizeof(float));
constexpr size_t kWgSmem = 1024 + kOffU + 64 * sizeof(float);
// named barriers: 1 the pass's warpgroups, 2 the products'
constexpr int kBarPass = 1, kBarMma = 2;
// e^-30, the clamp of the cumulative decay
constexpr float kClampExp = 9.357623e-14f;

// The elementwise pass of one chunk, by the 256 threads of the two pass
// warpgroups, whose r, k and w tiles (swizzled as TMA wrote them) start at
// `st`: warp w (0..7) takes the chunk's rows 8 w..8 w + 7, lane l key
// channels 2 l and 2 l + 1 (a warp's load is one 128-byte row). The decay
// is carried as a product, exp(cum) = max(prod_s max(w_s, 1e-8), e^-30),
// the same clamps as the Pallas body's log-space sums: w's running product
// down the warp's rows, the warps' column products through `tot`, one
// barrier; then, w read again, e = max(the earlier warps' products x the
// running product, e^-30), r_dec = r (e / w) and k_over = k / e, each split
// into bf16 hi and lo in place: r_dec in r's and k's tiles, k_over in w's
// and X. vec[0..63] gets exp(cum[c-1]) of each key channel (the state
// rows' decay), vec[64..127] the diagonal bonus sum_n r u k of each row (a
// fixed tree of shuffles over the warp).
__device__ __forceinline__ void wkv_pass(unsigned char* st, float* tot,
                                         float* vec, const float* us) {
  const int warp = (threadIdx.x - kMmaThreads) >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = 8 * warp;
  const int n0 = 2 * lane;
  unsigned char* rt = st;
  unsigned char* kt = st + kSwTile;
  unsigned char* wt = st + 2 * kSwTile;
  unsigned char* xt = st + 3 * kSwTile;
  float run0 = 1.0f, run1 = 1.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 wv = ld_sw(wt, r0 + i, n0);
    run0 *= fmaxf(wv.x, 1e-8f);
    run1 *= fmaxf(wv.y, 1e-8f);
  }
  *reinterpret_cast<float2*>(tot + warp * 64 + n0) = make_float2(run0, run1);
  hp::bar_sync(kBarPass, kPassThreads);   // every warp's column products
  float pre0 = 1.0f, pre1 = 1.0f;
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    if (q < warp) {
      const float2 tq = *reinterpret_cast<const float2*>(tot + q * 64 + n0);
      pre0 *= tq.x;
      pre1 *= tq.y;
    }
  }
  if (warp == 7) {
    vec[n0] = fmaxf(pre0 * run0, kClampExp);
    vec[n0 + 1] = fmaxf(pre1 * run1, kClampExp);
  }
  const float u0 = us[n0], u1 = us[n0 + 1];
  float dp[8];
  float inc0 = 1.0f, inc1 = 1.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + i;
    const float2 wv = ld_sw(wt, row, n0);
    const float w0 = fmaxf(wv.x, 1e-8f), w1 = fmaxf(wv.y, 1e-8f);
    inc0 *= w0;
    inc1 *= w1;
    const float e0 = fmaxf(pre0 * inc0, kClampExp);
    const float e1 = fmaxf(pre1 * inc1, kClampExp);
    const float2 rv = ld_sw(rt, row, n0);
    const float2 kv = ld_sw(kt, row, n0);
    dp[i] = fmaf(rv.y * u1, kv.y, rv.x * u0 * kv.x);
    uint32_t hi, lo;
    split_bf16(rv.x * (e0 * rcp_approx(w0)), rv.y * (e1 * rcp_approx(w1)),
               hi, lo);
    st_sw(rt, row, n0, hi);
    st_sw(kt, row, n0, lo);
    split_bf16(kv.x * rcp_approx(e0), kv.y * rcp_approx(e1), hi, lo);
    st_sw(wt, row, n0, hi);
    st_sw(xt, row, n0, lo);
  }
  // the bonus of each row, summed over the warp's lanes
  const float bonus = tc::row_sums8(dp);
  if ((lane & 3) == 0) vec[64 + r0 + tc::row8_of(lane)] = bonus;
  hp::fence_proxy_async();   // the tiles, for the wgmma that read them
}

// One block of three warpgroups per (b, h) walks the chunks in order. The
// two pass warpgroups (warps 4-11, 48 registers) run the elementwise pass of
// each chunk (wkv_pass) as soon as its r, k, w have come by TMA, one chunk
// ahead of the products; the products' warpgroup (warps 0-3, 144
// registers) holds the state S in f32 registers (the wgmma D fragment:
// rows n, columns m) and its hi and lo copies in shared memory, and issues
// the TMA copies. What stays serial from chunk to chunk is the state's
// elementwise decay, its copy, and the readout that reads it. Chunk c, with
// r_dec(c) and k_over(c) in its stage's tiles:
//   1. the scores = r_dec . k_over^T (wgmma), then a second group: y =
//      r_dec . S_{c-1} (S's hi and lo tiles) and S += k_over^T . v
//      (k_over's tiles transposed), each f32 operand as hi + lo (hi.hi +
//      hi.lo + lo.hi; one product of each part with the exact bf16 v);
//   2. while the second group runs, the scores masked strictly lower in
//      f32 with the diagonal bonus sum_n r u k on the diagonal and split as
//      A fragments; y += scores . v (wgmma, chained onto the readout);
//   3. once every warp's products are done, chunk c + 2's r, k, w are
//      loaded into the stage they read, S = exp(cum[c-1]) S (the same as
//      exp(cum[c-1]) S_{c-1} + k_scaled^T v) goes to its hi and lo tiles
//      and y in bf16 to out's tile (stmatrix), stored by TMA at the start
//      of the next chunk.
// Tried and dropped: issuing chunk c + 1's scores before chunk c's tiles
// are written (ptxas then serialises the wgmma, C7515, and spills), and
// splitting S while y's last products run (no faster; 8 bytes spill).
// Maps: r, k, v, w, out as (N, H, T, B) of bf16, 128-byte swizzled boxes of
// 64 columns x 64 rows. Barriers: TMA's (r, k, w and v stages), the pass's
// (a stage's tiles and vectors in), one named barrier a chunk in the pass
// and two in the products'.
__global__ void __launch_bounds__(kWgThreads, 2)
wkv_wg_kernel(const __grid_constant__ CUtensorMap tm_r,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_out,
              const float* __restrict__ u, const float* __restrict__ state0,
              float* __restrict__ state_out, int T_len, int H) {
  // r, k, w stages in (TMA), v stages in (TMA), a stage's pass done
  __shared__ __align__(8) uint64_t full[3 * kStages];
  extern __shared__ unsigned char smem_raw[];
  // the base aligned to 1024 by an offset into the shared array, so that
  // every access through it compiles to shared loads and stores
  unsigned char* smem =
      smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = hp::smem_u32(smem);
  float* tot = reinterpret_cast<float*>(smem + kOffTot);
  float* vecs = reinterpret_cast<float*>(smem + kOffVec);
  float* us = reinterpret_cast<float*>(smem + kOffU);
  const uint32_t bar_rkw = hp::smem_u32(full);
  const uint32_t bar_v = bar_rkw + 8 * kStages;
  const uint32_t bar_pass = bar_v + 8 * kStages;
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int K = T_len / 64;
  auto load_rkw = [&](int c) {
    const int st = c & 1;
    const uint32_t dst = base + st * kRkwx;
    const uint32_t bar = bar_rkw + 8 * st;
    hp::mbar_expect_tx(bar, 3 * kSwTile);
    hp::tma_load_4d(dst, &tm_r, bar, 0, h, 64 * c, b);
    hp::tma_load_4d(dst + kSwTile, &tm_k, bar, 0, h, 64 * c, b);
    hp::tma_load_4d(dst + 2 * kSwTile, &tm_w, bar, 0, h, 64 * c, b);
  };
  auto load_v = [&](int c) {
    const int st = c & 1;
    const uint32_t bar = bar_v + 8 * st;
    hp::mbar_expect_tx(bar, kSwTile);
    hp::tma_load_4d(base + kOffV + st * kSwTile, &tm_v, bar, 0, h, 64 * c,
                    b);
  };
  if (tid == 0) {
    hp::prefetch_tensormap(&tm_r);
    hp::prefetch_tensormap(&tm_k);
    hp::prefetch_tensormap(&tm_v);
    hp::prefetch_tensormap(&tm_w);
    hp::prefetch_tensormap(&tm_out);
#pragma unroll
    for (int i = 0; i < 2 * kStages; ++i) hp::mbar_init(bar_rkw + 8 * i, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      hp::mbar_init(bar_pass + 8 * i, kPassThreads);
    }
    hp::fence_barrier_init();
    load_rkw(0);
    load_v(0);
    if (K > 1) {
      load_rkw(1);
      load_v(1);
    }
  }
  if (tid >= kMmaThreads && tid < kMmaThreads + 64) {
    us[tid - kMmaThreads] = u[h * 64 + tid - kMmaThreads];
  }
  __syncthreads();   // the barriers and u

  if (tid >= kMmaThreads) {
    // the pass warpgroups
    hp::setmaxnreg_dec<kPassRegs>();
    for (int c = 0; c < K; ++c) {
      const int st = c & 1;
      hp::mbar_wait(bar_rkw + 8 * st, (c >> 1) & 1);
      wkv_pass(smem + st * kRkwx, tot + st * 512, vecs + st * 128, us);
      hp::mbar_arrive(bar_pass + 8 * st);
    }
    return;
  }

  // the products' warpgroup
  hp::setmaxnreg_inc<kMmaRegs>();
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * warp;
  const uint32_t s_hi = base + kOffS;
  const uint32_t s_lo = s_hi + kSwTile;
  const uint32_t o_tile = base + kOffOut;
  const uint64_t d_sh = desc_mn(s_hi, 0), d_sl = desc_mn(s_lo, 0);
  const size_t bh = static_cast<size_t>(b) * H + h;
  float S[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 v = *reinterpret_cast<const float2*>(
          state0 + bh * 4096 + (r0 + g + 8 * hh) * 64 + 8 * j + 2 * t);
      S[2 * hh + 4 * j] = v.x;
      S[2 * hh + 4 * j + 1] = v.y;
    }
  st_frag<true>(s_hi, s_lo, S);
  hp::fence_proxy_async();

  for (int c = 0; c < K; ++c) {
    // S_{c-1}'s tiles and chunk c - 1's out tile are in; every read of
    // chunk c - 1's v is done
    hp::bar_sync(kBarMma, kMmaThreads);
    if (tid == 0) {
      if (c >= 1) {
        hp::tma_store_4d(&tm_out, o_tile, 0, h, 64 * (c - 1), b);
        hp::tma_store_commit();
      }
      if (c >= 1 && c + 1 < K) load_v(c + 1);
    }
    const int st = c & 1;
    const uint32_t rd_hi = base + st * kRkwx;
    const uint32_t vt = base + kOffV + st * kSwTile;
    hp::mbar_wait(bar_pass + 8 * st, (c >> 1) & 1);
    hp::mbar_wait(bar_v + 8 * st, (c >> 1) & 1);
    // this chunk's vectors, read before the pass of chunk c + 2 may write
    // them (it waits for the load issued below)
    const float* vec = vecs + st * 128;
    const float p0 = vec[r0 + g], p1 = vec[r0 + g + 8];
    const float dg0 = vec[64 + r0 + g], dg1 = vec[72 + r0 + g];

    // 1. scores = r_dec . k_over^T; then y = r_dec . S_{c-1} and S +=
    // k_over^T . v, a second group. Descriptors at k step 0; a k step adds
    // 2 (32 bytes on, K-major) or 128 (16 rows of 128 bytes, MN-major) to
    // the address field, which never carries out (shared memory < 256 KB)
    const uint64_t d_rh = desc_k(rd_hi, 0);
    const uint64_t d_rl = desc_k(rd_hi + kSwTile, 0);
    const uint64_t d_kh = desc_k(rd_hi + 2 * kSwTile, 0);
    const uint64_t d_kl = desc_k(rd_hi + 3 * kSwTile, 0);
    const uint64_t d_khT = desc_mn(rd_hi + 2 * kSwTile, 0);
    const uint64_t d_klT = desc_mn(rd_hi + 3 * kSwTile, 0);
    const uint64_t d_v = desc_mn(vt, 0);
    float y[32], sc[32];
    hp::fence_regs(S);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hp::mma_ss(sc, d_rh + 2 * kk, d_kh + 2 * kk, kk > 0);
      hp::mma_ss(sc, d_rh + 2 * kk, d_kl + 2 * kk, 1);
      hp::mma_ss(sc, d_rl + 2 * kk, d_kh + 2 * kk, 1);
    }
    hp::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hp::mma_ss_t<0, 1>(y, d_rh + 2 * kk, d_sh + 128 * kk, kk > 0);
      hp::mma_ss_t<0, 1>(y, d_rh + 2 * kk, d_sl + 128 * kk, 1);
      hp::mma_ss_t<0, 1>(y, d_rl + 2 * kk, d_sh + 128 * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hp::mma_ss_t<1, 1>(S, d_khT + 128 * kk, d_v + 128 * kk, 1);
      hp::mma_ss_t<1, 1>(S, d_klT + 128 * kk, d_v + 128 * kk, 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();
    hp::fence_regs(sc);

    // 2. while the second group runs: the scores strictly lower, the bonus
    // on the diagonal, split as A fragments; y += scores . v (chained onto
    // the readout)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = r0 + g + 8 * (e >> 1);
        const int ss = 8 * j + 2 * t + (e & 1);
        if (ss >= tt) {
          sc[4 * j + e] = ss == tt ? ((e >> 1) ? dg1 : dg0) : 0.0f;
        }
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1], ph[kk][q],
                   pl[kk][q]);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hp::mma_rs(y, ph[kk], d_v + 128 * kk, 1);
      hp::mma_rs(y, pl[kk], d_v + 128 * kk, 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(S);
    hp::fence_regs(y);
    hp::fence_regs(ph);
    hp::fence_regs(pl);

    // 3. every warp's products have read S_{c-1}'s tiles and this stage's
    // r_dec and k_over: chunk c + 2's r, k, w into it, while S =
    // exp(cum[c-1]) S goes to its hi and lo tiles and y in bf16 to out's
    // tile (stored at the next chunk's start), which chunk c - 1's store
    // must have read
    if (tid == 0) hp::tma_store_wait_read();
    hp::bar_sync(kBarMma, kMmaThreads);
    if (tid == 0 && c + 2 < K) load_rkw(c + 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      S[4 * j] *= p0;
      S[4 * j + 1] *= p0;
      S[4 * j + 2] *= p1;
      S[4 * j + 3] *= p1;
    }
    st_frag<true>(s_hi, s_lo, S);
    st_frag<false>(o_tile, 0, y);
    hp::fence_proxy_async();
  }
  hp::bar_sync(kBarMma, kMmaThreads);
  if (tid == 0) {
    hp::tma_store_4d(&tm_out, o_tile, 0, h, 64 * (K - 1), b);
    hp::tma_store_commit();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(state_out + bh * 4096 +
                                 (r0 + g + 8 * hh) * 64 + 8 * j + 2 * t) =
          make_float2(S[4 * j + 2 * hh], S[4 * j + 2 * hh + 1]);
  if (tid == 0) hp::tma_store_wait_read();
}

int set_smem_wg() {
  return static_cast<int>(cudaFuncSetAttribute(
      wkv_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmem)));
}

int launch_wg(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* state0, void* out,
              float* state_out, int B, int T_len, int H,
              cudaStream_t stream) {
  const int err = set_smem_wg();
  if (err != 0) return err;
  CUtensorMap tm_r, tm_k, tm_v, tm_w, tm_out;
  if (!hp::encode_bshd(&tm_r, r, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_k, k, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_v, v, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_w, w, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_out, out, B, T_len, H, 64, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wkv_wg_kernel<<<dim3(H, B), kWgThreads, kWgSmem, stream>>>(
      tm_r, tm_k, tm_v, tm_w, tm_out, u, state0, state_out, T_len, H);
  return static_cast<int>(cudaGetLastError());
}

// Whether the wgmma route takes the shape: N = chunk = 64, any number of
// chunks, and r, k, v, w, out a TMA map can describe (16-byte aligned).
bool wg_ok(const void* r, const void* k, const void* v, const void* w,
           const void* out, int T_len, int N, int chunk) {
  return chunk == 64 && N == 64 && T_len % 64 == 0 && T_len >= 64 &&
         tc::aligned16(r) && tc::aligned16(k) && tc::aligned16(v) &&
         tc::aligned16(w) && tc::aligned16(out);
}

// Dispatch on N padded to 16, 32 or 64.
template <typename Fn>
int with_dim(int N, Fn&& fn) {
  if (N <= 16) return fn(std::integral_constant<int, 16>{});
  if (N <= 32) return fn(std::integral_constant<int, 32>{});
  if (N <= 64) return fn(std::integral_constant<int, 64>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r, k, v, w, out: (B, T, H, N), f32 (dtype 0: the CUDA cores) or bf16
// (dtype 1: the mma.sync route; dtype 2: the wgmma route, which wg_ok must
// take); u: (H, N) f32; state0, state_out: (B, H, N, N) f32; all
// contiguous. `chunk` divides T. Launches on `stream` and returns
// cudaGetLastError() (0 on success). The caller checks shapes, types and
// contiguity.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* w, const float* u,
                                const float* state0, void* out,
                                float* state_out, int B, int T_len, int H,
                                int N, int chunk, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (N < 1 || N > kMaxN || chunk < 1 || chunk > kMaxChunk ||
      T_len % chunk != 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(r, k, v, w, u, state0, out, state_out, B, T_len, H,
                         N, chunk, st);
  }
  if (dtype == 1) {
    return with_dim(N, [&](auto d) {
      return launch_tc<decltype(d)::value>(r, k, v, w, u, state0, out,
                                           state_out, B, T_len, H, N, chunk,
                                           st);
    });
  }
  if (dtype == 2) {
    if (!wg_ok(r, k, v, w, out, T_len, N, chunk)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_wg(r, k, v, w, u, state0, out, state_out, B, T_len, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The compiled kernel of the route that `dtype` takes at head size N and
// `chunk` (dtype 2: the wgmma kernel, N = chunk = 64): info[0..5] as
// tc::kernel_info gives them (registers, static and dynamic shared memory,
// spill bytes, blocks an SM, threads a block). Returns a CUDA error code (0
// on success).
extern "C" int rwkv6_wkv_info(int N, int chunk, int dtype, int* info) {
  if (N < 1 || N > kMaxN || chunk < 1 || chunk > kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    const size_t smem = f32_smem_bytes(N, chunk);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return tc::kernel_info(wkv_kernel<float>, kThreads, smem, info);
  }
  if (dtype == 1) {
    return with_dim(N, [&](auto d) {
      return info_tc<decltype(d)::value>(info);
    });
  }
  if (dtype == 2) {
    if (N != 64 || chunk != 64) return static_cast<int>(cudaErrorInvalidValue);
    const int err = set_smem_wg();
    if (err != 0) return err;
    return tc::kernel_info(wkv_wg_kernel, kWgThreads, kWgSmem, info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
