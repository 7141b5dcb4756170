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
// chunks in a loop with its part of the state in shared memory.
//
// Bound: at (B, T, H, N) = (4, 512, 40, 64) with bf16 r, k, v, w and out,
// and f32 u and states, the function moves about 57.7 MB: about 17 us at
// 3.35 TB/s. Its work is about 2.7 GFLOP (four c x c x N or c x N x N
// products per chunk and head): 2.7 us on the bf16 tensor cores, 40 us in
// f32 on the CUDA cores. This kernel computes in f32 on the CUDA cores, so
// its bound is the f32 rate; register tiles of 4 x 4 (scores) and 4 x 2
// (readout, state) cut the shared-memory loads to one for every two FMAs
// in the scores and three for every four elsewhere. Tensor-core tiles are
// later work.
//
// Design: the value columns m of the state are independent (out[t, m] and
// S[:, m] read only column m of v), so the grid is (column tile of 32, h,
// b): 320 blocks at the serve shape instead of B * H = 160, which would be
// 1.2 blocks per SM. Each block recomputes the c x c scores, which need
// every key channel. 256 threads. Each chunk stages r, k, log w (c x N) and
// the block's 32 columns of v as f32 in shared memory (odd row pitches, so
// that column walks are free of bank conflicts). Then each warp takes every
// 8th key channel n and scans log w down its c rows with shuffles (a lane
// holds rows lane and lane + 32), so the cumsum is 5 shuffle steps, not a
// serial loop; the same lane turns r, k into r_dec, k_over and k_scaled in
// place and adds its r u k to a per-warp part of the diagonal. Then the
// scores, the readout and last the state update, each after a barrier. The
// kernel indexes (B, T, H, N) directly and needs none of the Pallas
// wrapper's (B*H, T, N) transposes. The chunk is the wrapper's: the largest
// c <= 64 that divides T; any c from 1 to 64 is right.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;
constexpr int kMaxN = 64;
constexpr int kTile = 32;           // value columns of the state per block
constexpr int kTile1 = kTile + 1;   // its row pitch in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, void* out, float* state_out,
           int B, int T_len, int H, int N, int c, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(N) * kTile1 + 3 * c * (N + 1) +
                       c * kTile1 + c * (c + 1) + kWarps * c + c + 2 * N);
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

}  // namespace

// r, k, v, w, out: (B, T, H, N), f32 (dtype 0) or bf16 (dtype 1); u: (H, N)
// f32; state0, state_out: (B, H, N, N) f32; all contiguous. `chunk`
// divides T. Launches on `stream` and returns cudaGetLastError() (0 on
// success). The caller checks shapes, types and contiguity.
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
    return launch<__nv_bfloat16>(r, k, v, w, u, state0, out, state_out, B,
                                 T_len, H, N, chunk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
