// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// The JAX package trains through jax.grad of its chunked reference
// models/mamba2.py::ssd_chunked (the Pallas forward kernels/mamba2_ssd.py::
// ssd has no backward kernel); this computes that gradient. Per (batch b,
// head h), with a_t = dt_t A_h, cum_t its inclusive sum over the chunk,
// D[t, s] = exp(cum_t - cum_s) for s <= t, M[t, s] = (C_t . B_s) D[t, s]
// dt_s and w_s = exp(cum_L - cum_s) dt_s, a chunk with start state S maps
//
//   y_t = exp(cum_t) C_t . S + sum_{s<=t} M[t, s] x_s
//   S'  = exp(cum_L) S + sum_s w_s B_s x_s^T
//
// and its gradient, given dy and the end state's gradient dS', is
//
//   dx_s  = sum_t M[t, s] dy_t + w_s dS'^T B_s
//   dB_s  = sum_t dG[t, s] C_t + w_s dS' x_s,   dG[t, s] = (dy_t . x_s) D[t, s] dt_s
//   dC_t  = sum_s dG[t, s] B_s + exp(cum_t) S dy_t
//   ddt_s = sum_t (dy_t . x_s)(C_t . B_s) D[t, s] + exp(cum_L - cum_s) B_s^T dS' x_s
//           + A dloga_s,   dA = sum dt_s dloga_s
//   dS    = exp(cum_L) dS' + sum_t exp(cum_t) C_t dy_t^T   (to the chunk before)
//
// where dloga_j sums the gradient times the value of every exponent whose
// cum difference spans a_j:
//
//   dloga_j = sum_{s<j<=t} Q[t, s] + sum_{t>=j} exp(cum_t) C_t . S dy_t
//             + sum_{s<j} dW_s w_s + exp(cum_L) sum S o dS'
//
// with Q[t, s] = (dy_t . x_s) M[t, s] where cum_t - cum_s <= 0 (the forward
// clamps the difference at 0; with A < 0 and dt > 0 it never passes 0)
// and dW_s = B_s^T dS' x_s. (The reverse cumsum of per-step totals gives
// the same dloga, but its row and column sums of Q cancel: in f32 it
// misses the JAX gradient tolerance on dA at the train shape.) The plain
// version, mamba2_ssd.py::mamba2_ssd_bwd_plain, writes the same equations
// in PyTorch; the CPU tests hold it to autograd and to jax.grad.
//
// Bound: at (B, T, H, P, G, N) = (4, 512, 112, 64, 1, 64) with bf16 x, B,
// C, dy, dx, dB, dC and f32 dt, ddt, states, the function must read x, dy
// (29.4 MB each), B, C, dt, state0 and write dx (29.4 MB), dB, dC, ddt,
// dstate0: about 106 MB, 32 us at 3.35 TB/s. Its work is about 19 GFLOP
// (per chunk and head ten c x c x 64 or c x 64 x 64 products, the states
// recomputed among them): 19 us on the bf16 tensor cores, 0.28 ms in f32
// on the CUDA cores.
//
// Design (the first, simple one; a tensor-core route is later work): one
// block of 512 threads per (b, h), f32 arithmetic on the CUDA cores for
// both input types, one rounding of each gradient to its input's type at
// the end (so the bf16 route adds no operand rounding). The block first
// walks the chunks forward and writes the state at each chunk's start to
// a workspace (B x H x chunks x N x P f32, 58.7 MB at the train shape),
// then walks them backward with dS in shared memory: per chunk it stages x,
// dy, B, C, S as f32 (odd pitches), builds C.B^T and dy.x^T for s <= t and
// Q from them, sums Q's rows as prefixes and then its columns into the
// spanned sums, scales C.B^T and dy.x^T in place into M and dG, and writes
// dx and the per-head dB and dC; one thread then walks the chunk's
// vectors into dloga, ddt and dA. Sums over blocks use no atomics: the per-head dB
// and dC (B x T x H x N f32 each) and the per-batch dA partials go to
// workspaces, and a second kernel sums them in a fixed order (over the
// heads of a group, over batches), so a second call gives equal bits. The
// chunk is the forward's (the largest c <= 64 that divides T) unless the
// shared memory does not hold it (N and P near 128): then the largest
// divisor of T below it that fits, which gives the same gradient up to
// rounding (mamba2_ssd_bwd_chunk tells the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChunk = 64;
constexpr int kMaxDim = 128;   // N and P

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// Floats of shared memory at chunk c: x, dy (c x P1), B, C (c x N1), S and
// dS (N x P1), three c x C1 matrices, C.S-side and dS-side (c x N1)
// products, and the chunk's vectors.
__host__ __device__ inline size_t smem_floats(int c, int N, int P) {
  const size_t P1 = P + 1, N1 = N + 1, C1 = c + 1;
  return 2 * c * P1 + 2 * c * N1 + 2 * N * P1 + 3 * c * C1 + 2 * c * N1 +
         8 * static_cast<size_t>(c) + kThreads;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ state0,
               const T* __restrict__ dy, const float* __restrict__ dstate_T,
               T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dBh, float* __restrict__ dCh,
               float* __restrict__ dA_part, float* __restrict__ dstate0,
               float* __restrict__ states, int T_len, int H, int P, int G,
               int N, int c) {
  extern __shared__ float smem[];
  const int P1 = P + 1, N1 = N + 1, C1 = c + 1;
  float* xs = smem;             // c x P1
  float* dys = xs + c * P1;     // c x P1
  float* bs = dys + c * P1;     // c x N1
  float* cs = bs + c * N1;      // c x N1
  float* S = cs + c * N1;       // N x P1: the state at the chunk's start
  float* dS = S + N * P1;       // N x P1: the gradient of its end state
  float* a1 = dS + N * P1;      // c x C1: C.B^T, then M
  float* a2 = a1 + c * C1;      // c x C1: dy.x^T, then dG
  float* sdy = a2 + c * C1;     // c x N1: S dy_t
  float* sdx = sdy + c * N1;    // c x N1: dS' x_s
  float* dts = sdx + c * N1;    // c
  float* cum = dts + c;         // c
  float* ecum = cum + c;        // exp(cum_t)
  float* dec = ecum + c;        // exp(cum_L - cum_s)
  float* inter = dec + c;       // exp(cum_t) C_t . S dy_t
  float* spanq = inter + c;     // sum of Q[t, s] over s < j <= t
  float* cole = spanq + c;      // sum_t (dy_t.x_s)(C_t.B_s) D[t, s]
  float* dws = cole + c;        // dW_s
  float* part = dws + c;        // kThreads: partial sums of S o dS'
  float* a3 = part + kThreads;  // c x C1: Q, then its row prefix sums

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h];
  const int n_chunks = T_len / c;
  const size_t NP = static_cast<size_t>(N) * P;
  const size_t state_base = (static_cast<size_t>(b) * H + h) * NP;
  float* my_states = states + (static_cast<size_t>(b) * H + h) * n_chunks * NP;

  // ---- forward: the state at each chunk's start -------------------------
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P;
    S[n * P1 + (i - n * P)] = state0[state_base + i];
  }
  for (int k = 0; k < n_chunks; ++k) {
    __syncthreads();   // the previous update is done
    const size_t step0 = static_cast<size_t>(b) * T_len + k * c;
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P;
      my_states[k * NP + i] = S[n * P1 + (i - n * P)];
    }
    if (k == n_chunks - 1) break;   // the last end state is not needed
    for (int i = tid; i < c * P; i += kThreads) {
      const int s = i / P;
      const int p = i - s * P;
      xs[s * P1 + p] = ld(x + ((step0 + s) * H + h) * P + p);
    }
    for (int i = tid; i < c * N; i += kThreads) {
      const int s = i / N;
      const int n = i - s * N;
      bs[s * N1 + n] = ld(Bm + ((step0 + s) * G + g) * N + n);
    }
    if (tid < c) dts[tid] = dt[(step0 + tid) * H + h];
    __syncthreads();
    if (tid < c) {
      float acc = 0.0f;
      for (int s = 0; s <= tid; ++s) acc += dts[s] * a;
      cum[tid] = acc;
    }
    __syncthreads();
    if (tid < c) dec[tid] = expf(cum[c - 1] - cum[tid]) * dts[tid];
    __syncthreads();
    const float last = expf(cum[c - 1]);
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P;
      const int p = i - n * P;
      float acc = 0.0f;
      for (int s = 0; s < c; ++s) acc = fmaf(bs[s * N1 + n] * dec[s], xs[s * P1 + p], acc);
      S[n * P1 + p] = S[n * P1 + p] * last + acc;
    }
  }

  // ---- backward, chunk by chunk from the last -------------------------------
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P;
    dS[n * P1 + (i - n * P)] = dstate_T ? dstate_T[state_base + i] : 0.0f;
  }
  float dA_acc = 0.0f;   // thread 0's
  for (int k = n_chunks - 1; k >= 0; --k) {
    __syncthreads();   // the previous chunk's dS update is done
    const size_t step0 = static_cast<size_t>(b) * T_len + k * c;
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P;
      S[n * P1 + (i - n * P)] = my_states[k * NP + i];
    }
    for (int i = tid; i < c * P; i += kThreads) {
      const int s = i / P;
      const int p = i - s * P;
      const size_t off = ((step0 + s) * H + h) * P + p;
      xs[s * P1 + p] = ld(x + off);
      dys[s * P1 + p] = ld(dy + off);
    }
    for (int i = tid; i < c * N; i += kThreads) {
      const int s = i / N;
      const int n = i - s * N;
      const size_t off = ((step0 + s) * G + g) * N + n;
      bs[s * N1 + n] = ld(Bm + off);
      cs[s * N1 + n] = ld(Cm + off);
    }
    if (tid < c) dts[tid] = dt[(step0 + tid) * H + h];
    __syncthreads();
    if (tid < c) {
      float acc = 0.0f;
      for (int s = 0; s <= tid; ++s) acc += dts[s] * a;
      cum[tid] = acc;
    }
    __syncthreads();
    if (tid < c) {
      ecum[tid] = expf(cum[tid]);
      dec[tid] = expf(cum[c - 1] - cum[tid]);
    }
    // C.B^T and dy.x^T at s <= t (zero above), S dy_t and dS' x_s
    for (int i = tid; i < c * c; i += kThreads) {
      const int t = i / c;
      const int s = i - t * c;
      float gts = 0.0f, mts = 0.0f;
      if (s <= t) {
        for (int n = 0; n < N; ++n) gts = fmaf(cs[t * N1 + n], bs[s * N1 + n], gts);
        for (int p = 0; p < P; ++p) mts = fmaf(dys[t * P1 + p], xs[s * P1 + p], mts);
      }
      a1[t * C1 + s] = gts;
      a2[t * C1 + s] = mts;
    }
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      float acc_y = 0.0f, acc_x = 0.0f;
      for (int p = 0; p < P; ++p) {
        acc_y = fmaf(S[n * P1 + p], dys[t * P1 + p], acc_y);
        acc_x = fmaf(dS[n * P1 + p], xs[t * P1 + p], acc_x);
      }
      sdy[t * N1 + n] = acc_y;
      sdx[t * N1 + n] = acc_x;
    }
    __syncthreads();
    // Q[t, s] (s < t, where the clamp passes it), the readout's exponent
    // gradient, the column sums for ddt, dW_s, and partial sums of S o dS'
    for (int i = tid; i < c * c; i += kThreads) {
      const int t = i / c;
      const int s = i - t * c;
      const float diff = cum[t] - cum[s];
      a3[t * C1 + s] = (s < t && diff <= 0.0f)
                           ? a2[t * C1 + s] * a1[t * C1 + s] * expf(diff) * dts[s]
                           : 0.0f;
    }
    if (tid < c) {
      const int t = tid;
      float acc = 0.0f;
      for (int n = 0; n < N; ++n) acc = fmaf(cs[t * N1 + n], sdy[t * N1 + n], acc);
      inter[t] = ecum[t] * acc;
    } else if (tid < 2 * c) {
      const int s = tid - c;
      float e = 0.0f;
      for (int t = s; t < c; ++t) {
        e += a2[t * C1 + s] * a1[t * C1 + s] * expf(fminf(cum[t] - cum[s], 0.0f));
      }
      cole[s] = e;
    } else if (tid < 3 * c) {
      const int s = tid - 2 * c;
      float acc = 0.0f;
      for (int n = 0; n < N; ++n) acc = fmaf(bs[s * N1 + n], sdx[s * N1 + n], acc);
      dws[s] = acc;
    }
    {
      float acc = 0.0f;
      for (int i = tid; i < N * P; i += kThreads) {
        const int n = i / P;
        const int j = n * P1 + (i - n * P);
        acc = fmaf(S[j], dS[j], acc);
      }
      part[tid] = acc;
    }
    __syncthreads();
    // each row of Q to its exclusive prefix sums, U[t, j] = sum_{s<j} Q[t, s];
    // M = (C.B) D dt_s and dG = (dy.x) D dt_s, in place
    if (tid < c) {
      float run = 0.0f;
      for (int s = 0; s < c; ++s) {
        const float q = a3[tid * C1 + s];
        a3[tid * C1 + s] = run;
        run += q;
      }
    }
    for (int i = tid; i < c * c; i += kThreads) {
      const int t = i / c;
      const int s = i - t * c;
      if (s <= t) {
        const float d = expf(fminf(cum[t] - cum[s], 0.0f)) * dts[s];
        a1[t * C1 + s] *= d;
        a2[t * C1 + s] *= d;
      }
    }
    __syncthreads();
    // sum_{t>=j} U[t, j]: the Q[t, s] whose exponent spans a_j; dx and the
    // per-head dB and dC
    if (tid < c) {
      float acc = 0.0f;
      for (int t = tid; t < c; ++t) acc += a3[t * C1 + tid];
      spanq[tid] = acc;
    }
    for (int i = tid; i < c * P; i += kThreads) {
      const int s = i / P;
      const int p = i - s * P;
      float acc = 0.0f;
      for (int t = s; t < c; ++t) acc = fmaf(a1[t * C1 + s], dys[t * P1 + p], acc);
      float st_acc = 0.0f;
      for (int n = 0; n < N; ++n) st_acc = fmaf(bs[s * N1 + n], dS[n * P1 + p], st_acc);
      st(dx + ((step0 + s) * H + h) * P + p, acc + dec[s] * dts[s] * st_acc);
    }
    for (int i = tid; i < c * N; i += kThreads) {
      const int s = i / N;
      const int n = i - s * N;
      float acc_b = 0.0f, acc_c = 0.0f;
      for (int t = s; t < c; ++t) acc_b = fmaf(a2[t * C1 + s], cs[t * N1 + n], acc_b);
      for (int u = 0; u <= s; ++u) acc_c = fmaf(a2[s * C1 + u], bs[u * N1 + n], acc_c);
      const size_t off = ((step0 + s) * H + h) * N + n;
      dBh[off] = acc_b + dec[s] * dts[s] * sdx[s * N1 + n];
      dCh[off] = acc_c + ecum[s] * sdy[s * N1 + n];
    }
    __syncthreads();   // every read of dS' is done
    // thread 0: dloga_j = the spanned Q, the readouts at t >= j, w_s's
    // exponent at s < j and exp(cum_L)'s; then ddt and dA
    if (tid == 0) {
      float ssd = 0.0f;
      for (int i = 0; i < kThreads; ++i) ssd += part[i];
      const float tail = ecum[c - 1] * ssd;
      float pre_r = 0.0f;
      for (int t = 0; t < c; ++t) {
        spanq[t] += pre_r + tail;
        pre_r += dws[t] * dec[t] * dts[t];
      }
      float suf = 0.0f;
      for (int t = c - 1; t >= 0; --t) {
        suf += inter[t];
        const float dloga = spanq[t] + suf;
        ddt[(step0 + t) * H + h] = cole[t] + dec[t] * dws[t] + a * dloga;
        dA_acc = fmaf(dts[t], dloga, dA_acc);
      }
    }
    const float last = ecum[c - 1];
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P;
      const int p = i - n * P;
      float acc = 0.0f;
      for (int t = 0; t < c; ++t) acc = fmaf(cs[t * N1 + n] * ecum[t], dys[t * P1 + p], acc);
      dS[n * P1 + p] = dS[n * P1 + p] * last + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P;
    dstate0[state_base + i] = dS[n * P1 + (i - n * P)];
  }
  if (tid == 0) dA_part[static_cast<size_t>(b) * H + h] = dA_acc;
}

// The sums over blocks, in a fixed order: dBm and dCm over the heads of
// each group, dA over batches.
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dBh,
                                      const float* __restrict__ dCh,
                                      const float* __restrict__ dA_part,
                                      T* __restrict__ dBm, T* __restrict__ dCm,
                                      float* __restrict__ dA, int B,
                                      size_t rows, int H, int G, int N) {
  const int hpg = H / G;
  const size_t total = rows * G * N;   // rows = B * T
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t n = i % N;
    const size_t g = (i / N) % G;
    const size_t row = i / (static_cast<size_t>(N) * G);
    const size_t base = (row * H + g * hpg) * N + n;
    float sb = 0.0f, sc = 0.0f;
    for (int j = 0; j < hpg; ++j) {
      sb += dBh[base + static_cast<size_t>(j) * N];
      sc += dCh[base + static_cast<size_t>(j) * N];
    }
    st(dBm + i, sb);
    st(dCm + i, sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.0f;
      for (int b = 0; b < B; ++b) s += dA_part[static_cast<size_t>(b) * H + h];
      dA[h] = s;
    }
  }
}

int max_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

// The largest divisor of T_len that is <= chunk and whose shared memory
// fits; 0 if none does.
int fit_chunk(int T_len, int N, int P, int chunk) {
  const size_t limit = static_cast<size_t>(max_smem_bytes());
  for (int c = chunk < T_len ? chunk : T_len; c >= 1; --c) {
    if (T_len % c == 0 && smem_floats(c, N, P) * sizeof(float) <= limit) {
      return c;
    }
  }
  return 0;
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* state0, const void* dy,
           const float* dstate_T, void* dx, float* ddt, float* dA, void* dBm,
           void* dCm, float* dstate0, float* states, float* dBh, float* dCh,
           float* dA_part, int B, int T_len, int H, int P, int G, int N,
           int c, cudaStream_t stream) {
  const size_t smem = smem_floats(c, N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), state0, static_cast<const T*>(dy), dstate_T,
      static_cast<T*>(dx), ddt, dBh, dCh, dA_part, dstate0, states, T_len, H,
      P, G, N, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(B) * T_len;
  const size_t total = rows * G * N;
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  ssd_bwd_reduce_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                             stream>>>(dBh, dCh, dA_part, static_cast<T*>(dBm),
                                       static_cast<T*>(dCm), dA, B, rows, H, G,
                                       N);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int T_len, int H, int P, int G, int N, int chunk) {
  return P >= 1 && P <= kMaxDim && N >= 1 && N <= kMaxDim && G >= 1 &&
         H % G == 0 && chunk >= 1 && chunk <= kMaxChunk && T_len >= 1 &&
         T_len % chunk == 0;
}

}  // namespace

// The chunk the backward takes for the forward's `chunk`: the largest
// divisor of T_len <= chunk whose shared memory fits the card; 0 if none.
extern "C" int mamba2_ssd_bwd_chunk(int T_len, int N, int P, int chunk) {
  if (!valid(T_len, 1, P, 1, N, chunk)) return 0;
  return fit_chunk(T_len, N, P, chunk);
}

// x, dy, dx: (B, T, H, P); dt, ddt: (B, T, H) f32; A, dA: (H,) f32; Bm,
// Cm, dBm, dCm: (B, T, G, N); state0, dstate_T, dstate0: (B, H, N, P) f32
// (dstate_T may be null: zeros). Workspaces, f32: states (B * H * T/chunk
// * N * P), dBh and dCh (B, T, H, N), dA_part (B, H). x, dy, dx, Bm, Cm,
// dBm, dCm are f32 (dtype 0) or bf16 (dtype 1); all contiguous. `chunk`
// divides T and is one mamba2_ssd_bwd_chunk gave. Launches the scan and
// the reduction on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int mamba2_ssd_bwd_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* state0, const void* dy,
    const float* dstate_T, void* dx, float* ddt, float* dA, void* dBm,
    void* dCm, float* dstate0, float* states, float* dBh, float* dCh,
    float* dA_part, int B, int T_len, int H, int P, int G, int N, int chunk,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (!valid(T_len, H, P, G, N, chunk) || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, A, Bm, Cm, state0, dy, dstate_T, dx, ddt, dA,
                         dBm, dCm, dstate0, states, dBh, dCh, dA_part, B,
                         T_len, H, P, G, N, chunk, st);
  }
  if (dtype == 1) {
    return launch<bf16>(x, dt, A, Bm, Cm, state0, dy, dstate_T, dx, ddt, dA,
                        dBm, dCm, dstate0, states, dBh, dCh, dA_part, B,
                        T_len, H, P, G, N, chunk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The compiled scan kernel for `dtype` at (N, P, chunk): info[0..5] as
// tc::kernel_info gives them (registers, static and dynamic shared memory,
// spill bytes, blocks an SM, threads a block). Returns a CUDA error code.
extern "C" int mamba2_ssd_bwd_info(int N, int P, int chunk, int dtype,
                                   int* info) {
  if (P < 1 || P > kMaxDim || N < 1 || N > kMaxDim || chunk < 1 ||
      chunk > kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_floats(chunk, N, P) * sizeof(float);
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return tc::kernel_info(ssd_bwd_kernel<float>, kThreads, smem, info);
  }
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return tc::kernel_info(ssd_bwd_kernel<bf16>, kThreads, smem, info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
