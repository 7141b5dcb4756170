// Backward of the RWKV-6 WKV chunked recurrence for Hopper (sm_90a).
//
// The JAX package trains through jax.grad of its chunked reference
// models/rwkv6.py::wkv_chunked (the Pallas forward kernels/rwkv6_wkv.py::
// wkv has no backward kernel); this computes that gradient. Per (batch b,
// head h), a chunk of c steps with start state S (N x N, keyed [key
// channel n, value channel m]) computes, as the forward does,
//
//   logw = log(max(w, 1e-8));  raw = inclusive_cumsum(logw);  cum = max(raw, -30)
//   r_dec = r exp(cum - logw)   k_over = k exp(-cum)   k_scaled = k exp(cum_L - cum)
//   out_t = r_dec_t . S + sum_{s<t} (r_dec_t . k_over_s) v_s + (sum_n r u k)_t v_t
//   S'    = exp(cum_L) o S + sum_s k_scaled_s v_s^T
//
// and its gradient, given dout and the end state's gradient dS', is
//
//   dr_dec_t    = S dout_t + sum_{s<t} (dout_t . v_s) k_over_s
//   dk_over_s   = sum_{t>s} (dout_t . v_s) r_dec_t,   dk_scaled_s = dS' v_s
//   dv_s        = sum_{t>s} scores[t, s] dout_t + diag_s dout_s + dS'^T k_scaled_s
//   dr_t        = dr_dec_t exp(cum_t - logw_t) + (dout_t . v_t) u k_t
//   dk_s        = dk_over_s exp(-cum_s) + dk_scaled_s exp(cum_L - cum_s) + (dout_s . v_s) u r_s
//   du          = sum_t (dout_t . v_t) r_t k_t
//   dcum_t      = dr_dec_t r_dec_t - dk_over_t k_over_t - dk_scaled_t k_scaled_t
//                 [+ sum_s dk_scaled_s k_scaled_s + exp(cum_L) sum_m S o dS' at t = L]
//   dlogw_t     = -dr_dec_t r_dec_t + sum_{j>=t, raw_j >= -30} dcum_j
//   dw_t        = dlogw_t / w_t where w_t >= 1e-8, else 0
//   dS          = exp(cum_L) o dS' + sum_t r_dec_t dout_t^T   (to the chunk before)
//
// (products of the elementwise factors, as the forward takes them: no
// exp(-cum) meets exp(cum) in one factor, and exp(-cum) <= e^30 keeps every
// product in f32 range). The plain version, rwkv6_wkv.py::
// rwkv6_wkv_bwd_plain, writes the same equations in PyTorch; the CPU tests
// hold it to autograd and to jax.grad, also where cum reaches the clamp and
// where w < 1e-8.
//
// Bound: at (B, T, H, N) = (4, 512, 40, 64) with bf16 r, k, v, w, dout, dr,
// dk, dv, dw and f32 u, du, states, the function must read r, k, v, w,
// dout (10.5 MB each) and write dr, dk, dv, dw: about 100 MB with the f32
// states and u, 30 us at 3.35 TB/s. Its work is about 6.7 GFLOP (per
// chunk and head ten c x c x N or c x N x N products, the states
// recomputed among them): 7 us on the bf16 tensor cores, 0.1 ms in f32 on
// the CUDA cores.
//
// Design (the first, simple one; a tensor-core route is later work): one
// block of 512 threads per (b, h), f32 arithmetic on the CUDA cores for
// both input types, one rounding of each gradient to its input's type at
// the end (no bf16 operand rounding, which misses the JAX tolerance for
// WKV: tests/test_torch_tensor_core_rounding.py). The block walks the
// chunks forward and writes the state at each chunk's start to a workspace
// (B x H x chunks x N x N f32, 21 MB at the train shape), then walks them
// backward with dS in shared memory. Per chunk: r, k, v, w, dout staged as
// f32 (odd pitches); one thread a channel runs the cumsum; the factors
// r_dec, k_over, k_scaled in parallel; the strictly lower scores and
// dout.v^T; then dr, dk, dv (written out) and dcum, a thread a channel
// walking it back (the -30 mask) into dlogw; then dw and the carried dS. du
// sums over batches without atomics: per-batch partials to a workspace, a
// second kernel sums them in order, so a second call gives equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChunk = 64;
constexpr int kMaxN = 64;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// Floats of shared memory at chunk c: nine c x N1 tiles, S and dS (N x
// N1), scores and dscores (c x C1), and the vectors.
__host__ __device__ inline size_t smem_floats(int c, int N) {
  const size_t N1 = N + 1, C1 = c + 1;
  return 9 * c * N1 + 2 * N * N1 + 2 * c * C1 + 2 * static_cast<size_t>(c) +
         2 * static_cast<size_t>(N);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ state0,
               const T* __restrict__ dout, const float* __restrict__ dstate_T,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               T* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ dstate0, float* __restrict__ states,
               int T_len, int H, int N, int c) {
  extern __shared__ float smem[];
  const int N1 = N + 1, C1 = c + 1;
  float* rd = smem;             // c x N1: r_dec
  float* ko = rd + c * N1;      // c x N1: k_over
  float* ks = ko + c * N1;      // c x N1: k_scaled
  float* vs = ks + c * N1;      // c x N1: v
  float* dos = vs + c * N1;     // c x N1: dout
  float* raw = dos + c * N1;    // c x N1: the cumsum before its clamp
  float* lw = raw + c * N1;     // c x N1: logw, then -dr_dec r_dec
  float* dcm = lw + c * N1;     // c x N1: dcum, then its masked reverse sum
  float* ee = dcm + c * N1;     // c x N1: dk_scaled k_scaled
  float* S = ee + c * N1;       // N x N1: the state at the chunk's start
  float* dS = S + N * N1;       // N x N1: the gradient of its end state
  float* sc = dS + N * N1;      // c x C1: strictly lower scores
  float* dsc = sc + c * C1;     // c x C1: dout_t . v_s, s < t
  float* diag = dsc + c * C1;   // c: sum_n r u k
  float* ddiag = diag + c;      // c: dout_t . v_t
  float* plast = ddiag + c;     // N: exp(cum_L)
  float* ssd = plast + N;       // N: sum_m S o dS'

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_chunks = T_len / c;
  const size_t NN = static_cast<size_t>(N) * N;
  const size_t state_base = (static_cast<size_t>(b) * H + h) * NN;
  float* my_states = states + (static_cast<size_t>(b) * H + h) * n_chunks * NN;

  // the chunk's cumsum (one thread a channel) and exp(cum_L)
  auto cumsum = [&]() {
    if (tid < N) {
      float acc = 0.0f;
      for (int t = 0; t < c; ++t) {
        acc += lw[t * N1 + tid];
        raw[t * N1 + tid] = acc;
      }
      plast[tid] = expf(fmaxf(acc, -30.0f));
    }
  };

  // ---- forward: the state at each chunk's start -------------------------
  for (int i = tid; i < N * N; i += kThreads) {
    const int n = i / N;
    S[n * N1 + (i - n * N)] = state0[state_base + i];
  }
  for (int j = 0; j < n_chunks; ++j) {
    __syncthreads();   // the previous update is done
    const size_t step0 = static_cast<size_t>(b) * T_len + j * c;
    for (int i = tid; i < N * N; i += kThreads) {
      const int n = i / N;
      my_states[j * NN + i] = S[n * N1 + (i - n * N)];
    }
    if (j == n_chunks - 1) break;   // the last end state is not needed
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const size_t off = ((step0 + t) * H + h) * N + n;
      ks[t * N1 + n] = ld(k + off);
      vs[t * N1 + n] = ld(v + off);
      lw[t * N1 + n] = logf(fmaxf(ld(w + off), 1e-8f));
    }
    __syncthreads();
    cumsum();
    __syncthreads();
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const float cm_last = fmaxf(raw[(c - 1) * N1 + n], -30.0f);
      ks[t * N1 + n] *= expf(cm_last - fmaxf(raw[t * N1 + n], -30.0f));
    }
    __syncthreads();
    for (int i = tid; i < N * N; i += kThreads) {
      const int n = i / N;
      const int m = i - n * N;
      float acc = 0.0f;
      for (int s = 0; s < c; ++s) acc = fmaf(ks[s * N1 + n], vs[s * N1 + m], acc);
      S[n * N1 + m] = S[n * N1 + m] * plast[n] + acc;
    }
  }

  // ---- backward, chunk by chunk from the last -------------------------------
  __syncthreads();
  for (int i = tid; i < N * N; i += kThreads) {
    const int n = i / N;
    dS[n * N1 + (i - n * N)] = dstate_T ? dstate_T[state_base + i] : 0.0f;
  }
  float du_acc = 0.0f;   // thread n's, n < N
  for (int j = n_chunks - 1; j >= 0; --j) {
    __syncthreads();   // the previous chunk's dS update is done
    const size_t step0 = static_cast<size_t>(b) * T_len + j * c;
    for (int i = tid; i < N * N; i += kThreads) {
      const int n = i / N;
      S[n * N1 + (i - n * N)] = my_states[j * NN + i];
    }
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const size_t off = ((step0 + t) * H + h) * N + n;
      const float kv = ld(k + off);
      rd[t * N1 + n] = ld(r + off);
      ko[t * N1 + n] = kv;
      ks[t * N1 + n] = kv;
      vs[t * N1 + n] = ld(v + off);
      dos[t * N1 + n] = ld(dout + off);
      lw[t * N1 + n] = logf(fmaxf(ld(w + off), 1e-8f));
    }
    __syncthreads();
    cumsum();
    __syncthreads();
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const float cm = fmaxf(raw[t * N1 + n], -30.0f);
      const float cm_last = fmaxf(raw[(c - 1) * N1 + n], -30.0f);
      rd[t * N1 + n] *= expf(cm - lw[t * N1 + n]);
      ko[t * N1 + n] *= expf(-cm);
      ks[t * N1 + n] *= expf(cm_last - cm);
    }
    __syncthreads();
    // scores, dout.v^T (strictly lower), the bonus, dout_t.v_t, S o dS'
    for (int i = tid; i < c * c; i += kThreads) {
      const int t = i / c;
      const int s = i - t * c;
      float a = 0.0f, d = 0.0f;
      if (s < t) {
        for (int n = 0; n < N; ++n) {
          a = fmaf(rd[t * N1 + n], ko[s * N1 + n], a);
          d = fmaf(dos[t * N1 + n], vs[s * N1 + n], d);
        }
      }
      sc[t * C1 + s] = a;
      dsc[t * C1 + s] = d;
    }
    for (int t = tid; t < c; t += kThreads) {
      float a = 0.0f, d = 0.0f;
      for (int n = 0; n < N; ++n) {
        const size_t off = ((step0 + t) * H + h) * N + n;
        a = fmaf(ld(r + off) * u[h * N + n], ld(k + off), a);
        d = fmaf(dos[t * N1 + n], vs[t * N1 + n], d);
      }
      diag[t] = a;
      ddiag[t] = d;
    }
    for (int n = tid; n < N; n += kThreads) {
      float a = 0.0f;
      for (int m = 0; m < N; ++m) a = fmaf(S[n * N1 + m], dS[n * N1 + m], a);
      ssd[n] = a;
    }
    __syncthreads();
    // dr, dk (out), the exponents' gradients; dv (out)
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      float drd = 0.0f, dko = 0.0f, dks = 0.0f;
      for (int m = 0; m < N; ++m) {
        drd = fmaf(S[n * N1 + m], dos[t * N1 + m], drd);
        dks = fmaf(dS[n * N1 + m], vs[t * N1 + m], dks);
      }
      for (int s = 0; s < t; ++s) drd = fmaf(dsc[t * C1 + s], ko[s * N1 + n], drd);
      for (int q = t + 1; q < c; ++q) dko = fmaf(dsc[q * C1 + t], rd[q * N1 + n], dko);
      const size_t off = ((step0 + t) * H + h) * N + n;
      const float cm = fmaxf(raw[t * N1 + n], -30.0f);
      const float cm_last = fmaxf(raw[(c - 1) * N1 + n], -30.0f);
      const float bonus = ddiag[t] * u[h * N + n];
      st(dr + off, drd * expf(cm - lw[t * N1 + n]) + bonus * ld(k + off));
      st(dk + off, dko * expf(-cm) + dks * expf(cm_last - cm) +
                       bonus * ld(r + off));
      const float e = dks * ks[t * N1 + n];
      const float f = drd * rd[t * N1 + n];
      ee[t * N1 + n] = e;
      dcm[t * N1 + n] = f - dko * ko[t * N1 + n] - e;
      lw[t * N1 + n] = -f;
    }
    for (int i = tid; i < c * N; i += kThreads) {
      const int s = i / N;
      const int m = i - s * N;
      float acc = diag[s] * dos[s * N1 + m];
      for (int t = s + 1; t < c; ++t) acc = fmaf(sc[t * C1 + s], dos[t * N1 + m], acc);
      for (int n = 0; n < N; ++n) acc = fmaf(ks[s * N1 + n], dS[n * N1 + m], acc);
      st(dv + ((step0 + s) * H + h) * N + m, acc);
    }
    __syncthreads();
    // dcum's reverse sum into dlogw (no gradient past the -30 clamp); du
    if (tid < N) {
      const int n = tid;
      float tail = plast[n] * ssd[n];
      for (int t = 0; t < c; ++t) tail += ee[t * N1 + n];
      float acc = 0.0f;
      for (int t = c - 1; t >= 0; --t) {
        const float d = dcm[t * N1 + n] + (t == c - 1 ? tail : 0.0f);
        if (raw[t * N1 + n] >= -30.0f) acc += d;
        dcm[t * N1 + n] = acc;
      }
      for (int t = 0; t < c; ++t) {
        const size_t off = ((step0 + t) * H + h) * N + n;
        du_acc = fmaf(ddiag[t], ld(r + off) * ld(k + off), du_acc);
      }
    }
    __syncthreads();
    // dw (out), and dS = exp(cum_L) o dS' + sum_t r_dec_t dout_t^T
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const size_t off = ((step0 + t) * H + h) * N + n;
      const float wv = ld(w + off);
      const float dlogw = lw[t * N1 + n] + dcm[t * N1 + n];
      st(dw + off, wv >= 1e-8f ? dlogw / fmaxf(wv, 1e-8f) : 0.0f);
    }
    for (int i = tid; i < N * N; i += kThreads) {
      const int n = i / N;
      const int m = i - n * N;
      float acc = 0.0f;
      for (int t = 0; t < c; ++t) acc = fmaf(rd[t * N1 + n], dos[t * N1 + m], acc);
      dS[n * N1 + m] = dS[n * N1 + m] * plast[n] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * N; i += kThreads) {
    const int n = i / N;
    dstate0[state_base + i] = dS[n * N1 + (i - n * N)];
  }
  if (tid < N) du_part[(static_cast<size_t>(b) * H + h) * N + tid] = du_acc;
}

// du = the per-batch partials summed in batch order.
__global__ void wkv_bwd_reduce_kernel(const float* __restrict__ du_part,
                                      float* __restrict__ du, int B, int HN) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < HN;
       i += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += du_part[static_cast<size_t>(b) * HN + i];
    du[i] = s;
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, const void* dout,
           const float* dstate_T, void* dr, void* dk, void* dv, void* dw,
           float* du, float* dstate0, float* states, float* du_part, int B,
           int T_len, int H, int N, int c, cudaStream_t stream) {
  const size_t smem = smem_floats(c, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state0,
      static_cast<const T*>(dout), dstate_T, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dw), du_part,
      dstate0, states, T_len, H, N, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HN = H * N;
  wkv_bwd_reduce_kernel<<<(HN + 255) / 256, 256, 0, stream>>>(du_part, du, B,
                                                              HN);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int T_len, int N, int chunk) {
  return N >= 1 && N <= kMaxN && chunk >= 1 && chunk <= kMaxChunk &&
         T_len >= 1 && T_len % chunk == 0;
}

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw: (B, T, H, N), f32 (dtype 0) or bf16
// (dtype 1); u, du: (H, N) f32; state0, dstate_T, dstate0: (B, H, N, N)
// f32 (dstate_T may be null: zeros). Workspaces, f32: states (B * H *
// T/chunk * N * N), du_part (B, H, N). All contiguous; `chunk` divides T
// (at N <= 64 and chunks <= 64 the shared memory, at most 217,344 bytes,
// fits). Launches the scan and du's sum on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int rwkv6_wkv_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const float* u, const float* state0, const void* dout,
    const float* dstate_T, void* dr, void* dk, void* dv, void* dw, float* du,
    float* dstate0, float* states, float* du_part, int B, int T_len, int H,
    int N, int chunk, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (!valid(T_len, N, chunk) || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(r, k, v, w, u, state0, dout, dstate_T, dr, dk, dv,
                         dw, du, dstate0, states, du_part, B, T_len, H, N,
                         chunk, st);
  }
  if (dtype == 1) {
    return launch<bf16>(r, k, v, w, u, state0, dout, dstate_T, dr, dk, dv, dw,
                        du, dstate0, states, du_part, B, T_len, H, N, chunk,
                        st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The compiled scan kernel for `dtype` at (N, chunk): info[0..5] as
// tc::kernel_info gives them (registers, static and dynamic shared memory,
// spill bytes, blocks an SM, threads a block). Returns a CUDA error code.
extern "C" int rwkv6_wkv_bwd_info(int N, int chunk, int dtype, int* info) {
  if (N < 1 || N > kMaxN || chunk < 1 || chunk > kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_floats(chunk, N) * sizeof(float);
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return tc::kernel_info(wkv_bwd_kernel<float>, kThreads, smem, info);
  }
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return tc::kernel_info(wkv_bwd_kernel<bf16>, kThreads, smem, info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
