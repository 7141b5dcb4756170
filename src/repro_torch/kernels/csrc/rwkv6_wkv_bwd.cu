// Backward of the RWKV-6 WKV chunked recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through jax.grad of its
// chunked reference models/rwkv6.py::wkv_chunked (:85; the Pallas forward
// kernels/rwkv6_wkv.py::wkv has no backward kernel); this computes that
// gradient. Per (batch b, head h), a chunk of c steps with start state S
// (N x N, keyed [key channel n, value channel m]) computes, as the forward
// does,
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
// The dtype and shape pick the route (rwkv6_wkv.py::bwd_route, the
// launcher's dtype code), where the forward picks its own: f32 the CUDA
// cores (0); bf16 at N = chunk = 64 with r, k, v, w, dout 16-byte aligned
// (TMA maps describe them; any T a multiple of 64: rwkv6-3b's train path)
// the wgmma route (2); every other bf16 input the mma.sync route (1).
//
// bf16 wgmma route (wg::wkv_bwd_wg_kernel, then wkv_bwd_reduce_kernel):
// one block of three warpgroups a (b, h), the forward's shape: the
// products' warpgroup holds the state, then its gradient, in f32
// registers and runs every product on wgmma m64n64k16 (112 a chunk), each
// f32 operand split into bf16 hi + lo as below, but dscores . k_over and
// dscores^T . r_dec in three parts (six part products, about 24 bits): at
// the -30 clamp dlogw is a small sum of large dcum terms, over w near
// 0.05, and two parts (the mma.sync route's) take dw past the 1e-2 gate
// at rwkv6-3b's train shape; two pass warpgroups (setmaxnreg: 216 and 144
// registers) run the elementwise work, 8 rows a warp. Phase 1 walks the chunks forwards for their start states S_j
// (S_{j+1} = exp(cum_L) (S_j + k_over^T v), one product a chunk) and writes
// each once as its bf16 hi and lo tiles (16 KB) to a workspace: 21 MB at
// the train shape, written once and read once by a bulk copy, where the
// mma.sync route moves 84 MB of f32 S_j and dS'_j. Phase 2 walks them
// backwards with dS' in registers, never in device memory; the products
// hand dr_dec and dk_tot to the pass in f32 through shared memory, and
// the pass forms dr, dk, dw as each arrives while the products go on.
// Three identities keep the products few: exp(cum_L) dS' = D' (split
// once) turns dk_scaled exp(cum_L) and k_scaled . dS' into v . D'^T and
// k_over . D', so dk_over and dk_scaled share one sum (dk = dk_tot / e);
// the transposed scores and dscores come from their own products instead
// of shared memory; and dcum's L-step term is sum_m S_end o dS' with S_end
// the next chunk's start state. The decay is the forward route's running
// products, a step passing dcum where the product is at or above e^-30.
// du is one partial a (b, h), summed in a fixed order (no atomics, so a
// second call gives equal bits); dstate0 is the last dS'. 224,000 bytes of
// shared memory (two stages of the chunk's tiles, r_dec's and k_over's
// three parts, D', the f32 hand-offs), so a block an SM: the 160 (b, h) of
// the train shape run in two waves. tests/test_torch_wkv_bwd_hopper_route.py
// emulates its arithmetic. Measured (tools/time_kernels.py --only
// wkv_bwd in turns with the mma.sync route; NVIDIA H100 80GB HBM3, 700.00
// W): 0.1326-0.1347 ms at (4, 512, 40, 64), against 0.3509-0.3548, 4.5x
// its byte bound. What bounds it is the chunk hop of phase 2, 5.5 us: the
// products' warpgroup is busy for all of it but the 1.06 us it waits for
// the pass's pre-pass, and the pass for 5.66 us (tools/trace_wkv_bwd.py);
// a block lives 69 us, 16 of them phase 1, and the train shape's 160
// blocks take two waves (PERF.md).
//
// bf16 mma.sync route (wkv_bwd_walk_kernel, wkv_bwd_chunk_kernel,
// wkv_bwd_reduce_kernel; chunk below 64, N below 64, unaligned views):
// given a chunk's start state S and its end state's gradient dS', every
// term above is local to the chunk, the -30 mask and the L-step terms
// included. Three launches, one call:
//   1. the walk, a block per (h, b) and direction, 8 warps holding the
//      state in f32 registers: per chunk log w and its cumsum (a warp a
//      channel, shuffle scans), then forwards it writes S_j and adds
//      k_scaled^T . v, backwards it writes dS'_j and adds r_dec^T . dout,
//      each after exp(cum_L) scales the key channels' rows (logf and expf,
//      as the chunk kernel takes them);
//   2. the chunk kernel, a block per (chunk, h, b), 16 warps: warp w owns
//      chunk rows 16 (w % 4).. and a quarter of the output columns; it
//      builds the factors again, the strictly lower scores and dout.v^T,
//      dr_dec, dk_over, dk_scaled and dv (ldmatrix.trans for the
//      transposes), dr and dk, dcum; then a warp a channel walks dcum back
//      under the -30 mask into dlogw, and dw = dlogw / w where w >= 1e-8;
//   3. du's fixed-order sum over batches and chunks.
// Every product runs as mma.sync.m16n8k16, bf16 operands and f32 sums.
// dout.v^T takes two bf16 inputs and is exact; every f32 operand (r_dec,
// k_over, k_scaled, the scores, dout.v^T, S and dS') is split into bf16
// hi + lo, three mma a product of two such and two against a bf16 input:
// one rounding misses by far (ROADMAP C4; tests/test_torch_scan_bwd_
// rounding.py). The clamps are masked in f32 as the f32 route masks them
// (C9). N pads to kD = 16, 32 or 64 with zeros and the chunk to 64 rows.
// Workspaces: S_j and dS'_j, f32 (84 MB of traffic at the train shape).
// It served the train shape until the wgmma route (PERF.md row 4b: 0.3572
// ms there, 12x its byte bound).
//
// f32 route (wkv_bwd_kernel, the first port's, unchanged): it meets the f32
// gradient tolerance (5e-4). One block of 512 threads per (b, h), f32
// arithmetic on the CUDA cores. The block walks the chunks forward and
// writes the state at each chunk's start to a workspace (B x H x chunks x
// N x N f32, 21 MB at the train shape), then walks them backward with dS
// in shared memory. Per chunk: r, k, v, w, dout staged as f32 (odd
// pitches); one thread a channel runs the cumsum; the factors r_dec,
// k_over, k_scaled in parallel; the strictly lower scores and dout.v^T;
// then dr, dk, dv (written out) and dcum, a thread a channel walking it
// back (the -30 mask) into dlogw; then dw and the carried dS. du sums over
// batches without atomics: per-batch partials to a workspace, the second
// kernel sums them in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "scan_bwd.cuh"
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

// du = the partials summed in a fixed order: over batches, and over the
// `parts` partials of each (batch, head) (1 on the f32 route, the chunks on
// the bf16 route).
__global__ void wkv_bwd_reduce_kernel(const float* __restrict__ du_part,
                                      float* __restrict__ du, int B, int H,
                                      int N, int parts) {
  const int HN = H * N;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < HN;
       i += gridDim.x * blockDim.x) {
    const int h = i / N;
    const int n = i - h * N;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) {
      const float* p = du_part + (static_cast<size_t>(b) * H + h) * parts * N + n;
      for (int k = 0; k < parts; ++k) s += p[static_cast<size_t>(k) * N];
    }
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
                                                              H, N, 1);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int T_len, int N, int chunk) {
  return N >= 1 && N <= kMaxN && chunk >= 1 && chunk <= kMaxChunk &&
         T_len >= 1 && T_len % chunk == 0;
}

// --------------------------------------------------------------------------
// bf16 route: tensor cores, the chunks in parallel
// --------------------------------------------------------------------------

constexpr int kRows = 64;             // chunk rows in shared memory
constexpr int kCPitch = kRows + 8;    // pitch of the c x c tiles
constexpr int kRowWarps = 4;          // the chunk kernel: 16 rows a warp,
constexpr int kColWarps = 4;          // up to four warps a row block, each
constexpr int kTcWarps = kRowWarps * kColWarps;   // a share of the columns
constexpr int kTcThreads = 32 * kTcWarps;
constexpr float kMinW = 1e-8f;
constexpr float kMinCum = -30.0f;

// kD: N padded to 16, 32 or 64, with a pitch of kD + 8 (bf16 tiles) or
// kD + 1 (f32 buffers, whose columns the scans walk).
template <int kD>
__host__ __device__ constexpr int tc_pitch() { return kD + 8; }

template <int kD>
__host__ __device__ constexpr int f_pitch() { return kD + 1; }

// The walk kernel: 8 warps, 16 state rows and kD / kWalkSplit columns
// each (warps past the state take no part in the update); two stages of
// the factor's (k or r), the operand's (v or dout) and w's tiles; log w's
// cumsum (f32); the factor's hi and lo; exp(cum_L).
constexpr int kWalkWarps = 8;
constexpr int kWalkThreads = 32 * kWalkWarps;

template <int kD>
__host__ __device__ constexpr int walk_split() {
  return kWalkWarps / (kD / 16) < kD / 16 ? kWalkWarps / (kD / 16) : kD / 16;
}

template <int kD>
constexpr size_t walk_smem_bytes() {
  return sizeof(bf16) * 8 * kRows * tc_pitch<kD>() +
         sizeof(float) * (kRows * f_pitch<kD>() + kD);
}

// The chunk kernel: r, k, v, w, dout tiles; r_dec, k_over, k_scaled (hi,
// lo); a union of S (hi, lo) and of dr_dec o r_dec (f32); dS' (hi, lo); the
// scores and dout.v^T (hi, lo); the cumsum and dcum (f32); vectors.
template <int kD>
__host__ __device__ constexpr int s_union_bytes() {
  return 2 * kD * tc_pitch<kD>() * 2 > kRows * f_pitch<kD>() * 4
             ? 2 * kD * tc_pitch<kD>() * 2
             : kRows * f_pitch<kD>() * 4;
}

template <int kD>
constexpr size_t chunk_smem_bytes() {
  return sizeof(bf16) * (11 * kRows * tc_pitch<kD>() +
                         2 * kD * tc_pitch<kD>() + 4 * kRows * kCPitch) +
         s_union_bytes<kD>() +
         sizeof(float) * (2 * kRows * f_pitch<kD>() + 3 * kD + 2 * kRows +
                          2 * kRowWarps * kD);
}

// A pair of values to a bf16 row at column n (n even), within N.
__device__ __forceinline__ void store_pair(bf16* row, int n, int N, float v0,
                                           float v1) {
  if ((N & 1) == 0) {
    if (n < N) tc::st_bf16x2(row + n, tc::pack_bf16(v0, v1));
  } else {
    if (n < N) row[n] = __float2bfloat16_rn(v0);
    if (n + 1 < N) row[n + 1] = __float2bfloat16_rn(v1);
  }
}

// Warp-wide inclusive scan of column n of an f32 buffer of kRows rows
// (pitch fp), down the rows or (reverse) up them; lane l holds rows l and
// l + 32 (reversed: 63 - l and 31 - l). `add` is added at row `at` first;
// rows whose `mask` entry is below kMinCum add nothing (mask may be null).
__device__ __forceinline__ void scan_column(float* buf, const float* mask,
                                            int fp, int n, bool reverse,
                                            int at, float add) {
  const int lane = threadIdx.x & 31;
  const int r0 = reverse ? 63 - lane : lane;
  const int r1 = reverse ? 31 - lane : lane + 32;
  float v0 = buf[r0 * fp + n] + (r0 == at ? add : 0.0f);
  float v1 = buf[r1 * fp + n] + (r1 == at ? add : 0.0f);
  if (mask != nullptr) {
    if (mask[r0 * fp + n] < kMinCum) v0 = 0.0f;
    if (mask[r1 * fp + n] < kMinCum) v1 = 0.0f;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
    const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
    if (lane >= off) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  buf[r0 * fp + n] = v0;
  buf[r1 * fp + n] = v1;
}

// log w (0 past the chunk and past N) into lw, then its cumsum over the
// chunk in place, a warp a channel.
template <int kD, int kThreads>
__device__ __forceinline__ void chunk_cumsum(float* lw, const bf16* ws,
                                             int c, int N) {
  constexpr int kPitch = tc_pitch<kD>();
  constexpr int fp = f_pitch<kD>();
  constexpr int kWarps = kThreads / 32;
  for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
    const int t = i / kD;
    const int n = i - t * kD;
    const float wv = fmaxf(__bfloat162float(ws[t * kPitch + n]), kMinW);
    lw[t * fp + n] = t < c && n < N ? logf(wv) : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < (kD + kWarps - 1) / kWarps; ++i) {
    const int n = (threadIdx.x >> 5) + i * kWarps;
    if (n < kD) scan_column(lw, nullptr, fp, n, false, -1, 0.0f);
  }
  __syncthreads();
}

// The chunk's r, k, v, w, dout (rows t0.., zeros past the chunk and N).
template <int kD, int kThreads>
__device__ __forceinline__ void load_chunk(bf16* rs, bf16* ks, bf16* vs,
                                           bf16* ws, bf16* dos,
                                           const bf16* r, const bf16* k,
                                           const bf16* v, const bf16* w,
                                           const bf16* dout, size_t base,
                                           size_t stride, int t0, int c,
                                           int N, bool vec) {
  constexpr int kPitch = tc_pitch<kD>();
  tc::load_rows<kRows, kD, kPitch, kThreads>(rs, r + base, stride, t0, t0 + c,
                                            N, vec);
  tc::load_rows<kRows, kD, kPitch, kThreads>(ks, k + base, stride, t0, t0 + c,
                                            N, vec);
  tc::load_rows<kRows, kD, kPitch, kThreads>(vs, v + base, stride, t0, t0 + c,
                                            N, vec);
  tc::load_rows<kRows, kD, kPitch, kThreads>(ws, w + base, stride, t0, t0 + c,
                                            N, vec);
  tc::load_rows<kRows, kD, kPitch, kThreads>(dos, dout + base, stride, t0,
                                            t0 + c, N, vec);
  tc::cp_async_commit();
}

// Kernel 1, per (h, b) and direction (blockIdx.z): the chunk states. The
// warps hold the state in f32 registers (C tiles) and walk the chunks, the
// next chunk's tiles copied by cp.async into the other stage while this
// one is used. blockIdx.z = 0 walks forwards from S_0 = state0, writing S_j
// into `states` and then S_{j+1} = exp(cum_L) o S_j + k_scaled^T . v;
// blockIdx.z = 1 walks backwards from dS'_{K-1} = dstate_T (or 0), writing
// dS'_j into `dstates` and then dS'_{j-1} = exp(cum_L) o dS'_j + r_dec^T .
// dout, and last dstate0. exp(cum_L) scales each key channel's row; the
// factors k_scaled and r_dec are split into bf16 hi + lo.
template <int kD>
__global__ void __launch_bounds__(kWalkThreads)
wkv_bwd_walk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ w,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ state0,
                    const float* __restrict__ dstate_T,
                    float* __restrict__ states, float* __restrict__ dstates,
                    float* __restrict__ dstate0, int T_len, int H, int N,
                    int c, bool vec) {
  constexpr int kPitch = tc_pitch<kD>();
  constexpr int kTile = kRows * kPitch;
  constexpr int fp = f_pitch<kD>();
  constexpr int kSplit = walk_split<kD>();
  constexpr int kNTc = kD / 8 / kSplit;        // 8-column tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);   // stage: fac, opd, w
  bf16* f_hi = tiles + 6 * kTile;
  bf16* f_lo = f_hi + kTile;
  float* raw = reinterpret_cast<float*>(f_lo + kTile);   // log w's cumsum
  float* plast = raw + kRows * fp;                        // exp(cum_L)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool grad = blockIdx.z == 1;
  const int n_chunks = T_len / c;
  const size_t stride = static_cast<size_t>(H) * N;
  const size_t base = (static_cast<size_t>(b) * T_len * H + h) * N;
  const bf16* fac = grad ? r : k;
  const bf16* opd = grad ? dout : v;
  const size_t NN = static_cast<size_t>(N) * N;
  const size_t bh = static_cast<size_t>(b) * H + h;
  float* out = (grad ? dstates : states) + bh * n_chunks * NN;
  // warp (rb, ch): state rows 16 rb.., columns c0..c0 + kD / kSplit
  const int rb = warp % (kD / 16);
  const int ch = warp / (kD / 16);
  const bool active = ch < kSplit;
  const int n0 = 16 * rb;
  const int c0 = ch * (kD / kSplit);

  auto load = [&](int j, int st) {
    const int t0 = j * c;
    bf16* dst = tiles + 3 * st * kTile;
    tc::load_rows<kRows, kD, kPitch, kWalkThreads>(dst, fac + base, stride,
                                                  t0, t0 + c, N, vec);
    tc::load_rows<kRows, kD, kPitch, kWalkThreads>(dst + kTile, opd + base,
                                                  stride, t0, t0 + c, N, vec);
    tc::load_rows<kRows, kD, kPitch, kWalkThreads>(dst + 2 * kTile, w + base,
                                                  stride, t0, t0 + c, N, vec);
    tc::cp_async_commit();
  };

  float sacc[kNTc][4];
  const float* init = grad ? dstate_T : state0;
#pragma unroll
  for (int q = 0; q < kNTc; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + 8 * (e >> 1);
      const int m = c0 + 8 * q + 2 * t + (e & 1);
      sacc[q][e] = active && init != nullptr && n < N && m < N
                       ? init[bh * NN + static_cast<size_t>(n) * N + m]
                       : 0.0f;
    }
  }
  auto store_state = [&](float* dst) {
    if (!active) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + g + 8 * half;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < kNTc; ++q) {
        scan::store_pair(dst + static_cast<size_t>(n) * N, c0 + 8 * q + 2 * t,
                         N, sacc[q][2 * half], sacc[q][2 * half + 1]);
      }
    }
  };

  load(grad ? n_chunks - 1 : 0, 0);
  for (int i = 0; i < n_chunks; ++i) {
    const int j = grad ? n_chunks - 1 - i : i;
    const int st = i & 1;
    tc::cp_async_wait<0>();
    __syncthreads();   // the chunk has landed; the other stage is read
    if (i + 1 < n_chunks) load(grad ? j - 1 : j + 1, st ^ 1);
    const bf16* fs = tiles + 3 * st * kTile;
    const bf16* os = fs + kTile;
    const bf16* ws = os + kTile;
    store_state(out + static_cast<size_t>(j) * NN);
    // cum, log w and the factors as the chunk kernel computes them (logf,
    // expf), so both see the same decays
    chunk_cumsum<kD, kWalkThreads>(raw, ws, c, N);
    // k_scaled = k exp(cum_L - cum) or r_dec = r exp(cum - log w), split
    for (int idx = threadIdx.x; idx < kRows * kD / 2; idx += kWalkThreads) {
      const int tt = idx / (kD / 2);
      const int n = 2 * (idx - tt * (kD / 2));
      const int o = tt * kPitch + n;
      const float2 fv = tc::ld_bf16x2(fs + o), wv = tc::ld_bf16x2(ws + o);
      float f[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float cum = fmaxf(raw[tt * fp + n + q], kMinCum);
        if (grad) {
          const bool ok = tt < c && n + q < N;
          const float lw = ok ? logf(fmaxf(q ? wv.y : wv.x, kMinW)) : 0.0f;
          f[q] = (q ? fv.y : fv.x) * expf(cum - lw);
        } else {
          const float cl = fmaxf(raw[(c - 1) * fp + n + q], kMinCum);
          f[q] = (q ? fv.y : fv.x) * expf(cl - cum);
        }
      }
      uint32_t hi, lo;
      tc::split_bf16(f[0], f[1], hi, lo);
      tc::st_bf16x2(f_hi + o, hi);
      tc::st_bf16x2(f_lo + o, lo);
    }
    for (int n = threadIdx.x; n < kD; n += kWalkThreads) {
      plast[n] = expf(fmaxf(raw[(c - 1) * fp + n], kMinCum));
    }
    __syncthreads();   // the factor and exp(cum_L) are in
    if (active) {
      const float e0 = plast[n0 + g];
      const float e1 = plast[n0 + g + 8];
#pragma unroll
      for (int q = 0; q < kNTc; ++q) {
        sacc[q][0] *= e0;
        sacc[q][1] *= e0;
        sacc[q][2] *= e1;
        sacc[q][3] *= e1;
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        if (kk * 16 >= c) break;
        uint32_t ah[4], al[4], bv[kNTc / 2][4];
        tc::lda_t(ah, f_hi, kPitch, n0, kk * 16);
        tc::lda_t(al, f_lo, kPitch, n0, kk * 16);
#pragma unroll
        for (int q = 0; q < kNTc / 2; ++q) {
          tc::ldb_t(bv[q], os, kPitch, c0 + q * 16, kk * 16);
        }
        tc::mma_pairs<kNTc / 2>(sacc, ah, bv);
        tc::mma_pairs<kNTc / 2>(sacc, al, bv);
      }
    }
  }
  if (grad) store_state(dstate0 + bh * NN);
}

// Kernel 2, per (chunk j, h, b), 16 warps, warp w owning chunk rows 16 (w %
// 4).. and a share of the columns: the chunk's gradient from its start
// state S and its end state's gradient dS' (f32 from kernel 1). Every
// operand that is f32 here
// is split into bf16 hi + lo (three mma a product of two such, two with a
// bf16 input); dr, dk, dv, dw and the chunk's part of du.
template <int kD>
__global__ void __launch_bounds__(kTcThreads)
wkv_bwd_chunk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ w,
                     const float* __restrict__ u,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ states,
                     const float* __restrict__ dstates, bf16* __restrict__ dr,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     bf16* __restrict__ dw, float* __restrict__ du_part,
                     int T_len, int H, int N, int c, bool vec) {
  constexpr int kPitch = tc_pitch<kD>();
  constexpr int kTile = kRows * kPitch;
  constexpr int kSteps = kD / 16;
  constexpr int kNT = kD / 8;
  constexpr int kCTile = kRows * kCPitch;
  constexpr int fp = f_pitch<kD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* rs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = rs + kTile;
  bf16* vs = ks + kTile;
  bf16* ws = vs + kTile;
  bf16* dos = ws + kTile;
  bf16* rd_hi = dos + kTile;     // r_dec
  bf16* rd_lo = rd_hi + kTile;
  bf16* ko_hi = rd_lo + kTile;   // k_over
  bf16* ko_lo = ko_hi + kTile;
  bf16* kc_hi = ko_lo + kTile;   // k_scaled
  bf16* kc_lo = kc_hi + kTile;
  unsigned char* un = reinterpret_cast<unsigned char*>(kc_lo + kTile);
  bf16* s_hi = reinterpret_cast<bf16*>(un);   // S until barrier (5),
  bf16* s_lo = s_hi + kD * kPitch;
  float* fbuf = reinterpret_cast<float*>(un);  // then dr_dec o r_dec
  bf16* ds_hi = reinterpret_cast<bf16*>(un + s_union_bytes<kD>());   // dS'
  bf16* ds_lo = ds_hi + kD * kPitch;
  bf16* sc_hi = ds_lo + kD * kPitch;           // scores, rows t, columns s
  bf16* sc_lo = sc_hi + kCTile;
  bf16* dsc_hi = sc_lo + kCTile;               // dout.v^T, strictly lower
  bf16* dsc_lo = dsc_hi + kCTile;
  float* raw = reinterpret_cast<float*>(dsc_lo + kCTile);   // the cumsum
  float* dcm = raw + kRows * fp;               // dcum, then dlogw's sum
  float* us = dcm + kRows * fp;
  float* plast = us + kD;                      // exp(cum_L)
  float* ssd = plast + kD;                     // sum_m S o dS'
  float* diag = ssd + kD;                      // sum_n r u k
  float* ddiag = diag + kRows;                 // dout . v
  float* ekp = ddiag + kRows;                  // row blocks x kD
  float* dup = ekp + kRowWarps * kD;           // row blocks x kD

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int t0 = j * c;
  // warp (rw, ch): chunk rows 16 rw.., a kSplit-th of the output columns
  // of the c x N products from c0 (16 columns or more a warp; warps ch >=
  // kSplit take none)
  constexpr int kSplit = kD / 16 < kColWarps ? kD / 16 : kColWarps;
  constexpr int kNTc = kNT / kSplit;           // 8-column tiles a warp
  const int rw = warp % kRowWarps;
  const int ch = warp / kRowWarps;
  const bool cols = ch < kSplit;
  const int c0 = ch * (kD / kSplit);
  const int r0 = 16 * rw;
  const size_t stride = static_cast<size_t>(H) * N;
  const size_t base = (static_cast<size_t>(b) * T_len * H + h) * N;
  const size_t bhj = (static_cast<size_t>(b) * H + h) * n_chunks + j;
  load_chunk<kD, kTcThreads>(rs, ks, vs, ws, dos, r, k, v, w, dout, base,
                             stride, t0, c, N, vec);

  // S and dS' into their hi and lo copies (zeros past N), and the rows'
  // sums of S o dS'
  scan::load_states<kD, kTcThreads>(states + bhj * N * N, dstates + bhj * N * N,
                                    N, N, s_hi, s_lo, ds_hi, ds_lo, ssd);
  for (int n = threadIdx.x; n < kD; n += kTcThreads) {
    us[n] = n < N ? u[h * N + n] : 0.0f;
  }
  tc::cp_async_wait<0>();
  __syncthreads();   // (1) the chunk and the states are in
  chunk_cumsum<kD, kTcThreads>(raw, ws, c, N);   // (2), (3)

  // the factors, split; exp(cum_L); the bonus sum_n r u k and dout . v of
  // each row, a warp a row
  for (int i = threadIdx.x; i < kRows * kD / 2; i += kTcThreads) {
    const int tt = i / (kD / 2);
    const int n = 2 * (i - tt * (kD / 2));
    const int o = tt * kPitch + n;
    const float2 rv = tc::ld_bf16x2(rs + o), kv = tc::ld_bf16x2(ks + o), wv = tc::ld_bf16x2(ws + o);
    float rd[2], ko[2], kc[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool ok = tt < c && n + q < N;
      const float cum = fmaxf(raw[tt * fp + n + q], kMinCum);
      const float cl = fmaxf(raw[(c - 1) * fp + n + q], kMinCum);
      const float lw = ok ? logf(fmaxf(q ? wv.y : wv.x, kMinW)) : 0.0f;
      const float kq = q ? kv.y : kv.x;
      rd[q] = (q ? rv.y : rv.x) * expf(cum - lw);
      ko[q] = kq * expf(-cum);
      kc[q] = kq * expf(cl - cum);
    }
    uint32_t hi, lo;
    tc::split_bf16(rd[0], rd[1], hi, lo);
    tc::st_bf16x2(rd_hi + o, hi);
    tc::st_bf16x2(rd_lo + o, lo);
    tc::split_bf16(ko[0], ko[1], hi, lo);
    tc::st_bf16x2(ko_hi + o, hi);
    tc::st_bf16x2(ko_lo + o, lo);
    tc::split_bf16(kc[0], kc[1], hi, lo);
    tc::st_bf16x2(kc_hi + o, hi);
    tc::st_bf16x2(kc_lo + o, lo);
  }
  for (int n = threadIdx.x; n < kD; n += kTcThreads) {
    plast[n] = expf(fmaxf(raw[(c - 1) * fp + n], kMinCum));
  }
  for (int tt = warp; tt < kRows; tt += kTcWarps) {
    const int n = 2 * lane;
    float a = 0.0f, d = 0.0f;
    if (n < kD) {
      const int o = tt * kPitch + n;
      const float2 rv = tc::ld_bf16x2(rs + o), kv = tc::ld_bf16x2(ks + o);
      const float2 vv = tc::ld_bf16x2(vs + o), ov = tc::ld_bf16x2(dos + o);
      a = fmaf(rv.x * us[n], kv.x, rv.y * us[n + 1] * kv.y);
      d = fmaf(ov.x, vv.x, ov.y * vv.y);
    }
    a = tc::warp_sum(a);
    d = tc::warp_sum(d);
    if (lane == 0) {
      diag[tt] = a;
      ddiag[tt] = d;
    }
  }
  __syncthreads();   // (4) the factors are in

  // this warp's rows t: dout . v^T on the column tiles s <= r0 + 15 and
  // the scores = r_dec . k_over^T on those of them with q % kSplit = ch,
  // masked strictly lower; its columns of dr_dec = S dout_t + sum_{s<t}
  // (dout_t . v_s) k_over_s
  float sc[8][4], dsc[8][4], acc[kNTc][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[q][e] = dsc[q][e] = 0.0f;
#pragma unroll
  for (int q = 0; q < kNTc; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
  if (cols) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t rh[4], rl[4], da[4];
      tc::lda(da, dos, kPitch, r0, kk * 16);
      if (ch <= rw) {
        tc::lda(rh, rd_hi, kPitch, r0, kk * 16);
        tc::lda(rl, rd_lo, kPitch, r0, kk * 16);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q > rw) continue;
        uint32_t bv[1][4];
        tc::ldb(bv[0], vs, kPitch, q * 16, kk * 16);
        tc::mma_pairs<1>(dsc + 2 * q, da, bv);
        if (q % kSplit == ch) {
          uint32_t bh[1][4], bl[1][4];
          tc::ldb(bh[0], ko_hi, kPitch, q * 16, kk * 16);
          tc::ldb(bl[0], ko_lo, kPitch, q * 16, kk * 16);
          tc::mma_pairs<1>(sc + 2 * q, rh, bh);
          tc::mma_pairs<1>(sc + 2 * q, rh, bl);
          tc::mma_pairs<1>(sc + 2 * q, rl, bh);
        }
      }
      uint32_t sh[kNTc / 2][4], sl[kNTc / 2][4];
#pragma unroll
      for (int q = 0; q < kNTc / 2; ++q) {
        tc::ldb(sh[q], s_hi, kPitch, c0 + q * 16, kk * 16);
        tc::ldb(sl[q], s_lo, kPitch, c0 + q * 16, kk * 16);
      }
      tc::mma_pairs<kNTc / 2>(acc, da, sh);
      tc::mma_pairs<kNTc / 2>(acc, da, sl);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = r0 + g + 8 * (e >> 1);
        const int ss = 8 * q + 2 * t + (e & 1);
        if (ss >= tt) sc[q][e] = dsc[q][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > rw) continue;
      uint32_t ah[4], al[4], bh[kNTc / 2][4], bl[kNTc / 2][4];
      tc::c_to_a_split(dsc[2 * kk], dsc[2 * kk + 1], ah, al);
#pragma unroll
      for (int q = 0; q < kNTc / 2; ++q) {
        tc::ldb_t(bh[q], ko_hi, kPitch, c0 + q * 16, kk * 16);
        tc::ldb_t(bl[q], ko_lo, kPitch, c0 + q * 16, kk * 16);
      }
      tc::mma_pairs<kNTc / 2>(acc, ah, bh);
      tc::mma_pairs<kNTc / 2>(acc, ah, bl);
      tc::mma_pairs<kNTc / 2>(acc, al, bh);
    }
  }
  __syncthreads();   // (5) every read of S is done: dr_dec o r_dec takes its place

  // dr = dr_dec exp(cum - log w) + (dout_t . v_t) u k_t; dcum = dr_dec o
  // r_dec (for now); this warp's score and dout.v^T tiles to shared memory
#pragma unroll
  for (int q = 0; q < kNTc; ++q) {
    if (!cols) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tt = r0 + g + 8 * half;
      const int n = c0 + 8 * q + 2 * t;
      const int o = tt * kPitch + n;
      const float2 rv = tc::ld_bf16x2(rs + o), kv = tc::ld_bf16x2(ks + o), wv = tc::ld_bf16x2(ws + o);
      float out[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool ok = tt < c && n + i < N;
        const float cum = fmaxf(raw[tt * fp + n + i], kMinCum);
        const float lw = ok ? logf(fmaxf(i ? wv.y : wv.x, kMinW)) : 0.0f;
        const float e1 = expf(cum - lw);
        const float drd = acc[q][2 * half + i];
        out[i] = fmaf(drd, e1, ddiag[tt] * us[n + i] * (i ? kv.y : kv.x));
        const float f = drd * ((i ? rv.y : rv.x) * e1);
        fbuf[tt * fp + n + i] = f;
        dcm[tt * fp + n + i] = f;
      }
      if (tt < c) {
        store_pair(dr + base + static_cast<size_t>(t0 + tt) * stride, n, N,
                   out[0], out[1]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!cols || q > rw || q % kSplit != ch) continue;
    tc::store_split<2>(sc + 2 * q, sc_hi + 16 * q, sc_lo + 16 * q, kCPitch,
                       r0);
    tc::store_split<2>(dsc + 2 * q, dsc_hi + 16 * q, dsc_lo + 16 * q,
                       kCPitch, r0);
  }
  __syncthreads();   // (6) the score tiles are in

  // this warp's rows s and columns: dk_over = sum_{t>s} (dout_t . v_s)
  // r_dec_t, dk_scaled = dS' v_s, then dk; dcum -= dk_over o k_over +
  // dk_scaled o k_scaled; the columns' sums of dk_scaled o k_scaled and of
  // (dout_s . v_s) r_s k_s
  if (cols) {
    float ako[kNTc][4], aks[kNTc][4];
#pragma unroll
    for (int q = 0; q < kNTc; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) ako[q][e] = aks[q][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < rw || kk * 16 >= c) continue;
      uint32_t ah[4], al[4], bh[kNTc / 2][4], bl[kNTc / 2][4];
      tc::lda_t(ah, dsc_hi, kCPitch, r0, kk * 16);
      tc::lda_t(al, dsc_lo, kCPitch, r0, kk * 16);
#pragma unroll
      for (int q = 0; q < kNTc / 2; ++q) {
        tc::ldb_t(bh[q], rd_hi, kPitch, c0 + q * 16, kk * 16);
        tc::ldb_t(bl[q], rd_lo, kPitch, c0 + q * 16, kk * 16);
      }
      tc::mma_pairs<kNTc / 2>(ako, ah, bh);
      tc::mma_pairs<kNTc / 2>(ako, ah, bl);
      tc::mma_pairs<kNTc / 2>(ako, al, bh);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t va[4], bh[kNTc / 2][4], bl[kNTc / 2][4];
      tc::lda(va, vs, kPitch, r0, kk * 16);
#pragma unroll
      for (int q = 0; q < kNTc / 2; ++q) {
        tc::ldb(bh[q], ds_hi, kPitch, c0 + q * 16, kk * 16);
        tc::ldb(bl[q], ds_lo, kPitch, c0 + q * 16, kk * 16);
      }
      tc::mma_pairs<kNTc / 2>(aks, va, bh);
      tc::mma_pairs<kNTc / 2>(aks, va, bl);
    }
#pragma unroll
    for (int q = 0; q < kNTc; ++q) {
      float ec[2] = {0.0f, 0.0f}, uc[2] = {0.0f, 0.0f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ss = r0 + g + 8 * half;
        const int n = c0 + 8 * q + 2 * t;
        const int o = ss * kPitch + n;
        const float2 rv = tc::ld_bf16x2(rs + o), kv = tc::ld_bf16x2(ks + o);
        float out[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float cum = fmaxf(raw[ss * fp + n + i], kMinCum);
          const float cl = fmaxf(raw[(c - 1) * fp + n + i], kMinCum);
          const float en = expf(-cum);
          const float ed = expf(cl - cum);
          const float kq = i ? kv.y : kv.x;
          const float rq = i ? rv.y : rv.x;
          const float dko = ako[q][2 * half + i];
          const float dks = aks[q][2 * half + i];
          out[i] = fmaf(dko, en, fmaf(dks, ed, ddiag[ss] * us[n + i] * rq));
          const float ek = dks * (kq * ed);
          dcm[ss * fp + n + i] -= fmaf(dko, kq * en, ek);
          ec[i] += ek;
          uc[i] = fmaf(ddiag[ss], rq * kq, uc[i]);
        }
        if (ss < c) {
          store_pair(dk + base + static_cast<size_t>(t0 + ss) * stride, n, N,
                     out[0], out[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float e = tc::column_sum(ec[i]);
        const float d = tc::column_sum(uc[i]);
        if (g == 0) {
          ekp[rw * kD + c0 + 8 * q + 2 * t + i] = e;
          dup[rw * kD + c0 + 8 * q + 2 * t + i] = d;
        }
      }
    }
  }
  // dv_s = sum_{t>s} scores[t, s] dout_t + diag_s dout_s + dS'^T k_scaled_s
  if (cols) {
    float acc2[kNTc][4];
#pragma unroll
    for (int q = 0; q < kNTc; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[q][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < rw || kk * 16 >= c) continue;
      uint32_t ah[4], al[4], bv[kNTc / 2][4];
      tc::lda_t(ah, sc_hi, kCPitch, r0, kk * 16);
      tc::lda_t(al, sc_lo, kCPitch, r0, kk * 16);
#pragma unroll
      for (int q = 0; q < kNTc / 2; ++q) tc::ldb_t(bv[q], dos, kPitch, c0 + q * 16, kk * 16);
      tc::mma_pairs<kNTc / 2>(acc2, ah, bv);
      tc::mma_pairs<kNTc / 2>(acc2, al, bv);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ah[4], al[4], bh[kNTc / 2][4], bl[kNTc / 2][4];
      tc::lda(ah, kc_hi, kPitch, r0, kk * 16);
      tc::lda(al, kc_lo, kPitch, r0, kk * 16);
#pragma unroll
      for (int q = 0; q < kNTc / 2; ++q) {
        tc::ldb_t(bh[q], ds_hi, kPitch, c0 + q * 16, kk * 16);
        tc::ldb_t(bl[q], ds_lo, kPitch, c0 + q * 16, kk * 16);
      }
      tc::mma_pairs<kNTc / 2>(acc2, ah, bh);
      tc::mma_pairs<kNTc / 2>(acc2, ah, bl);
      tc::mma_pairs<kNTc / 2>(acc2, al, bh);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ss = r0 + g + 8 * half;
      if (ss >= c) continue;
#pragma unroll
      for (int q = 0; q < kNTc; ++q) {
        const int m = c0 + 8 * q + 2 * t;
        const float2 ov = tc::ld_bf16x2(dos + ss * kPitch + m);
        store_pair(dv + base + static_cast<size_t>(t0 + ss) * stride, m, N,
                   fmaf(diag[ss], ov.x, acc2[q][2 * half]),
                   fmaf(diag[ss], ov.y, acc2[q][2 * half + 1]));
      }
    }
  }
  __syncthreads();   // (7) dcum and the column sums are in

  // dcum at the chunk's last row takes sum_s dk_scaled o k_scaled and
  // exp(cum_L) sum_m S o dS'; its reverse cumsum, where the -30 clamp
  // passes it, is dlogw's sum (a warp a channel); du's part
#pragma unroll
  for (int i = 0; i < (kD + kTcWarps - 1) / kTcWarps; ++i) {
    const int n = warp + i * kTcWarps;
    if (n >= kD) continue;
    float tail = plast[n] * ssd[n];
#pragma unroll
    for (int q = 0; q < kRowWarps; ++q) tail += ekp[q * kD + n];
    scan_column(dcm, raw, fp, n, true, c - 1, tail);
  }
  for (int n = threadIdx.x; n < N; n += kTcThreads) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kRowWarps; ++q) s += dup[q * kD + n];
    du_part[bhj * N + n] = s;
  }
  __syncthreads();   // (8) dlogw's sums are in

  // dw = dlogw / w where w >= 1e-8 (0 below the clamp)
  for (int i = threadIdx.x; i < c * kD / 2; i += kTcThreads) {
    const int tt = i / (kD / 2);
    const int n = 2 * (i - tt * (kD / 2));
    const float2 wv = tc::ld_bf16x2(ws + tt * kPitch + n);
    float out[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float wq = q ? wv.y : wv.x;
      const float dlogw = dcm[tt * fp + n + q] - fbuf[tt * fp + n + q];
      out[q] = wq >= kMinW ? dlogw / fmaxf(wq, kMinW) : 0.0f;
    }
    store_pair(dw + base + static_cast<size_t>(t0 + tt) * stride, n, N,
               out[0], out[1]);
  }
}

template <int kD>
int set_smem_tc() {
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_walk_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(walk_smem_bytes<kD>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      wkv_bwd_chunk_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(chunk_smem_bytes<kD>())));
}

template <int kD>
int launch_tc(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* state0, const void* dout,
              const float* dstate_T, void* dr, void* dk, void* dv, void* dw,
              float* du, float* dstate0, float* states, float* dstates,
              float* du_part, int B, int T_len, int H, int N, int c,
              cudaStream_t stream) {
  int err = set_smem_tc<kD>();
  if (err != 0) return err;
  const bf16* rb = static_cast<const bf16*>(r);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* ob = static_cast<const bf16*>(dout);
  const bool vec = N % 8 == 0 && tc::aligned16(r) && tc::aligned16(k) &&
                   tc::aligned16(v) && tc::aligned16(w) && tc::aligned16(dout);
  const int n_chunks = T_len / c;
  wkv_bwd_walk_kernel<kD><<<dim3(H, B, 2), kWalkThreads, walk_smem_bytes<kD>(),
                            stream>>>(rb, kb, vb, wb, ob, state0, dstate_T,
                                      states, dstates, dstate0, T_len, H, N, c,
                                      vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  wkv_bwd_chunk_kernel<kD><<<dim3(n_chunks, H, B), kTcThreads,
                             chunk_smem_bytes<kD>(), stream>>>(
      rb, kb, vb, wb, u, ob, states, dstates, static_cast<bf16*>(dr),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<bf16*>(dw),
      du_part, T_len, H, N, c, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  wkv_bwd_reduce_kernel<<<(H * N + 255) / 256, 256, 0, stream>>>(
      du_part, du, B, H, N, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Kernel `part` of the bf16 route (0 the chunk kernel, 1 the walk).
template <int kD>
int info_tc(int part, int* info) {
  const int err = set_smem_tc<kD>();
  if (err != 0) return err;
  if (part == 1) {
    return tc::kernel_info(wkv_bwd_walk_kernel<kD>, kWalkThreads,
                           walk_smem_bytes<kD>(), info);
  }
  return tc::kernel_info(wkv_bwd_chunk_kernel<kD>, kTcThreads,
                         chunk_smem_bytes<kD>(), info);
}

// --------------------------------------------------------------------------
// bf16 wgmma route on Hopper (N = chunk = 64): one block of three
// warpgroups a (b, h), TMA tiles and wgmma, every f32 operand split into
// bf16 hi + lo
// --------------------------------------------------------------------------

namespace wg {

using hp::desc_k;
using hp::desc_mn;
using hp::ld_sw;
using hp::rcp_approx;
using hp::st_sw;

constexpr int kMmaThreads = 128;            // the products' warpgroup
constexpr int kPassThreads = 256;           // the two pass warpgroups
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kPassRows = 64 / kPassWarps;  // a pass warp's chunk rows
static_assert(kPassRows == 8, "the pass's row sums take 8 rows a warp");
constexpr int kThreads = kMmaThreads + kPassThreads;
// registers a thread by setmaxnreg: the block starts at the launch
// bound's kEntryRegs, and the products' warpgroup can take only what the
// pass warpgroups give back
constexpr int kEntryRegs = 65536 / kThreads / 8 * 8;
constexpr int kMmaRegs = 216;
constexpr int kPassRegs = 144;
static_assert(kPassThreads * (kEntryRegs - kPassRegs) >=
                  kMmaThreads * (kMmaRegs - kEntryRegs),
              "the pass gives back what the products take");
constexpr int kTile = hp::kSwTile;          // a 64 x 64 bf16 tile
constexpr int kStateBytes = 2 * kTile;      // a chunk state's hi and lo
// a stage's tiles: phase 2 takes r, k, w, v, dout by TMA and S_j's hi and
// lo (the workspace's image of them) by one bulk copy; phase 1 takes k, w,
// v by TMA into a ring of four slots over the same bytes (kSlots of
// them), and puts k_over's hi and lo in r_dec's and k_over's tiles, two
// stages
enum { kR, kK, kW, kV, kDo, kSh, kSl, kStageTiles };
constexpr int kStage = kStageTiles * kTile;
constexpr int kSlots = 4;
constexpr int kSlot = 3 * kTile;
static_assert(kSlots * kSlot <= 2 * kStage, "phase 1's ring fits");
// byte offsets from the 1024-aligned base: two stages; r_dec's and
// k_over's three bf16 parts (x = hi + lo + lo2, lo2 = bf16(x - hi - lo));
// D' = diag(exp(cum_L)) dS''s hi and lo; the f32 hand-off tiles dr_dec
// and dk_tot (pitch 72 floats, free of bank conflicts for the fragments'
// float2 stores); the vectors
constexpr int kOffRd = 2 * kStage;
constexpr int kOffKo = kOffRd + 3 * kTile;
constexpr int kOffDs = kOffKo + 3 * kTile;
constexpr int kHPitch = 72;
constexpr int kOffH = kOffDs + 2 * kTile;
constexpr int kHBytes = 64 * kHPitch * static_cast<int>(sizeof(float));
constexpr int kOffVec = kOffH + 2 * kHBytes;
// the vectors, in floats from kOffVec: exp(cum_L) (phase 1 a stage each),
// the diagonal bonus sum_n r u k and dout . v of each row, the L-step
// terms sum_m S_end o dS' of two chunks, u, and two sets of the pass
// warps' column products or sums (kPassWarps x 64 each)
enum { kVP = 0, kVBonus = 128, kVDd = 192, kVTail = 256, kVU = 384,
       kVTot = 448, kVScan = kVTot + 64 * kPassWarps,
       kVecFloats = kVScan + 64 * kPassWarps };
constexpr size_t kSmem = 1024 + kOffVec + kVecFloats * sizeof(float);
// named barriers: 1 the pass's warpgroups, 2 the products', then the
// block's: the pre-pass done, dr_dec handed off, dk_tot handed off, a
// chunk done, phase 1 done
enum { kBarPass = 1, kBarMma, kBarPre, kBarH1, kBarH2, kBarEnd, kBarPhase };
constexpr float kClampExp = 9.357623e-14f;   // e^-30

// Phase 1's pass of a chunk by the 256 pass threads (warp w: rows 8 w..8 w
// + 7, lane l: key channels 2 l, 2 l + 1): the decay e = max(prod_s
// max(w_s, 1e-8), e^-30) as running products down the warp's rows and the
// earlier warps' column products (`tot`, one barrier), as the forward's
// pass; k_over = k / e split into hi and lo (tiles `ko` and `ko` + kTile)
// from the slot's k and w tiles (`slot`, `slot` + kTile), and
// exp(cum[c-1]) of each key channel in plast.
__device__ __forceinline__ void pass_kover(const unsigned char* slot,
                                           unsigned char* ko, float* tot,
                                           float* plast) {
  const int warp = (threadIdx.x - kMmaThreads) >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = kPassRows * warp, n0 = 2 * lane;
  const unsigned char* kt = slot;
  const unsigned char* wt = slot + kTile;
  float run0 = 1.0f, run1 = 1.0f;
#pragma unroll
  for (int i = 0; i < kPassRows; ++i) {
    const float2 wv = ld_sw(wt, r0 + i, n0);
    run0 *= fmaxf(wv.x, kMinW);
    run1 *= fmaxf(wv.y, kMinW);
  }
  *reinterpret_cast<float2*>(tot + warp * 64 + n0) = make_float2(run0, run1);
  hp::bar_sync(kBarPass, kPassThreads);
  float pre0 = 1.0f, pre1 = 1.0f;
#pragma unroll
  for (int q = 0; q < kPassWarps - 1; ++q) {
    if (q < warp) {
      const float2 tq = *reinterpret_cast<const float2*>(tot + q * 64 + n0);
      pre0 *= tq.x;
      pre1 *= tq.y;
    }
  }
  if (warp == kPassWarps - 1) {
    plast[n0] = fmaxf(pre0 * run0, kClampExp);
    plast[n0 + 1] = fmaxf(pre1 * run1, kClampExp);
  }
  float inc0 = 1.0f, inc1 = 1.0f;
#pragma unroll
  for (int i = 0; i < kPassRows; ++i) {
    const int row = r0 + i;
    const float2 wv = ld_sw(wt, row, n0);
    inc0 *= fmaxf(wv.x, kMinW);
    inc1 *= fmaxf(wv.y, kMinW);
    const float e0 = fmaxf(pre0 * inc0, kClampExp);
    const float e1 = fmaxf(pre1 * inc1, kClampExp);
    const float2 kv = ld_sw(kt, row, n0);
    uint32_t hi, lo;
    tc::split_bf16(kv.x * rcp_approx(e0), kv.y * rcp_approx(e1), hi, lo);
    st_sw(ko, row, n0, hi);
    st_sw(ko + kTile, row, n0, lo);
  }
  hp::fence_proxy_async();   // the tiles, for the wgmma that read them
}

// x0, x1 as three bf16 pairs with x = p1 + p2 + p3 to about 24 bits
// (p3 = bf16(x - p1 - p2)).
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& p1,
                                            uint32_t& p2, uint32_t& p3) {
  tc::split_bf16(x0, x1, p1, p2);
  const float2 h = tc::unpack_bf16(p1), l = tc::unpack_bf16(p2);
  p3 = tc::pack_bf16((x0 - h.x) - l.x, (x1 - h.y) - l.y);
}

// The chunk's strictly triangular part of a 64 x 64 D fragment (a score
// matrix, rows x, columns y of the fragment), in place: kept where y < x
// (kLower) or y > x (upper), `diag[x]` on the diagonal (null: 0), 0
// elsewhere. The diagonal it replaces goes to `diag_out` (unless null).
template <bool kLower>
__device__ __forceinline__ void mask_tri(float (&d)[32], const float* diag,
                                         float* diag_out = nullptr) {
  const int lane = threadIdx.x & 31;
  const int x0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int y0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = x0 + 8 * (e >> 1);
      const int y = 8 * j + y0 + (e & 1);
      if (y == x) {
        if (diag_out != nullptr) diag_out[x] = d[4 * j + e];
        d[4 * j + e] = diag != nullptr ? diag[x] : 0.0f;
      } else if (kLower ? y > x : y < x) {
        d[4 * j + e] = 0.0f;
      }
    }
  }
}

// A D fragment split into bf16 parts as the A operands of its four k
// steps: hi and lo (a[0], a[1]), or with kParts 3 also lo2 (a[2]).
template <int kParts>
__device__ __forceinline__ void split_frag(const float (&d)[32],
                                           uint32_t (&a)[kParts][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x0 = d[8 * kk + 2 * q], x1 = d[8 * kk + 2 * q + 1];
      if constexpr (kParts == 3) {
        split3_bf16(x0, x1, a[0][kk][q], a[1][kk][q], a[2][kk][q]);
      } else {
        tc::split_bf16(x0, x1, a[0][kk][q], a[1][kk][q]);
      }
    }
}

// acc += a . b over the chunk's 64 rows from three-part operands (a's A
// fragments, b's three MN-major tiles from `b`, kTile apart), the six part
// products of order at most two (about 24 bits, as f32).
__device__ __forceinline__ void mma_rs3(float (&acc)[32],
                                        const uint32_t (&a)[3][4][4],
                                        uint32_t b) {
  const uint64_t b1 = desc_mn(b, 0), b2 = desc_mn(b + kTile, 0),
                 b3 = desc_mn(b + 2 * kTile, 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hp::mma_rs(acc, a[0][kk], b1 + 128 * kk, 1);
    hp::mma_rs(acc, a[0][kk], b2 + 128 * kk, 1);
    hp::mma_rs(acc, a[1][kk], b1 + 128 * kk, 1);
    hp::mma_rs(acc, a[0][kk], b3 + 128 * kk, 1);
    hp::mma_rs(acc, a[2][kk], b1 + 128 * kk, 1);
    hp::mma_rs(acc, a[1][kk], b2 + 128 * kk, 1);
  }
}

// A 64 x 64 f32 D fragment into an f32 tile of pitch kHPitch.
__device__ __forceinline__ void st_frag_f32(float* tile,
                                            const float (&d)[32]) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(tile + (row + 8 * hh) * kHPitch + 8 * j +
                                 col) =
          make_float2(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
}

// One block of three warpgroups per (b, h). Warps 0-3 (the products, 216
// registers) hold the f32 state, then its gradient, in registers (the
// wgmma D fragment: rows n, columns m) and issue every copy; warps 4-11
// (the pass, 144 registers) run the elementwise work, 8 rows and 2 key
// channels a thread (see pass_kover).
//
// Phase 1 walks the chunks forwards from S_0 = state0, as the forward's
// wgmma kernel: k, w, v come by TMA into a ring of four slots (chunks 0
// and 1 first), the pass forms k_over a chunk ahead, and the products'
// warpgroup writes S_j's hi and lo tiles (stmatrix into D''s tiles, then
// one 16 KB bulk store to the workspace), then S_{j+1} = exp(cum_L) (S_j +
// k_over^T . v) (wgmma). It ends with S_K in registers, and phase 2's
// first two chunks already on their way.
//
// Phase 2 walks them backwards with dS' (the gradient of the chunk's end
// state, from dstate_T) in registers. Chunk j's r, k, w, v, dout come by
// TMA and S_j's tiles by a bulk copy, a chunk ahead. Then:
//   a. the pass: e, r_dec = r e / w and k_over = k / e split into three
//      bf16 parts (tiles), exp(cum_L) and the bonus sum_n r u k of each
//      row; meanwhile the products: dscores = dout . v^T (exact; its
//      diagonal is ddiag = dout . v of each row) and dr_dec = dout . S_j^T;
//   b. the products: dr_dec += dscores . k_over (dscores masked strictly
//      lower, both in three parts), handed off in f32; D' = exp(cum_L) dS'
//      into hi and lo tiles; dS' = D' + r_dec^T . dout, and the L-step
//      term sum_m S_j o dS' of the chunk before (its end state is S_j; S_j
//      by ldmatrix); dscores^T = v . dout^T and dk_tot = dscores^T . r_dec
//      (three parts) + v . D'^T (= dk_over + exp(cum_L) dk_scaled), handed
//      off in f32; scores^T = k_over . r_dec^T, masked strictly upper with
//      the bonus on the diagonal, split, and dv = scores^T . dout + k_over
//      . D' (= k_scaled . dS'), out by stmatrix and a TMA store;
//   c. the pass, as each hand-off arrives: dr = dr_dec e / w + ddiag u k;
//      dk = dk_tot / e + ddiag u r; dcum = dr_dec r_dec - dk_tot k_over,
//      plus at the last row the L-step term sum_m S_end o dS' (= sum_s
//      dk_scaled k_scaled + exp(cum_L) sum_m S o dS'); its reverse sum
//      where the product of the decays is at or above e^-30 (the warps'
//      column sums through shared memory, a fixed order); dlogw = that sum
//      - dr_dec r_dec and dw = dlogw / w where w >= 1e-8; du's part.
// Each product's registers live in a block of their own: arrays shared
// between the products made ptxas serialise every wgmma (C7511).
// The last dS' is dstate0; du is one partial a (b, h), summed in a fixed
// order by wkv_bwd_reduce_kernel.
__global__ void __launch_bounds__(kThreads, 1)
wkv_bwd_wg_kernel(const __grid_constant__ CUtensorMap tm_r,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_dv,
                  const float* __restrict__ u,
                  const float* __restrict__ state0,
                  const float* __restrict__ dstate_T, bf16* __restrict__ dr,
                  bf16* __restrict__ dk, bf16* __restrict__ dw,
                  float* __restrict__ du_part, float* __restrict__ dstate0,
                  unsigned char* __restrict__ work, int T_len, int H) {
  // phase 1's slots in (TMA), its k_over stages passed and free again,
  // phase 2's stages in
  __shared__ __align__(8) uint64_t bars[kSlots + 6];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = hp::smem_u32(smem);
  float* vec = reinterpret_cast<float*>(smem + kOffVec);
  const uint32_t bar_in1 = hp::smem_u32(bars);
  const uint32_t bar_pass1 = bar_in1 + 8 * kSlots;
  const uint32_t bar_free1 = bar_pass1 + 16;
  const uint32_t bar_in2 = bar_free1 + 16;
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int K = T_len / 64;
  const size_t bh = static_cast<size_t>(b) * H + h;
  unsigned char* states = work + bh * K * kStateBytes;
  const size_t stride = static_cast<size_t>(H) * 64;   // between steps
  // element (step t, channel n) of this (b, h): base + t * stride + n
  const size_t io = (static_cast<size_t>(b) * T_len * H + h) * 64;

  auto load1 = [&](int c) {          // k, w, v of chunk c into its slot
    const uint32_t s = base + (c % kSlots) * kSlot;
    const uint32_t bar = bar_in1 + 8 * (c % kSlots);
    hp::mbar_expect_tx(bar, kSlot);
    hp::tma_load_4d(s, &tm_k, bar, 0, h, 64 * c, b);
    hp::tma_load_4d(s + kTile, &tm_w, bar, 0, h, 64 * c, b);
    hp::tma_load_4d(s + 2 * kTile, &tm_v, bar, 0, h, 64 * c, b);
  };
  auto load2 = [&](int i) {          // step i of phase 2: chunk K - 1 - i
    const int j = K - 1 - i, st = i & 1;
    const uint32_t s = base + st * kStage;
    const uint32_t bar = bar_in2 + 8 * st;
    hp::mbar_expect_tx(bar, kStageTiles * kTile);
    hp::tma_load_4d(s + kR * kTile, &tm_r, bar, 0, h, 64 * j, b);
    hp::tma_load_4d(s + kK * kTile, &tm_k, bar, 0, h, 64 * j, b);
    hp::tma_load_4d(s + kW * kTile, &tm_w, bar, 0, h, 64 * j, b);
    hp::tma_load_4d(s + kV * kTile, &tm_v, bar, 0, h, 64 * j, b);
    hp::tma_load_4d(s + kDo * kTile, &tm_do, bar, 0, h, 64 * j, b);
    hp::bulk_load(s + kSh * kTile, states + static_cast<size_t>(j) *
                  kStateBytes, kStateBytes, bar);
  };
  if (tid == 0) {
    hp::prefetch_tensormap(&tm_r);
    hp::prefetch_tensormap(&tm_k);
    hp::prefetch_tensormap(&tm_v);
    hp::prefetch_tensormap(&tm_w);
    hp::prefetch_tensormap(&tm_do);
    hp::prefetch_tensormap(&tm_dv);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) hp::mbar_init(bar_in1 + 8 * i, 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hp::mbar_init(bar_pass1 + 8 * i, kPassThreads);
      hp::mbar_init(bar_free1 + 8 * i, 1);
      hp::mbar_init(bar_in2 + 8 * i, 1);
    }
    hp::fence_barrier_init();
    // chunks 0 and 1 first, the ring's other slots once chunk 0 is in
    for (int c = 0; c < K && c < 2; ++c) load1(c);
  }
  if (tid >= kMmaThreads && tid < kMmaThreads + 64) {
    vec[kVU + tid - kMmaThreads] = u[h * 64 + tid - kMmaThreads];
  }
  __syncthreads();   // the barriers and u

  if (tid >= kMmaThreads) {
    // ---- the pass warpgroups ---------------------------------------------
    hp::setmaxnreg_dec<kPassRegs>();
    for (int c = 0; c < K; ++c) {
      const int st = c & 1;
      hp::mbar_wait(bar_in1 + 8 * (c % kSlots), (c / kSlots) & 1);
      // the products are done with chunk c - 2's k_over and exp(cum_L)
      if (c >= 2) hp::mbar_wait(bar_free1 + 8 * st, ((c >> 1) - 1) & 1);
      pass_kover(smem + (c % kSlots) * kSlot, smem + kOffRd + st * 2 * kTile,
                 vec + kVTot + 512 * st, vec + kVP + 64 * st);
      hp::mbar_arrive(bar_pass1 + 8 * st);
    }
    hp::bar_sync(kBarPhase, kThreads);   // phase 1 done: S_j written
    const int warp = (tid - kMmaThreads) >> 5;
    const int lane = tid & 31;
    const int r0 = kPassRows * warp, n0 = 2 * lane;
    const float u0 = vec[kVU + n0], u1 = vec[kVU + n0 + 1];
    float* tot = vec + kVTot;
    float* scan = vec + kVScan;
    const float* h1 = reinterpret_cast<const float*>(smem + kOffH);
    const float* h2 = h1 + 64 * kHPitch;
    unsigned char* rd_hi = smem + kOffRd;
    unsigned char* ko_hi = smem + kOffKo;
    float du0 = 0.0f, du1 = 0.0f;
    for (int i = 0; i < K; ++i) {
      const int j = K - 1 - i, st = i & 1;
      const unsigned char* s = smem + st * kStage;
      hp::mbar_wait(bar_in2 + 8 * st, (i >> 1) & 1);
      // a. e by running products, as in phase 1
      float run0 = 1.0f, run1 = 1.0f;
#pragma unroll
      for (int q = 0; q < kPassRows; ++q) {
        const float2 wv = ld_sw(s + kW * kTile, r0 + q, n0);
        run0 *= fmaxf(wv.x, kMinW);
        run1 *= fmaxf(wv.y, kMinW);
      }
      *reinterpret_cast<float2*>(tot + warp * 64 + n0) =
          make_float2(run0, run1);
      hp::bar_sync(kBarPass, kPassThreads);
      float pre0 = 1.0f, pre1 = 1.0f;
#pragma unroll
      for (int q = 0; q < kPassWarps - 1; ++q) {
        if (q < warp) {
          const float2 tq =
              *reinterpret_cast<const float2*>(tot + q * 64 + n0);
          pre0 *= tq.x;
          pre1 *= tq.y;
        }
      }
      if (warp == kPassWarps - 1) {
        vec[kVP + n0] = fmaxf(pre0 * run0, kClampExp);
        vec[kVP + n0 + 1] = fmaxf(pre1 * run1, kClampExp);
      }
      // e and 1 / max(w, 1e-8) of the thread's 16 elements, kept for the
      // epilogue; bit 2 q + x of `live`: the product at or above e^-30
      float e[kPassRows][2], iw[kPassRows][2], dpb[kPassRows];
      uint32_t live = 0;
      float inc0 = 1.0f, inc1 = 1.0f;
#pragma unroll
      for (int q = 0; q < kPassRows; ++q) {
        const int row = r0 + q;
        const float2 wv = ld_sw(s + kW * kTile, row, n0);
        const float w0 = fmaxf(wv.x, kMinW), w1 = fmaxf(wv.y, kMinW);
        inc0 *= w0;
        inc1 *= w1;
        const float raw0 = pre0 * inc0, raw1 = pre1 * inc1;
        live |= (raw0 >= kClampExp ? 1u : 0u) << (2 * q);
        live |= (raw1 >= kClampExp ? 1u : 0u) << (2 * q + 1);
        e[q][0] = fmaxf(raw0, kClampExp);
        e[q][1] = fmaxf(raw1, kClampExp);
        iw[q][0] = rcp_approx(w0);
        iw[q][1] = rcp_approx(w1);
        const float2 rv = ld_sw(s + kR * kTile, row, n0);
        const float2 kv = ld_sw(s + kK * kTile, row, n0);
        dpb[q] = fmaf(rv.y * u1, kv.y, rv.x * u0 * kv.x);
        uint32_t hi, lo, lo2;
        split3_bf16(rv.x * (e[q][0] * iw[q][0]), rv.y * (e[q][1] * iw[q][1]),
                    hi, lo, lo2);
        st_sw(rd_hi, row, n0, hi);
        st_sw(rd_hi + kTile, row, n0, lo);
        st_sw(rd_hi + 2 * kTile, row, n0, lo2);
        split3_bf16(kv.x * rcp_approx(e[q][0]), kv.y * rcp_approx(e[q][1]),
                    hi, lo, lo2);
        st_sw(ko_hi, row, n0, hi);
        st_sw(ko_hi + kTile, row, n0, lo);
        st_sw(ko_hi + 2 * kTile, row, n0, lo2);
      }
      const float bonus = tc::row_sums8(dpb);
      if ((lane & 3) == 0) vec[kVBonus + r0 + tc::row8_of(lane)] = bonus;
      hp::fence_proxy_async();   // the tiles, for the wgmma that read them
      hp::bar_sync(kBarPre, kThreads);
      float dd[kPassRows];
#pragma unroll
      for (int q = 0; q < kPassRows; ++q) dd[q] = vec[kVDd + r0 + q];

      // c. dr, as dr_dec comes; dcum's first term
      float x[kPassRows][2];
      hp::bar_sync(kBarH1, kThreads);
#pragma unroll
      for (int q = 0; q < kPassRows; ++q) {
        const int row = r0 + q;
        const float2 g = *reinterpret_cast<const float2*>(h1 + row * kHPitch +
                                                         n0);
        const float2 rv = ld_sw(s + kR * kTile, row, n0);
        const float2 kv = ld_sw(s + kK * kTile, row, n0);
        const float a0 = e[q][0] * iw[q][0], a1 = e[q][1] * iw[q][1];
        x[q][0] = g.x * (rv.x * a0);
        x[q][1] = g.y * (rv.y * a1);
        const float o0 = fmaf(g.x, a0, dd[q] * u0 * kv.x);
        const float o1 = fmaf(g.y, a1, dd[q] * u1 * kv.y);
        *reinterpret_cast<uint32_t*>(dr + io + (64 * j + row) * stride +
                                     n0) = tc::pack_bf16(o0, o1);
      }
      // dk as dk_tot comes; dcum, masked, and its sums up the warp's rows
      hp::bar_sync(kBarH2, kThreads);
      float sum0 = 0.0f, sum1 = 0.0f;
      float acc[kPassRows][2];
#pragma unroll
      for (int q = kPassRows - 1; q >= 0; --q) {
        const int row = r0 + q;
        const float2 g = *reinterpret_cast<const float2*>(h2 + row * kHPitch +
                                                         n0);
        const float2 rv = ld_sw(s + kR * kTile, row, n0);
        const float2 kv = ld_sw(s + kK * kTile, row, n0);
        const float ie0 = rcp_approx(e[q][0]), ie1 = rcp_approx(e[q][1]);
        const float o0 = fmaf(g.x, ie0, dd[q] * u0 * rv.x);
        const float o1 = fmaf(g.y, ie1, dd[q] * u1 * rv.y);
        *reinterpret_cast<uint32_t*>(dk + io + (64 * j + row) * stride +
                                     n0) = tc::pack_bf16(o0, o1);
        du0 = fmaf(dd[q], rv.x * kv.x, du0);
        du1 = fmaf(dd[q], rv.y * kv.y, du1);
        float c0 = x[q][0] - g.x * (kv.x * ie0);
        float c1 = x[q][1] - g.y * (kv.y * ie1);
        if (row == 63) {
          c0 += vec[kVTail + 64 * (j & 1) + n0];
          c1 += vec[kVTail + 64 * (j & 1) + n0 + 1];
        }
        sum0 += (live >> (2 * q)) & 1u ? c0 : 0.0f;
        sum1 += (live >> (2 * q + 1)) & 1u ? c1 : 0.0f;
        acc[q][0] = sum0;
        acc[q][1] = sum1;
      }
      *reinterpret_cast<float2*>(scan + warp * 64 + n0) =
          make_float2(sum0, sum1);
      hp::bar_sync(kBarPass, kPassThreads);
      float post0 = 0.0f, post1 = 0.0f;
#pragma unroll
      for (int q = kPassWarps - 1; q > 0; --q) {
        if (q > warp) {
          const float2 tq =
              *reinterpret_cast<const float2*>(scan + q * 64 + n0);
          post0 += tq.x;
          post1 += tq.y;
        }
      }
      // dlogw = the masked reverse sum of dcum - dr_dec r_dec; dw
#pragma unroll
      for (int q = 0; q < kPassRows; ++q) {
        const int row = r0 + q;
        const float2 wv = ld_sw(s + kW * kTile, row, n0);
        const float g0 = (acc[q][0] + post0) - x[q][0];
        const float g1 = (acc[q][1] + post1) - x[q][1];
        *reinterpret_cast<uint32_t*>(dw + io + (64 * j + row) * stride +
                                     n0) =
            tc::pack_bf16(wv.x >= kMinW ? g0 * iw[q][0] : 0.0f,
                          wv.y >= kMinW ? g1 * iw[q][1] : 0.0f);
      }
      hp::bar_sync(kBarEnd, kThreads);
    }
    // du's part of this (b, h): the warps' sums in order
    *reinterpret_cast<float2*>(scan + warp * 64 + n0) = make_float2(du0, du1);
    hp::bar_sync(kBarPass, kPassThreads);
    if (warp == 0) {
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int q = 0; q < kPassWarps; ++q) {
        const float2 tq = *reinterpret_cast<const float2*>(scan + q * 64 + n0);
        s0 += tq.x;
        s1 += tq.y;
      }
      *reinterpret_cast<float2*>(du_part + bh * 64 + n0) = make_float2(s0, s1);
    }
    return;
  }

  // ---- the products' warpgroup ---------------------------------------------
  hp::setmaxnreg_inc<kMmaRegs>();
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * warp;
  const uint32_t rd_h = base + kOffRd, rd_l = rd_h + kTile;
  const uint32_t ko_h = base + kOffKo, ko_l = ko_h + kTile;
  const uint32_t ds_h = base + kOffDs, ds_l = ds_h + kTile;
  float S[32];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 v = *reinterpret_cast<const float2*>(
          state0 + bh * 4096 + (r0 + g + 8 * hh) * 64 + 8 * jj + 2 * t);
      S[4 * jj + 2 * hh] = v.x;
      S[4 * jj + 2 * hh + 1] = v.y;
    }
  // phase 1: S_j to the workspace, then S_{j+1} = exp(cum_L) (S_j +
  // k_over^T . v)
  for (int c = 0; c < K; ++c) {
    const int st = c & 1;
    hp::mbar_wait(bar_pass1 + 8 * st, (c >> 1) & 1);
    hp::mbar_wait(bar_in1 + 8 * (c % kSlots), (c / kSlots) & 1);
    if (tid == 0 && c == 0) {
      for (int q = 2; q < K && q < kSlots; ++q) load1(q);
    }
    const float p0 = vec[kVP + 64 * st + r0 + g];
    const float p1 = vec[kVP + 64 * st + r0 + g + 8];
    // S_j's hi and lo tiles (D''s, free in phase 1) to the workspace
    hp::st_frag<true>(ds_h, ds_l, S);
    hp::fence_proxy_async();
    hp::bar_sync(kBarMma, kMmaThreads);
    if (tid == 0) {
      hp::bulk_store(states + static_cast<size_t>(c) * kStateBytes, ds_h,
                     kStateBytes);
      hp::tma_store_commit();
    }
    const uint64_t d_kh = desc_mn(base + kOffRd + st * 2 * kTile, 0);
    const uint64_t d_kl = desc_mn(base + kOffRd + st * 2 * kTile + kTile, 0);
    const uint64_t d_v = desc_mn(base + (c % kSlots) * kSlot + 2 * kTile, 0);
    hp::fence_regs(S);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hp::mma_ss_t<1, 1>(S, d_kh + 128 * kk, d_v + 128 * kk, 1);
      hp::mma_ss_t<1, 1>(S, d_kl + 128 * kk, d_v + 128 * kk, 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(S);
    if (tid == 0) hp::tma_store_wait_read();
    // every warp has read the chunk, and the images' tiles are free
    hp::bar_sync(kBarMma, kMmaThreads);
    if (tid == 0) {
      hp::mbar_arrive(bar_free1 + 8 * st);
      if (c + kSlots < K) load1(c + kSlots);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      S[4 * jj] *= p0;
      S[4 * jj + 1] *= p0;
      S[4 * jj + 2] *= p1;
      S[4 * jj + 3] *= p1;
    }
  }
  // phase 1's tiles are all read: phase 2's first two chunks in, the
  // images' bulk stores done before their bulk loads
  if (tid == 0) {
    hp::tma_store_wait_all();
    load2(0);
    if (K > 1) load2(1);
  }

  // dS' of the last chunk, and its L-step term sum_m S_K o dS'
  float dS[32];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float2 v = make_float2(0.0f, 0.0f);
      if (dstate_T != nullptr) {
        v = *reinterpret_cast<const float2*>(
            dstate_T + bh * 4096 + (r0 + g + 8 * hh) * 64 + 8 * jj + 2 * t);
      }
      dS[4 * jj + 2 * hh] = v.x;
      dS[4 * jj + 2 * hh + 1] = v.y;
    }
  {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      a0 = fmaf(S[4 * jj], dS[4 * jj], a0);
      a0 = fmaf(S[4 * jj + 1], dS[4 * jj + 1], a0);
      a1 = fmaf(S[4 * jj + 2], dS[4 * jj + 2], a1);
      a1 = fmaf(S[4 * jj + 3], dS[4 * jj + 3], a1);
    }
    a0 = tc::quad_sum(a0);
    a1 = tc::quad_sum(a1);
    if (t == 0) {
      vec[kVTail + 64 * ((K - 1) & 1) + r0 + g] = a0;
      vec[kVTail + 64 * ((K - 1) & 1) + r0 + g + 8] = a1;
    }
  }
  hp::bar_sync(kBarPhase, kThreads);   // phase 1 done

  float* h1 = reinterpret_cast<float*>(smem + kOffH);
  float* h2 = h1 + 64 * kHPitch;
  for (int i = 0; i < K; ++i) {
    const int j = K - 1 - i, st = i & 1;
    const uint32_t s = base + st * kStage;
    const unsigned char* sp = smem + st * kStage;
    hp::mbar_wait(bar_in2 + 8 * st, (i >> 1) & 1);
    // a. dscores = dout . v^T; dr_dec = dout . S_j^T (S_j as hi + lo);
    // b. dr_dec += dscores . k_over, handed off. Each product's registers
    // live in its own block.
    {
      float dsc[32], acc[32];
      uint32_t a[3][4][4];
      const uint64_t d_do = desc_k(s + kDo * kTile, 0);
      const uint64_t d_v = desc_k(s + kV * kTile, 0);
      const uint64_t d_sh = desc_k(s + kSh * kTile, 0);
      const uint64_t d_sl = desc_k(s + kSl * kTile, 0);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss(dsc, d_do + 2 * kk, d_v + 2 * kk, kk > 0);
      }
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss(acc, d_do + 2 * kk, d_sh + 2 * kk, kk > 0);
        hp::mma_ss(acc, d_do + 2 * kk, d_sl + 2 * kk, 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(dsc);
      // ddiag = dout . v of each row: dscores' diagonal
      mask_tri<true>(dsc, nullptr, vec + kVDd);
      split_frag<3>(dsc, a);
      // the last chunk's dv tile is read (its tile takes D' below)
      if (tid == 0) hp::tma_store_wait_read();
      hp::bar_sync(kBarPre, kThreads);   // r_dec, k_over and the vectors in
      hp::wgmma_fence();
      mma_rs3(acc, a, ko_h);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      st_frag_f32(h1, acc);
      __threadfence_block();
      hp::bar_arrive(kBarH1, kThreads);
    }
    // D' = exp(cum_L) dS' into its hi and lo tiles
    {
      const float p0 = vec[kVP + r0 + g], p1 = vec[kVP + r0 + g + 8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        dS[4 * jj] *= p0;
        dS[4 * jj + 1] *= p0;
        dS[4 * jj + 2] *= p1;
        dS[4 * jj + 3] *= p1;
      }
    }
    hp::st_frag<true>(ds_h, ds_l, dS);
    hp::fence_proxy_async();
    hp::bar_sync(kBarMma, kMmaThreads);   // D''s tiles in
    // c. dS' = D' + r_dec^T . dout, then the L-step term of chunk j - 1,
    // whose end state is S_j
    {
      const uint64_t d_rhT = desc_mn(rd_h, 0), d_rlT = desc_mn(rd_l, 0);
      const uint64_t d_doT = desc_mn(s + kDo * kTile, 0);
      hp::fence_regs(dS);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss_t<1, 1>(dS, d_rhT + 128 * kk, d_doT + 128 * kk, 1);
        hp::mma_ss_t<1, 1>(dS, d_rlT + 128 * kk, d_doT + 128 * kk, 1);
      }
      hp::wgmma_commit();
    }
    // d. dk_tot = v . D'^T + dscores^T . r_dec (dscores^T = v . dout^T,
    // masked strictly upper, split), handed off
    {
      float dsc[32], acc[32];
      uint32_t a[3][4][4];
      const uint64_t d_do = desc_k(s + kDo * kTile, 0);
      const uint64_t d_v = desc_k(s + kV * kTile, 0);
      const uint64_t d_dh = desc_k(ds_h, 0), d_dl = desc_k(ds_l, 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss(dsc, d_v + 2 * kk, d_do + 2 * kk, kk > 0);
      }
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss(acc, d_v + 2 * kk, d_dh + 2 * kk, kk > 0);
        hp::mma_ss(acc, d_v + 2 * kk, d_dl + 2 * kk, 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(dS);
      hp::fence_regs(dsc);
      if (j > 0) {
        // S_j's hi and lo by ldmatrix in dS''s fragment order: matrix m of
        // step q holds rows r0 + 8 (m & 1).., columns 8 (2 q + m / 2)..
        const unsigned char* sh = sp + kSh * kTile;
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t o = hp::sw(r0 + 8 * ((lane >> 3) & 1) + (lane & 7),
                                    8 * (2 * q + (lane >> 4)));
          uint32_t hv[4], lv[4];
          tc::ldsm_x4(hv, sh + o);
          tc::ldsm_x4(lv, sh + kTile + o);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int jj = 2 * q + (m >> 1);
            const float2 hs = tc::unpack_bf16(hv[m]);
            const float2 ls = tc::unpack_bf16(lv[m]);
            if (m & 1) {
              a1 = fmaf(hs.x + ls.x, dS[4 * jj + 2], a1);
              a1 = fmaf(hs.y + ls.y, dS[4 * jj + 3], a1);
            } else {
              a0 = fmaf(hs.x + ls.x, dS[4 * jj], a0);
              a0 = fmaf(hs.y + ls.y, dS[4 * jj + 1], a0);
            }
          }
        }
        a0 = tc::quad_sum(a0);
        a1 = tc::quad_sum(a1);
        if (t == 0) {
          vec[kVTail + 64 * ((j - 1) & 1) + r0 + g] = a0;
          vec[kVTail + 64 * ((j - 1) & 1) + r0 + g + 8] = a1;
        }
      }
      mask_tri<false>(dsc, nullptr);
      split_frag<3>(dsc, a);
      hp::wgmma_fence();
      mma_rs3(acc, a, rd_h);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      st_frag_f32(h2, acc);
      __threadfence_block();
      hp::bar_arrive(kBarH2, kThreads);
    }
    // e. dv = k_over . D' (= k_scaled . dS') + scores^T . dout, with
    // scores^T = k_over . r_dec^T masked strictly upper, the bonus on its
    // diagonal, split
    {
      float sc[32], acc[32];
      uint32_t a[2][4][4];
      const uint64_t d_kh = desc_k(ko_h, 0), d_kl = desc_k(ko_l, 0);
      const uint64_t d_rh = desc_k(rd_h, 0), d_rl = desc_k(rd_l, 0);
      const uint64_t d_dhT = desc_mn(ds_h, 0), d_dlT = desc_mn(ds_l, 0);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss(sc, d_kh + 2 * kk, d_rh + 2 * kk, kk > 0);
        hp::mma_ss(sc, d_kh + 2 * kk, d_rl + 2 * kk, 1);
        hp::mma_ss(sc, d_kl + 2 * kk, d_rh + 2 * kk, 1);
      }
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss_t<0, 1>(acc, d_kh + 2 * kk, d_dhT + 128 * kk, kk > 0);
        hp::mma_ss_t<0, 1>(acc, d_kh + 2 * kk, d_dlT + 128 * kk, 1);
        hp::mma_ss_t<0, 1>(acc, d_kl + 2 * kk, d_dhT + 128 * kk, 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(sc);
      mask_tri<false>(sc, vec + kVBonus);
      split_frag<2>(sc, a);
      const uint64_t d_doT = desc_mn(s + kDo * kTile, 0);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_rs(acc, a[0][kk], d_doT + 128 * kk, 1);
        hp::mma_rs(acc, a[1][kk], d_doT + 128 * kk, 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      // dv in bf16 to D''s hi tile, once every warp's products have read
      // it, then out by TMA
      hp::bar_sync(kBarMma, kMmaThreads);
      hp::st_frag<false>(ds_h, 0, acc);
      hp::fence_proxy_async();
    }
    hp::bar_sync(kBarEnd, kThreads);   // the chunk's stage and hand-offs read
    if (tid == 0) {
      hp::tma_store_4d(&tm_dv, ds_h, 0, h, 64 * j, b);
      hp::tma_store_commit();
      if (i + 2 < K) load2(i + 2);
    }
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(dstate0 + bh * 4096 +
                                 (r0 + g + 8 * hh) * 64 + 8 * jj + 2 * t) =
          make_float2(dS[4 * jj + 2 * hh], dS[4 * jj + 2 * hh + 1]);
  if (tid == 0) hp::tma_store_wait_read();
}

int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      wkv_bwd_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem)));
}

int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, const void* dout,
           const float* dstate_T, void* dr, void* dk, void* dv, void* dw,
           float* du, float* dstate0, void* work, float* du_part, int B,
           int T_len, int H, cudaStream_t stream) {
  int err = set_smem();
  if (err != 0) return err;
  CUtensorMap tm_r, tm_k, tm_v, tm_w, tm_do, tm_dv;
  if (!hp::encode_bshd(&tm_r, r, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_k, k, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_v, v, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_w, w, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_do, dout, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_dv, dv, B, T_len, H, 64, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wkv_bwd_wg_kernel<<<dim3(H, B), kThreads, kSmem, stream>>>(
      tm_r, tm_k, tm_v, tm_w, tm_do, tm_dv, u, state0, dstate_T,
      static_cast<bf16*>(dr), static_cast<bf16*>(dk), static_cast<bf16*>(dw),
      du_part, dstate0,
      static_cast<unsigned char*>(work), T_len, H);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  wkv_bwd_reduce_kernel<<<(H * 64 + 255) / 256, 256, 0, stream>>>(
      du_part, du, B, H, 64, 1);
  return static_cast<int>(cudaGetLastError());
}

// Whether the route takes the shape: N = chunk = 64, any number of chunks,
// and r, k, v, w, dout a TMA map can describe (16-byte aligned).
bool ok(const void* r, const void* k, const void* v, const void* w,
        const void* dout, int T_len, int N, int chunk) {
  return chunk == 64 && N == 64 && T_len % 64 == 0 && T_len >= 64 &&
         tc::aligned16(r) && tc::aligned16(k) && tc::aligned16(v) &&
         tc::aligned16(w) && tc::aligned16(dout);
}

}  // namespace wg

// Dispatch on N padded to 16, 32 or 64.
template <typename Fn>
int with_dim(int N, Fn&& fn) {
  if (N <= 16) return fn(std::integral_constant<int, 16>{});
  if (N <= 32) return fn(std::integral_constant<int, 32>{});
  if (N <= 64) return fn(std::integral_constant<int, 64>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw: (B, T, H, N), f32 (dtype 0: the
// CUDA-core scan) or bf16 (dtype 1: the mma.sync route; dtype 2: the
// wgmma route, which wg::ok must take); u, du: (H, N) f32; state0,
// dstate_T, dstate0: (B, H, N, N) f32 (dstate_T may be null: zeros).
// Workspaces: states (B * H * T/chunk * N * N f32; on the wgmma route the
// same bytes hold each chunk state's bf16 hi and lo tiles), du_part (B, H,
// N; on the mma.sync route B, H, T/chunk, N), and on the mma.sync route
// only dstates (as states; null on the others). All contiguous; `chunk`
// divides T. Launches the kernels on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int rwkv6_wkv_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const float* u, const float* state0, const void* dout,
    const float* dstate_T, void* dr, void* dk, void* dv, void* dw, float* du,
    float* dstate0, float* states, float* dstates, float* du_part, int B,
    int T_len, int H, int N, int chunk, int dtype, void* stream) {
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
    return with_dim(N, [&](auto d) {
      return launch_tc<decltype(d)::value>(
          r, k, v, w, u, state0, dout, dstate_T, dr, dk, dv, dw, du, dstate0,
          states, dstates, du_part, B, T_len, H, N, chunk, st);
    });
  }
  if (dtype == 2) {
    if (!wg::ok(r, k, v, w, dout, T_len, N, chunk)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return wg::launch(r, k, v, w, u, state0, dout, dstate_T, dr, dk, dv, dw,
                      du, dstate0, states, du_part, B, T_len, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The compiled kernel for `dtype` at (N, chunk): f32 its one scan kernel;
// bf16 on the mma.sync route kernel `part` (0 the chunk kernel, 1 the
// walk); dtype 2 the wgmma route's kernel (N = chunk = 64). info[0..5] as
// tc::kernel_info gives them (registers, static and dynamic shared memory,
// spill bytes, blocks an SM, threads a block). Returns a CUDA error code.
extern "C" int rwkv6_wkv_bwd_info(int N, int chunk, int dtype, int part,
                                  int* info) {
  if (N < 1 || N > kMaxN || chunk < 1 || chunk > kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    const size_t smem = smem_floats(chunk, N) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return tc::kernel_info(wkv_bwd_kernel<float>, kThreads, smem, info);
  }
  if (dtype == 1) {
    return with_dim(N, [&](auto d) {
      return info_tc<decltype(d)::value>(part, info);
    });
  }
  if (dtype == 2) {
    if (N != 64 || chunk != 64) return static_cast<int>(cudaErrorInvalidValue);
    const int err = wg::set_smem();
    if (err != 0) return err;
    return tc::kernel_info(wg::wkv_bwd_wg_kernel, wg::kThreads, wg::kSmem,
                           info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
