// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Per (batch b, head h), with a_t = dt_t * A_h and cum_t the inclusive sum
// of a over the chunk, for every chunk of c time steps:
//
//   y_t    = exp(cum_t) C_t . S + sum_{s<=t} (C_t . B_s) exp(min(cum_t - cum_s, 0)) dt_s x_s
//   S_next = exp(cum_last) S + sum_s exp(cum_last - cum_s) dt_s B_s x_s^T
//
// with the (N, P) state S carried from chunk to chunk, from state0, and
// written out at the end. Replaces the Pallas TPU kernel
// kernels/mamba2_ssd.py::ssd of the JAX package (body _ssd_kernel,
// pallas_call at :106). The TPU grid walks the chunks in order with the
// state in VMEM scratch; here one block owns one (b, h) and walks the chunks
// in a loop with the state in shared memory. B * H = 448 blocks at
// zamba2-7b's prefill shape fill the 132 SMs.
//
// Bound: at (B, T, H, P, G, N) = (4, 512, 112, 64, 1, 64) with bf16 x, B, C
// and f32 dt and states, the function moves about 75 MB (x and y 29 MB
// each, the two f32 states 7.3 MB each): about 22 us at 3.35 TB/s. Its work
// is about 7.5 GFLOP (four 64^3 products per chunk and head): 7.6 us on the
// bf16 tensor cores, 112 us in f32 on the CUDA cores. This kernel computes
// in f32 on the CUDA cores, one thread per output element with its inner
// sum read from shared memory, so its bound is the f32 rate and it does not
// reach it. Tensor-core tiles are later work.
//
// Design: 256 threads. Each chunk stages x (c x P), B and C (c x N) as f32
// in shared memory (odd row pitches), and dt. One thread per step builds the
// inclusive cumsum of dt * A in time order, then the c x c decay-masked
// score matrix, the readout y (inter-chunk part from the old state, intra-
// chunk part from the scores), and last the state update, each separated by
// a barrier. The B/C group of head h is h / (H / G): the kernel indexes it
// and never materialises the per-head repeat of the Pallas wrapper. The
// difference cum_t - cum_s is clamped at 0 before exp, as in the Pallas
// body: exact for s <= t, no overflow on the masked s > t entries. The
// chunk is the wrapper's: the largest c <= 64 that divides T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kMaxDim = 128;   // N and P

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ state0,
           T* __restrict__ y, float* __restrict__ state_out, int T_len,
           int H, int P, int G, int N, int c) {
  extern __shared__ float smem[];
  const int P1 = P + 1, N1 = N + 1, C1 = c + 1;
  float* st = smem;             // N x P1: the carried state
  float* xs = st + N * P1;      // c x P1
  float* bs = xs + c * P1;      // c x N1
  float* cs = bs + c * N1;      // c x N1
  float* sc = cs + c * N1;      // c x C1: decay-masked scores
  float* dts = sc + c * C1;     // c
  float* cum = dts + c;         // c
  float* ws = cum + c;          // c: exp(cum_last - cum_s) dt_s

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h];
  const size_t state_base = (static_cast<size_t>(b) * H + h) * N * P;

  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P;
    st[n * P1 + (i - n * P)] = state0[state_base + i];
  }

  for (int t0 = 0; t0 < T_len; t0 += c) {
    __syncthreads();  // the previous chunk's state update is done
    const size_t step0 = static_cast<size_t>(b) * T_len + t0;
    for (int i = tid; i < c * P; i += kThreads) {
      const int s = i / P;
      const int p = i - s * P;
      xs[s * P1 + p] = to_f32(x[((step0 + s) * H + h) * P + p]);
    }
    for (int i = tid; i < c * N; i += kThreads) {
      const int s = i / N;
      const int n = i - s * N;
      const size_t off = ((step0 + s) * G + g) * N + n;
      bs[s * N1 + n] = to_f32(Bm[off]);
      cs[s * N1 + n] = to_f32(Cm[off]);
    }
    if (tid < c) dts[tid] = dt[(step0 + tid) * H + h];
    __syncthreads();

    if (tid < c) {
      float acc = 0.0f;
      for (int s = 0; s <= tid; ++s) acc += dts[s] * a;
      cum[tid] = acc;
    }
    __syncthreads();

    if (tid < c) ws[tid] = expf(cum[c - 1] - cum[tid]) * dts[tid];
    for (int i = tid; i < c * c; i += kThreads) {
      const int t = i / c;
      const int s = i - t * c;
      float val = 0.0f;
      if (s <= t) {
        float dot = 0.0f;
        for (int n = 0; n < N; ++n) dot = fmaf(cs[t * N1 + n], bs[s * N1 + n], dot);
        val = dot * expf(fminf(cum[t] - cum[s], 0.0f)) * dts[s];
      }
      sc[t * C1 + s] = val;
    }
    __syncthreads();

    for (int i = tid; i < c * P; i += kThreads) {
      const int t = i / P;
      const int p = i - t * P;
      float inter = 0.0f;
      for (int n = 0; n < N; ++n) inter = fmaf(cs[t * N1 + n], st[n * P1 + p], inter);
      float intra = 0.0f;
      for (int s = 0; s <= t; ++s) intra = fmaf(sc[t * C1 + s], xs[s * P1 + p], intra);
      put(y + ((step0 + t) * H + h) * P + p, inter * expf(cum[t]) + intra);
    }
    __syncthreads();  // every read of the old state is done

    const float last = expf(cum[c - 1]);
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P;
      const int p = i - n * P;
      float acc = 0.0f;
      for (int s = 0; s < c; ++s) acc = fmaf(bs[s * N1 + n] * ws[s], xs[s * P1 + p], acc);
      st[n * P1 + p] = st[n * P1 + p] * last + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P;
    state_out[state_base + i] = st[n * P1 + (i - n * P)];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* state0, void* y, float* state_out,
           int B, int T_len, int H, int P, int G, int N, int c,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(N) * (P + 1) + c * (P + 1) +
                       2 * c * (N + 1) + c * (c + 1) + 3 * c);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), state0, static_cast<T*>(y), state_out,
      T_len, H, P, G, N, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (B, T, H, P); dt: (B, T, H) f32; A: (H,) f32; Bm, Cm: (B, T, G, N);
// state0, state_out: (B, H, N, P) f32; all contiguous. x, y, Bm and Cm are
// f32 (dtype 0) or bf16 (dtype 1). `chunk` divides T. Launches on `stream`
// and returns cudaGetLastError() (0 on success). The caller checks shapes,
// types and contiguity.
extern "C" int mamba2_ssd_launch(const void* x, const float* dt,
                                 const float* A, const void* Bm,
                                 const void* Cm, const float* state0, void* y,
                                 float* state_out, int B, int T_len, int H,
                                 int P, int G, int N, int chunk, int dtype,
                                 void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (P < 1 || P > kMaxDim || N < 1 || N > kMaxDim || G < 1 || H % G != 0 ||
      chunk < 1 || chunk > kMaxChunk || T_len % chunk != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, A, Bm, Cm, state0, y, state_out, B, T_len, H,
                         P, G, N, chunk, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, state0, y, state_out, B,
                                 T_len, H, P, G, N, chunk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
