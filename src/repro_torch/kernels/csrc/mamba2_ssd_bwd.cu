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
// The shape and dtype pick the route (mamba2_ssd.py::bwd_route): f32 the
// CUDA-core scan; bf16 at N = P = chunk = 64 with one B/C group, at most
// kClMaxChunks chunks and x, B, C, dy 16-byte aligned (zamba2's train
// path) the cluster route; every other bf16 input the mma.sync route.
//
// bf16 cluster route (ssd_bwd_cluster_kernel, then ssd_bwd_reduce_kernel):
// one thread block cluster per (batch, group of `heads` heads), a block of
// one warpgroup per chunk (K = T / 64 <= 8 blocks, a portable cluster),
// walking the group's heads in order. What the mma.sync route paid for,
// and what this one does instead:
//  (a) the walk wrote every chunk's start state S_k and end-state
//      gradient dS'_k to f32 workspaces (58.7 MB each at the train shape)
//      for the chunk kernel to read back. Here block k forms its chunk's
//      increments U = (B o w)^T x and V = (C o exp(cum))^T dy (wgmma, B o w
//      and C o exp(cum) as split A fragments from ldmatrix.trans) and the
//      states pass from block to block through distributed shared memory:
//      block k - 1 writes S_k into block k's chain buffer (st.async, 16 KB
//      completing on an mbarrier there) and block k sends on S_{k+1} =
//      exp(cum_L) S_k + U; dS' goes the other way from dstate_T (or zeros)
//      and block 0 writes dstate0. Each block passes a state on as soon as
//      it is in (the two walks meet in the middle), in a fixed order, so a
//      second call gives equal bits; state0 and dstate_T come into the end
//      blocks' chain buffers a head ahead (cp.async). No walk launch, no
//      state workspace; a chain buffer is free again (an arrival on the
//      sender's barrier) once the block is through the head.
//  (b) the chunk kernel wrote per-head f32 dB and dC (58.7 MB each) for
//      the sums to read back. Here a block adds its heads' dB and dC in
//      f32 registers (the wgmma accumulators), in head order, and writes
//      one partial sum a group: H / heads partials a row, summed in a
//      fixed order by the sums kernel (no atomics).
//  (c) every product ran as mma.sync with 2 blocks of 4 warps an SM. Here
//      every product is a wgmma m64n64k16 of the warpgroup: C.B^T and
//      dy.x^T from TMA tiles (128-byte swizzled boxes of x, dy, B, C);
//      S and dS' as bf16 hi + lo tiles; M and dG, formed in f32 in
//      registers, stored as hi + lo tiles in the chain buffers once the
//      states are through and read K-major (dG.B) or MN-major (M^T.dy,
//      dG^T.C: the transposed products need no second copy). Every f32
//      operand is still split into hi + lo, two products into one
//      accumulator (constraint C4). dt is H-strided, so no TMA box gathers
//      it: warp 0 loads it a head ahead. Q, its spanned sums and the
//      per-step vectors stay f32 on the CUDA cores.
// Workspace traffic at the train shape, counted from the shape: the
// groups' partial dB and dC written and read, 2 x 2 x 4 x 512 x 7 x 64 x
// 4 bytes, and dA's partials: 14.7 MB (the mma.sync route: 469.8 MB).
// Shared memory 103,184 bytes (eight 8 KB tiles, two 16 KB chain buffers,
// the vectors): 2 blocks an SM, 30 clusters of 8 on an H100; heads = 16
// (mamba2_ssd.py::cluster_heads) makes the train shape's 28 clusters one
// wave. 254 registers, no spill. Measured (tools/time_kernels.py --only
// ssd_bwd, in turns with the mma.sync route; NVIDIA H100 80GB HBM3,
// 700.00 W) at (4, 512, 112, 64, 1, 64): 0.2758-0.2771 ms a call against
// 0.3824-0.3832, busy 0.2666-0.2676 in the cluster kernel and 0.0054 in
// the sums; 8.8x the byte bound. What holds it there
// (tools/trace_ssd_chain.py): the states pass block to block in
// lockstep, 0.70 us a hop, 7 hops each way a head, and each block waits
// them out itself: 11,053 of a head's 24,352 cycles go to the chain, the
// tiles and the sum of S o dS'. Two ways around it were
// slower on the card: a hop as bulk copies, and waiting for dS' only
// before rows s while passing it on between the steps of rows t (the dS'
// walk then waits on those steps).
//
// bf16 mma.sync route (every other bf16 input; ssd_bwd_walk_kernel,
// ssd_bwd_chunk_kernel, ssd_bwd_reduce_kernel): the scan is a linear
// recurrence in the chunk state, so given a chunk's start state S and its
// end state's gradient dS' every term above is local to the chunk, the
// spanned dloga sums included. Three launches, one call:
//   1. the walk, a block per (b, h) and direction, 4 warps holding the
//      state in f32 registers (16 rows each): forwards it writes S_k and
//      adds (B o w)^T . x, backwards it writes dS'_k and adds (C o
//      exp(cum))^T . dy, each scaled by exp(cum_L) first; the next chunk's
//      tiles come by cp.async while the tensor cores work on this one;
//   2. the chunk kernel, a block per (chunk, h, b) (3,584 at the train
//      shape, where the scan had 448), 4 warps of 16 chunk rows: C.B^T and
//      dy.x^T, the elementwise M, dG, Q and the ddt column sums in f32, Q's
//      row prefixes by quad shuffle scans and their spanned column sums,
//      dC = exp(cum) S dy + dG.B (dG as A fragments from registers), then
//      (M and dG in shared memory, where S was) dx = M^T.dy + w dS'^T B and
//      dB = dG^T.C + w dS' x (ldmatrix.trans); warp 0 turns the vectors
//      into dloga, ddt and the chunk's part of dA by shuffle scans;
//   3. the fixed-order sums (dB and dC over the heads of a group, four
//      columns a thread; dA over batches and chunks), so a second call
//      gives equal bits; no atomics.
// Every product runs as mma.sync.m16n8k16, bf16 operands and f32 sums.
// C.B^T and dy.x^T take two bf16 inputs and are exact. Every f32 operand
// (B o w, C o exp(cum), S, dS', M and dG) is split into bf16 hi + lo (x =
// hi + lo to about 16 bits, two mma against a bf16 input): one rounding of
// each, as the forward does, takes dx, dB and dC past the 1e-2 gate
// against the plain version, and so does leaving any one of them rounded
// once (tests/test_torch_scan_bwd_rounding.py). Q, its spanned sums and
// the per-step vectors stay f32 on the CUDA cores (dA's cancellation, as
// above). N and P pad to kD = 16, 32, 64 or 128 with zeros in shared
// memory and the chunk to 64 rows, so the chunk is always the forward's.
// Workspaces beyond the bound: S_k and dS'_k (58.7 MB each at the train
// shape, written by the walk and read by the chunk kernel) and the
// per-head dB and dC (58.7 MB each, written and summed): 470 MB, 0.14 ms
// at 3.35 TB/s, 58.7 MB more memory than the f32 route. At kD = 64 the
// chunk kernel holds 96,000 bytes of shared memory and 184 registers (2
// blocks an SM), the walk 38,400 bytes and 160 registers (3 blocks), no
// spill. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W), bf16 at
// (4, 512, 112, 64, 1, 64), when it was the train shape's route:
// 0.3849 ms a call, 0.3442 CUPTI busy (by kernel, from another trace: walk
// 0.0957, chunk kernel 0.2600, sums 0.0545), 12x its byte bound; the first
// port's CUDA-core scan took 3.1984 ms there.
//
// f32 route (ssd_bwd_kernel, the first port's, unchanged, then
// ssd_bwd_reduce_kernel with one dA part a batch, which sums in the first
// port's order): it meets the f32 gradient tolerance (5e-4), which TF32
// products cannot. One block of 512 threads per (b, h), f32 arithmetic on
// the CUDA cores. The block first walks the chunks forward and writes the
// state at each chunk's start to a workspace (B x H x chunks x N x P f32,
// 58.7 MB at the train shape), then walks them backward with dS in shared
// memory: per chunk it stages x, dy, B, C, S as f32 (odd pitches), builds
// C.B^T and dy.x^T for s <= t and Q from them, sums Q's rows as prefixes
// and then its columns into the spanned sums, scales C.B^T and dy.x^T in
// place into M and dG, and writes dx and the per-head dB and dC; one
// thread then walks the chunk's vectors into dloga, ddt and dA. The
// per-head dB and dC and the per-batch dA partials go to workspaces, and
// the second kernel sums them in a fixed order (over the heads of a
// group, over batches). The chunk is the forward's unless the shared
// memory does not hold it (N and P near 128): then the largest divisor of
// T below it that fits, which gives the same gradient up to rounding
// (mamba2_ssd_bwd_chunk tells the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "scan_bwd.cuh"
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

// The sums over blocks, in a fixed order, four columns a thread (16-byte
// loads where N % 4 == 0, eight heads' in flight): dBm and dCm over the
// `terms` entries of each group in dBh and dCh (the heads of the group on
// the f32 and mma.sync routes, its head groups' partial sums on the
// cluster route), dA over batches and then over each batch's `parts` (1 on
// the f32 route, the chunks on the bf16 routes).
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dBh,
                                      const float* __restrict__ dCh,
                                      const float* __restrict__ dA_part,
                                      T* __restrict__ dBm, T* __restrict__ dCm,
                                      float* __restrict__ dA, int B,
                                      size_t rows, int H, int terms, int G,
                                      int N, int parts) {
  const int hpg = terms / G;
  const int nq = (N + 3) / 4;
  const bool vec = N % 4 == 0;
  const size_t total = rows * G * nq;   // rows = B * T
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int n = 4 * static_cast<int>(i % nq);
    const size_t g = (i / nq) % G;
    const size_t row = i / (static_cast<size_t>(nq) * G);
    const size_t base = (row * terms + g * hpg) * N;
    float4 sb = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sc = sb;
#pragma unroll 8
    for (int j = 0; j < hpg; ++j) {
      const size_t o = base + static_cast<size_t>(j) * N;
      const float4 a = scan::load4(dBh + o, n, N, vec);
      const float4 c = scan::load4(dCh + o, n, N, vec);
      sb = make_float4(sb.x + a.x, sb.y + a.y, sb.z + a.z, sb.w + a.w);
      sc = make_float4(sc.x + c.x, sc.y + c.y, sc.z + c.z, sc.w + c.w);
    }
    T* ob = dBm + (row * G + g) * N;
    T* oc = dCm + (row * G + g) * N;
    const float vb[4] = {sb.x, sb.y, sb.z, sb.w};
    const float vc[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (n + e < N) {
        st(ob + n + e, vb[e]);
        st(oc + n + e, vc[e]);
      }
    }
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.0f;
      for (int b = 0; b < B; ++b) {
        const float* p = dA_part + (static_cast<size_t>(b) * H + h) * parts;
        for (int k = 0; k < parts; ++k) s += p[k];
      }
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
                                       static_cast<T*>(dCm), dA, B, rows, H, H,
                                       G, N, 1);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int T_len, int H, int P, int G, int N, int chunk) {
  return P >= 1 && P <= kMaxDim && N >= 1 && N <= kMaxDim && G >= 1 &&
         H % G == 0 && chunk >= 1 && chunk <= kMaxChunk && T_len >= 1 &&
         T_len % chunk == 0;
}

// --------------------------------------------------------------------------
// bf16 route: tensor cores, the chunks in parallel
// --------------------------------------------------------------------------

constexpr int kRows = 64;             // chunk rows in shared memory
constexpr int kCPitch = kRows + 8;    // pitch of the c x c tiles
constexpr int kTcWarps = 4;           // the chunk kernel: 16 rows a warp
constexpr int kTcThreads = 32 * kTcWarps;

// kD: N and P padded to 16, 32, 64 or 128, with a pitch of kD + 8.
template <int kD>
__host__ __device__ constexpr int tc_pitch() { return kD + 8; }

// The walk kernel: 16 state rows a warp; two stages of the factor's (B or
// C) and the operand's (x or dy) tiles and of dt; each warp's row scales.
template <int kD>
__host__ __device__ constexpr int walk_threads() { return 32 * (kD / 16); }

template <int kD>
constexpr size_t walk_smem_bytes() {
  return sizeof(bf16) * 4 * kRows * tc_pitch<kD>() +
         sizeof(float) * (2 + kD / 16) * kRows;
}

// The chunk kernel: x, dy, B, C tiles, dS' (hi, lo), a union of S (hi, lo)
// and of M and dG (hi, lo each), then the chunk's f32 vectors: dt, cum,
// exp(cum), exp(cum_L - cum), the readout's exponent gradient, dW, the
// warps' column sums of the ddt products and of Q's spanned prefix sums,
// the rows' sums of S o dS'.
template <int kD>
__host__ __device__ constexpr int union_elems() {
  return 2 * kD * tc_pitch<kD>() > 4 * kRows * kCPitch
             ? 2 * kD * tc_pitch<kD>()
             : 4 * kRows * kCPitch;
}

template <int kD>
constexpr size_t chunk_smem_bytes() {
  return sizeof(bf16) * (4 * kRows * tc_pitch<kD>() + 2 * kD * tc_pitch<kD>() +
                         union_elems<kD>()) +
         sizeof(float) * (6 * kRows + 2 * kTcWarps * kRows + kD);
}

// Warp-wide: the inclusive cumsum of dt * a over the chunk, lane holding
// rows lane (c0) and lane + 32 (c1) of dts (zeros past the chunk), and the
// chunk's last (cl).
__device__ __forceinline__ void chunk_cum(const float* dts, float a, int c,
                                          int lane, float& c0, float& c1,
                                          float& cl) {
  c0 = dts[lane] * a;
  c1 = dts[lane + 32] * a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, c0, off);
    const float u1 = __shfl_up_sync(0xffffffffu, c1, off);
    if (lane >= off) {
      c0 += u0;
      c1 += u1;
    }
  }
  c1 += __shfl_sync(0xffffffffu, c0, 31);
  const float lo = __shfl_sync(0xffffffffu, c0, (c - 1) & 31);
  const float hi = __shfl_sync(0xffffffffu, c1, (c - 1) & 31);
  cl = c > 32 ? hi : lo;
}

// The chunk's x, dy (P columns) and B, C (N columns) into kRows-row tiles
// (zeros past the chunk and the widths), and dt into dts.
template <int kD, int kThreads>
__device__ __forceinline__ void load_chunk(
    bf16* xs, bf16* dys, bf16* bs, bf16* cs, float* dts,
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const float* __restrict__ dt, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, int b, int h, int T_len, int H, int P,
    int G, int N, int t0, int c, bool vec) {
  constexpr int kPitch = tc_pitch<kD>();
  const int grp = h / (H / G);
  const size_t x_stride = static_cast<size_t>(H) * P;
  const size_t bc_stride = static_cast<size_t>(G) * N;
  const size_t xo = (static_cast<size_t>(b) * T_len * H + h) * P;
  const size_t bo = (static_cast<size_t>(b) * T_len * G + grp) * N;
  tc::load_rows<kRows, kD, kPitch, kThreads>(xs, x + xo, x_stride, t0, t0 + c,
                                            P, vec);
  tc::load_rows<kRows, kD, kPitch, kThreads>(dys, dy + xo, x_stride, t0,
                                            t0 + c, P, vec);
  tc::load_rows<kRows, kD, kPitch, kThreads>(bs, Bm + bo, bc_stride, t0,
                                            t0 + c, N, vec);
  tc::load_rows<kRows, kD, kPitch, kThreads>(cs, Cm + bo, bc_stride, t0,
                                            t0 + c, N, vec);
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    dts[r] = r < c ? dt[(static_cast<size_t>(b) * T_len + t0 + r) * H + h]
                   : 0.0f;
  }
  tc::cp_async_commit();
}

// Kernel 1, per (h, b) and direction (blockIdx.z): the chunk states. Warp w
// holds rows 16 w.. of the state in f32 registers (C tiles) and walks the
// chunks, the next chunk's tiles copied by cp.async into the other stage
// while this one is used. blockIdx.z = 0 walks forwards from S_0 = state0,
// writing S_k into `states` and then S_{k+1} = exp(cum_L) S_k + (B o w)^T
// . x; blockIdx.z = 1 walks backwards from dS'_{K-1} = dstate_T (or 0),
// writing dS'_k into `dstates` and then dS'_{k-1} = exp(cum_L) dS'_k +
// (C o exp(cum))^T . dy, and last dstate0. The factors B o w and C o
// exp(cum) are split into bf16 hi + lo.
template <int kD>
__global__ void __launch_bounds__(walk_threads<kD>())
ssd_bwd_walk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                    const float* __restrict__ state0,
                    const float* __restrict__ dstate_T,
                    float* __restrict__ states, float* __restrict__ dstates,
                    float* __restrict__ dstate0, int T_len, int H, int P,
                    int G, int N, int c, bool vec) {
  constexpr int kThreads = walk_threads<kD>();
  constexpr int kPitch = tc_pitch<kD>();
  constexpr int kTile = kRows * kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);   // stage: factor, operand
  float* dts = reinterpret_cast<float*>(tiles + 4 * kTile);   // 2 x kRows
  float* scale = dts + 2 * kRows;                             // warps x kRows

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool grad = blockIdx.z == 1;
  const int n0 = 16 * warp;
  const int grp = h / (H / G);
  const float a = A[h];
  const int n_chunks = T_len / c;
  const size_t x_stride = static_cast<size_t>(H) * P;
  const size_t bc_stride = static_cast<size_t>(G) * N;
  const bf16* fac = (grad ? Cm : Bm) +
                    (static_cast<size_t>(b) * T_len * G + grp) * N;
  const bf16* opd = (grad ? dy : x) +
                    (static_cast<size_t>(b) * T_len * H + h) * P;
  const float* dtb = dt + static_cast<size_t>(b) * T_len * H + h;
  const size_t NP = static_cast<size_t>(N) * P;
  const size_t bh = static_cast<size_t>(b) * H + h;
  float* out = (grad ? dstates : states) + bh * n_chunks * NP;

  auto load = [&](int k, int st) {
    const int t0 = k * c;
    tc::load_rows<kRows, kD, kPitch, kThreads>(tiles + 2 * st * kTile, fac,
                                              bc_stride, t0, t0 + c, N, vec);
    tc::load_rows<kRows, kD, kPitch, kThreads>(tiles + (2 * st + 1) * kTile,
                                              opd, x_stride, t0, t0 + c, P,
                                              vec);
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const bool ok = r < c;
      tc::cp_async4(dts + st * kRows + r,
                    ok ? dtb + static_cast<size_t>(t0 + r) * H : dtb,
                    ok ? 4 : 0);
    }
    tc::cp_async_commit();
  };

  // the state's rows n0 + g and n0 + g + 8, all kD columns
  float sacc[kD / 8][4];
  const float* init = grad ? dstate_T : state0;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + 8 * (e >> 1);
      const int p = 8 * j + 2 * t + (e & 1);
      sacc[j][e] = init != nullptr && n < N && p < P
                       ? init[bh * NP + static_cast<size_t>(n) * P + p]
                       : 0.0f;
    }
  }
  auto store_state = [&](float* dst) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + g + 8 * r;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        scan::store_pair(dst + static_cast<size_t>(n) * P, 8 * j + 2 * t, P,
                         sacc[j][2 * r], sacc[j][2 * r + 1]);
      }
    }
  };

  load(grad ? n_chunks - 1 : 0, 0);
  for (int i = 0; i < n_chunks; ++i) {
    const int k = grad ? n_chunks - 1 - i : i;
    const int st = i & 1;
    if (i + 1 < n_chunks) {
      load(grad ? k - 1 : k + 1, st ^ 1);
      tc::cp_async_wait<1>();   // chunk k has landed, the next in flight
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* fs = tiles + 2 * st * kTile;
    const bf16* os = tiles + (2 * st + 1) * kTile;
    // this warp's row scales: exp(cum_L - cum_s) dt_s (forward) or
    // exp(cum_t) (backward)
    float c0, c1, cl;
    chunk_cum(dts + st * kRows, a, c, lane, c0, c1, cl);
    float* sc = scale + warp * kRows;
    if (grad) {
      sc[lane] = expf(c0);
      sc[lane + 32] = expf(c1);
    } else {
      sc[lane] = expf(cl - c0) * dts[st * kRows + lane];
      sc[lane + 32] = expf(cl - c1) * dts[st * kRows + lane + 32];
    }
    __syncwarp();
    store_state(out + static_cast<size_t>(k) * NP);
    const float e = expf(cl);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) sacc[j][q] *= e;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      if (kk * 16 >= c) break;
      uint32_t af[4], hi[4], lo[4];
      tc::lda_t(af, fs, kPitch, n0, kk * 16);
      const float w0 = sc[kk * 16 + 2 * t];
      const float w1 = sc[kk * 16 + 2 * t + 1];
      const float w2 = sc[kk * 16 + 8 + 2 * t];
      const float w3 = sc[kk * 16 + 9 + 2 * t];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = tc::unpack_bf16(af[q]);
        tc::split_bf16(f.x * (q < 2 ? w0 : w2), f.y * (q < 2 ? w1 : w3),
                       hi[q], lo[q]);
      }
      uint32_t bv[kD / 16][4];
#pragma unroll
      for (int j = 0; j < kD / 16; ++j) tc::ldb_t(bv[j], os, kPitch, j * 16, kk * 16);
      tc::mma_pairs<kD / 16>(sacc, hi, bv);
      tc::mma_pairs<kD / 16>(sacc, lo, bv);
    }
    __syncthreads();   // the stage is read: the next load may take it
  }
  if (grad) store_state(dstate0 + bh * NP);
}

// Kernel 2, per (chunk k, h, b), 4 warps, warp w owning chunk rows
// 16 w..16 w + 15: the chunk's gradient from its start state S and its end
// state's gradient dS' (both f32 from kernel 1, split into bf16 hi + lo).
// dx, the head's dB and dC (f32, summed by kernel 3), ddt and the chunk's
// part of dA.
template <int kD>
__global__ void __launch_bounds__(kTcThreads)
ssd_bwd_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ dstates, bf16* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dBh,
                     float* __restrict__ dCh, float* __restrict__ dA_part,
                     int T_len, int H, int P, int G, int N, int c, bool vec) {
  constexpr int kPitch = tc_pitch<kD>();
  constexpr int kTile = kRows * kPitch;
  constexpr int kSteps = kD / 16;             // k steps over N or P
  constexpr int kOut = kD < 64 ? kD : 64;     // output columns a pass
  constexpr int kNT = kOut / 8;
  constexpr int kCTile = kRows * kCPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dys = xs + kTile;
  bf16* bs = dys + kTile;
  bf16* cs = bs + kTile;
  bf16* ds_hi = cs + kTile;                   // dS', rows n, columns p
  bf16* ds_lo = ds_hi + kD * kPitch;
  bf16* un = ds_lo + kD * kPitch;
  bf16* s_hi = un;                            // S, until barrier (3)
  bf16* s_lo = un + kD * kPitch;
  bf16* m_hi = un;                            // then M and dG, rows t,
  bf16* m_lo = m_hi + kCTile;                 // columns s
  bf16* g_hi = m_lo + kCTile;
  bf16* g_lo = g_hi + kCTile;
  float* dts = reinterpret_cast<float*>(un + union_elems<kD>());
  float* cum = dts + kRows;
  float* ecum = cum + kRows;                  // exp(cum_t)
  float* dec = ecum + kRows;                  // exp(cum_L - cum_s)
  float* inter = dec + kRows;                 // exp(cum_t) C_t . S dy_t
  float* dws = inter + kRows;                 // B_s^T dS' x_s
  float* cole = dws + kRows;                  // warps x kRows
  float* span = cole + kTcWarps * kRows;      // warps x kRows
  float* rowsum = span + kTcWarps * kRows;    // kD: sum_p S o dS'

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int t0 = k * c;
  const float a = A[h];
  const int r0 = 16 * warp;
  load_chunk<kD, kTcThreads>(xs, dys, bs, cs, dts, x, dy, dt, Bm, Cm, b, h,
                             T_len, H, P, G, N, t0, c, vec);

  // S and dS' into their hi and lo copies (zeros past N and P), and the
  // rows' sums of S o dS'
  {
    const size_t base =
        ((static_cast<size_t>(b) * H + h) * n_chunks + k) * N * P;
    scan::load_states<kD, kTcThreads>(states + base, dstates + base, N, P,
                                      s_hi, s_lo, ds_hi, ds_lo, rowsum);
  }
  tc::cp_async_wait<0>();
  __syncthreads();   // (1) the chunk and the states are in

  if (warp == 0) {
    float c0, c1, cl;
    chunk_cum(dts, a, c, lane, c0, c1, cl);
    cum[lane] = c0;
    cum[lane + 32] = c1;
    ecum[lane] = expf(c0);
    ecum[lane + 32] = expf(c1);
    dec[lane] = expf(cl - c0);
    dec[lane + 32] = expf(cl - c1);
  }
  __syncthreads();   // (2) the chunk's vectors

  // G = C.B^T and dM = dy.x^T on this warp's rows t, column tiles s <= r0
  // + 15 (the rest is masked): both operands bf16 inputs, exact products
  float gm[8][4], dm[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gm[j][e] = dm[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    uint32_t ca[4], ya[4];
    tc::lda(ca, cs, kPitch, r0, kk * 16);
    tc::lda(ya, dys, kPitch, r0, kk * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j > warp) continue;
      uint32_t bb[4], xb[4];
      tc::ldb(bb, bs, kPitch, j * 16, kk * 16);
      tc::ldb(xb, xs, kPitch, j * 16, kk * 16);
      tc::mma_bf16(gm[2 * j], ca, bb[0], bb[1]);
      tc::mma_bf16(gm[2 * j + 1], ca, bb[2], bb[3]);
      tc::mma_bf16(dm[2 * j], ya, xb[0], xb[1]);
      tc::mma_bf16(dm[2 * j + 1], ya, xb[2], xb[3]);
    }
  }
  // D = exp(min(cum_t - cum_s, 0)) at s <= t: M = G o D o dt_s and dG =
  // dM o D o dt_s in place; the ddt products dM o G o D summed down the
  // columns; Q = dM o M at s < t where the clamp passes the difference
  float q[8][4];
  {
    float col[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      col[j][0] = col[j][1] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = r0 + g + 8 * (e >> 1);
        const int ss = 8 * j + 2 * t + (e & 1);
        const float diff = cum[tt] - cum[ss];
        const float d = ss <= tt ? expf(fminf(diff, 0.0f)) : 0.0f;
        const float gv = gm[j][e];
        const float dv = dm[j][e];
        const float mv = gv * d * dts[ss];
        col[j][e & 1] += dv * gv * d;
        q[j][e] = ss < tt && diff <= 0.0f ? dv * mv : 0.0f;
        gm[j][e] = mv;
        dm[j][e] = dv * d * dts[ss];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = tc::column_sum(col[j][i]);
        if (g == 0) cole[warp * kRows + 8 * j + 2 * t + i] = v;
      }
    }
  }
  // each row of Q to its exclusive prefix sums U[t, j] = sum_{s<j} Q[t, s]
  // (a scan over the quad, tile by tile), and U summed down the columns
  // at t >= j: the Q[t, s] whose exponent spans a_j
  {
    float run[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float col[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float qa = q[j][2 * r];
        const float qb = q[j][2 * r + 1];
        float inc = qa + qb;
        float y = __shfl_up_sync(0xffffffffu, inc, 1, 4);
        if (t >= 1) inc += y;
        y = __shfl_up_sync(0xffffffffu, inc, 2, 4);
        if (t >= 2) inc += y;
        float ex = __shfl_up_sync(0xffffffffu, inc, 1, 4);
        if (t == 0) ex = 0.0f;
        const float ua = run[r] + ex;
        const float ub = ua + qa;
        const int tt = r0 + g + 8 * r;
        const int s0 = 8 * j + 2 * t;
        col[0] += s0 <= tt ? ua : 0.0f;
        col[1] += s0 + 1 <= tt ? ub : 0.0f;
        run[r] += __shfl_sync(0xffffffffu, inc, 3, 4);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = tc::column_sum(col[i]);
        if (g == 0) span[warp * kRows + 8 * j + 2 * t + i] = v;
      }
    }
  }

  // dC_t = exp(cum_t) S dy_t + sum_s dG[t, s] B_s, per block of output
  // columns: S dy_t with S's hi and lo as B operands, dG from registers
  // (hi and lo A fragments, k steps s <= r0 + 15); the readout's exponent
  // gradient exp(cum_t) C_t . S dy_t on the way
  uint32_t gh[4][4], gl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) tc::c_to_a_split(dm[2 * kk], dm[2 * kk + 1], gh[kk], gl[kk]);
  const size_t row0 = static_cast<size_t>(b) * T_len + t0;
  {
    float ip[2] = {0.0f, 0.0f};
    const float e0 = ecum[r0 + g];
    const float e1 = ecum[r0 + g + 8];
#pragma unroll
    for (int n0 = 0; n0 < kD; n0 += kOut) {
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t ya[4], bh[kNT / 2][4], bl[kNT / 2][4];
        tc::lda(ya, dys, kPitch, r0, kk * 16);
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          tc::ldb(bh[j], s_hi, kPitch, n0 + 16 * j, kk * 16);
          tc::ldb(bl[j], s_lo, kPitch, n0 + 16 * j, kk * 16);
        }
        tc::mma_pairs<kNT / 2>(acc, ya, bh);
        tc::mma_pairs<kNT / 2>(acc, ya, bl);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        const float2 c0 = tc::ld_bf16x2(cs + (r0 + g) * kPitch + n);
        const float2 c1 = tc::ld_bf16x2(cs + (r0 + g + 8) * kPitch + n);
        ip[0] = fmaf(c0.x, acc[j][0], fmaf(c0.y, acc[j][1], ip[0]));
        ip[1] = fmaf(c1.x, acc[j][2], fmaf(c1.y, acc[j][3], ip[1]));
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > warp) continue;
        uint32_t bv[kNT / 2][4];
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) tc::ldb_t(bv[j], bs, kPitch, n0 + 16 * j, kk * 16);
        tc::mma_pairs<kNT / 2>(acc, gh[kk], bv);
        tc::mma_pairs<kNT / 2>(acc, gl[kk], bv);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tt = r0 + g + 8 * r;
        if (tt >= c) continue;
        float* dst = dCh + ((row0 + tt) * H + h) * N;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          scan::store_pair(dst, n0 + 8 * j + 2 * t, N, acc[j][2 * r],
                           acc[j][2 * r + 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = tc::quad_sum(ip[r]);
      if (t == 0) inter[r0 + g + 8 * r] = ecum[r0 + g + 8 * r] * v;
    }
  }
  __syncthreads();   // (3) every read of S is done: M and dG take its place
  tc::store_split<8>(gm, m_hi, m_lo, kCPitch, r0);
  tc::store_split<8>(dm, g_hi, g_lo, kCPitch, r0);
  __syncthreads();   // (4) M and dG are in

  // this warp's rows s: dx_s = w_s dS'^T B_s + sum_t M[t, s] dy_t and
  // dB_s = w_s dS' x_s + sum_t dG[t, s] C_t (M^T and dG^T through
  // ldmatrix.trans, k steps t >= r0); dW_s = B_s . dS' x_s
  {
    const float w0 = dec[r0 + g] * dts[r0 + g];
    const float w1 = dec[r0 + g + 8] * dts[r0 + g + 8];
#pragma unroll
    for (int n0 = 0; n0 < kD; n0 += kOut) {
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t ba[4], bh[kNT / 2][4], bl[kNT / 2][4];
        tc::lda(ba, bs, kPitch, r0, kk * 16);
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          tc::ldb_t(bh[j], ds_hi, kPitch, n0 + 16 * j, kk * 16);
          tc::ldb_t(bl[j], ds_lo, kPitch, n0 + 16 * j, kk * 16);
        }
        tc::mma_pairs<kNT / 2>(acc, ba, bh);
        tc::mma_pairs<kNT / 2>(acc, ba, bl);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        acc[j][0] *= w0;
        acc[j][1] *= w0;
        acc[j][2] *= w1;
        acc[j][3] *= w1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < warp || kk * 16 >= c) continue;
        uint32_t mh[4], ml[4], bv[kNT / 2][4];
        tc::lda_t(mh, m_hi, kCPitch, r0, kk * 16);
        tc::lda_t(ml, m_lo, kCPitch, r0, kk * 16);
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) tc::ldb_t(bv[j], dys, kPitch, n0 + 16 * j, kk * 16);
        tc::mma_pairs<kNT / 2>(acc, mh, bv);
        tc::mma_pairs<kNT / 2>(acc, ml, bv);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ss = r0 + g + 8 * r;
        if (ss >= c) continue;
        bf16* dst = dx + ((row0 + ss) * H + h) * P;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int p = n0 + 8 * j + 2 * t;
          const float v0 = acc[j][2 * r];
          const float v1 = acc[j][2 * r + 1];
          if ((P & 1) == 0) {
            if (p < P) {
              *reinterpret_cast<uint32_t*>(dst + p) = tc::pack_bf16(v0, v1);
            }
          } else {
            if (p < P) dst[p] = __float2bfloat16_rn(v0);
            if (p + 1 < P) dst[p + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    float wp[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n0 = 0; n0 < kD; n0 += kOut) {
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t xa[4], bh[kNT / 2][4], bl[kNT / 2][4];
        tc::lda(xa, xs, kPitch, r0, kk * 16);
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          tc::ldb(bh[j], ds_hi, kPitch, n0 + 16 * j, kk * 16);
          tc::ldb(bl[j], ds_lo, kPitch, n0 + 16 * j, kk * 16);
        }
        tc::mma_pairs<kNT / 2>(acc, xa, bh);
        tc::mma_pairs<kNT / 2>(acc, xa, bl);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        const float2 b0 = tc::ld_bf16x2(bs + (r0 + g) * kPitch + n);
        const float2 b1 = tc::ld_bf16x2(bs + (r0 + g + 8) * kPitch + n);
        wp[0] = fmaf(b0.x, acc[j][0], fmaf(b0.y, acc[j][1], wp[0]));
        wp[1] = fmaf(b1.x, acc[j][2], fmaf(b1.y, acc[j][3], wp[1]));
        acc[j][0] *= w0;
        acc[j][1] *= w0;
        acc[j][2] *= w1;
        acc[j][3] *= w1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < warp || kk * 16 >= c) continue;
        uint32_t gah[4], gal[4], bv[kNT / 2][4];
        tc::lda_t(gah, g_hi, kCPitch, r0, kk * 16);
        tc::lda_t(gal, g_lo, kCPitch, r0, kk * 16);
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) tc::ldb_t(bv[j], cs, kPitch, n0 + 16 * j, kk * 16);
        tc::mma_pairs<kNT / 2>(acc, gah, bv);
        tc::mma_pairs<kNT / 2>(acc, gal, bv);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ss = r0 + g + 8 * r;
        if (ss >= c) continue;
        float* dst = dBh + ((row0 + ss) * H + h) * N;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          scan::store_pair(dst, n0 + 8 * j + 2 * t, N, acc[j][2 * r],
                           acc[j][2 * r + 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = tc::quad_sum(wp[r]);
      if (t == 0) dws[r0 + g + 8 * r] = v;
    }
  }
  __syncthreads();   // (5) the chunk's vectors are in

  // warp 0, lane holding rows j = lane and lane + 32: dloga_j = the
  // spanned Q + the readouts at t >= j (a suffix scan) + w_s's exponents at
  // s < j (a prefix scan) + exp(cum_L) sum S o dS'; then ddt and dA's part
  if (warp == 0) {
    float ssd = 0.0f;
    for (int n = lane; n < kD; n += 32) ssd += rowsum[n];
    const float tail = ecum[c - 1] * tc::warp_sum(ssd);
    float i0 = dws[lane] * dec[lane] * dts[lane];
    float i1 = dws[lane + 32] * dec[lane + 32] * dts[lane + 32];
    float s0 = inter[63 - lane];
    float s1 = inter[31 - lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y0 = __shfl_up_sync(0xffffffffu, i0, off);
      const float y1 = __shfl_up_sync(0xffffffffu, i1, off);
      const float z0 = __shfl_up_sync(0xffffffffu, s0, off);
      const float z1 = __shfl_up_sync(0xffffffffu, s1, off);
      if (lane >= off) {
        i0 += y0;
        i1 += y1;
        s0 += z0;
        s1 += z1;
      }
    }
    const float tot = __shfl_sync(0xffffffffu, i0, 31);
    float e0 = __shfl_up_sync(0xffffffffu, i0, 1);
    float e1 = __shfl_up_sync(0xffffffffu, i1, 1);
    if (lane == 0) e0 = e1 = 0.0f;
    e1 += tot;
    s1 += __shfl_sync(0xffffffffu, s0, 31);
    const float suf0 = __shfl_sync(0xffffffffu, s1, 31 - lane);
    const float suf1 = __shfl_sync(0xffffffffu, s0, 31 - lane);
    float dA_acc = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = lane + 32 * r;
      float sp = 0.0f, ce = 0.0f;
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w) {
        sp += span[w * kRows + j];
        ce += cole[w * kRows + j];
      }
      const float dloga = sp + (r ? e1 : e0) + tail + (r ? suf1 : suf0);
      if (j < c) {
        ddt[(row0 + j) * H + h] = ce + dec[j] * dws[j] + a * dloga;
      }
      dA_acc = fmaf(dts[j], dloga, dA_acc);
    }
    dA_acc = tc::warp_sum(dA_acc);
    if (lane == 0) {
      dA_part[(static_cast<size_t>(b) * H + h) * n_chunks + k] = dA_acc;
    }
  }
}

template <int kD>
int set_smem_tc() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_walk_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(walk_smem_bytes<kD>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(chunk_smem_bytes<kD>())));
}

template <int kD>
int launch_tc(const void* x, const float* dt, const float* A, const void* Bm,
              const void* Cm, const float* state0, const void* dy,
              const float* dstate_T, void* dx, float* ddt, float* dA,
              void* dBm, void* dCm, float* dstate0, float* states,
              float* dstates, float* dBh, float* dCh, float* dA_part, int B,
              int T_len, int H, int P, int G, int N, int c,
              cudaStream_t stream) {
  int err = set_smem_tc<kD>();
  if (err != 0) return err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(Bm);
  const bf16* cb = static_cast<const bf16*>(Cm);
  const bf16* yb = static_cast<const bf16*>(dy);
  const bool vec = P % 8 == 0 && N % 8 == 0 && tc::aligned16(x) &&
                   tc::aligned16(dy) && tc::aligned16(Bm) && tc::aligned16(Cm);
  const int n_chunks = T_len / c;
  ssd_bwd_walk_kernel<kD><<<dim3(H, B, 2), walk_threads<kD>(),
                            walk_smem_bytes<kD>(), stream>>>(
      xb, dt, A, bb, cb, yb, state0, dstate_T, states, dstates, dstate0, T_len,
      H, P, G, N, c, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid(n_chunks, H, B);
  ssd_bwd_chunk_kernel<kD><<<grid, kTcThreads, chunk_smem_bytes<kD>(),
                             stream>>>(xb, dt, A, bb, cb, yb, states, dstates,
                                       static_cast<bf16*>(dx), ddt, dBh, dCh,
                                       dA_part, T_len, H, P, G, N, c, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t quads = static_cast<size_t>(B) * T_len * G * ((N + 3) / 4);
  const size_t blocks = (quads + 255) / 256;
  ssd_bwd_reduce_kernel<bf16><<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                                  : 4096),
                              256, 0, stream>>>(
      dBh, dCh, dA_part, static_cast<bf16*>(dBm), static_cast<bf16*>(dCm), dA,
      B, static_cast<size_t>(B) * T_len, H, H, G, N, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Kernel `part` of the bf16 route (0 the chunk kernel, 1 the walk).
template <int kD>
int info_tc(int part, int* info) {
  const int err = set_smem_tc<kD>();
  if (err != 0) return err;
  if (part == 1) {
    return tc::kernel_info(ssd_bwd_walk_kernel<kD>, walk_threads<kD>(),
                           walk_smem_bytes<kD>(), info);
  }
  return tc::kernel_info(ssd_bwd_chunk_kernel<kD>, kTcThreads,
                         chunk_smem_bytes<kD>(), info);
}

// --------------------------------------------------------------------------
// bf16 cluster route on Hopper: a thread block cluster over the chunks of
// a (b, head group), TMA tiles and wgmma (N = P = chunk = 64, G = 1, at
// most kClMaxChunks chunks)
// --------------------------------------------------------------------------

using hp::desc_k;
using hp::desc_mn;
using hp::kSwTile;
using hp::lda_t_sw;
using hp::sw;
using hp::zero;

constexpr int kClThreads = 128;                  // one warpgroup
constexpr int kClMaxChunks = 8;                  // a portable cluster
constexpr int kFragBytes = kClThreads * 32 * 4;  // a 64 x 64 f32 fragment

// Shared memory from a 1024-byte aligned base: eight swizzled tiles (B and
// C of the block's chunk, loaded once; x and dy of the head; S hi and lo,
// dS' hi and lo), the chain buffers into which the neighbours write S and
// dS' (f32, fragment order), then the head's vectors.
constexpr int kTB = 0, kTC = 1, kTX = 2, kTDy = 3, kTSh = 4, kTSl = 5,
              kTDh = 6, kTDl = 7;
constexpr int kSIn = 8 * kSwTile;
constexpr int kDIn = kSIn + kFragBytes;
constexpr int kVec = kDIn + kFragBytes;
// once a head's chain is through, the chain buffers hold its M and dG
// (hi and lo tiles, rows t, columns s)
constexpr int kTMh = 8, kTMl = 9, kTGh = 10, kTGl = 11;
static_assert(kSIn == kTMh * kSwTile && kDIn == kTGh * kSwTile,
              "the chain buffers are two tiles each");
// a wait for a barrier suspends its thread up to this long (ns) at a time
constexpr uint32_t kSuspendNs = 200;
// dts, cum, exp(cum), exp(cum_L - cum), w = exp(cum_L - cum) dt, the
// readout's exponent gradient, dW (64 each); the warps' column sums of the
// ddt products and of Q's spanned prefix sums (4 x 64 each); the warps'
// sums of S o dS' (4)
constexpr int kVecFloats = 7 * 64 + 2 * 4 * 64 + 4;
constexpr size_t kClSmem = 1024 + kVec + sizeof(float) * kVecFloats;


// Waits for phase `parity` of a barrier of the cluster kernel (acquire at
// cluster scope), the thread suspended kSuspendNs at a time. A phase that
// has not come after 2^22 such waits (seconds) traps: a launch error
// rather than a card that never finishes.
__device__ __forceinline__ void wait_phase(uint32_t bar, int parity) {
  for (uint32_t n = 0; !hp::mbar_try_cluster(bar, parity, kSuspendNs);
       ++n) {
    if (n == (1u << 22)) __trap();
  }
}

// Fragments: d[4 j + e] of a warpgroup's 64 x 64 D is row 16 w + g + 8 (e
// / 2), column 8 j + 2 t + (e % 2).

// Fragments to a row-major 64 x 64 f32 matrix in global memory.
__device__ __forceinline__ void frag_store(float* __restrict__ m,
                                           const float (&r)[32]) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(m + (row + 8 * h) * 64 + 8 * j + col) =
          make_float2(r[4 * j + 2 * h], r[4 * j + 2 * h + 1]);
    }
}

// This thread's elements of a row-major 64 x 64 f32 matrix in global
// memory into its slots of a fragment-ordered buffer (as the chain writes
// it) at shared address `buf`, by cp.async (8 bytes a copy; the thread
// waits for its own copies before it reads them).
__device__ __forceinline__ void frag_prefetch(uint32_t buf,
                                              const float* __restrict__ m) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t dst = buf + 16 * (q * kClThreads + threadIdx.x) + 8 * h;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   :: "r"(dst), "l"(m + (row + 8 * h) * 64 + 8 * q + col)
                   : "memory");
    }
  tc::cp_async_commit();
}

// One cluster per (batch b, group of `heads` heads): block k (its rank)
// owns chunk k and walks the group's heads in order. Per head it forms the
// chunk's increments U = (B o w)^T x and V = (C o exp(cum))^T dy, takes
// its start state S_k from block k - 1 (state0 at k = 0) and its end
// state's gradient dS'_k from block k + 1 (dstate_T at the last chunk),
// hands S_{k+1} = exp(cum_L) S_k + U on to block k + 1 and dS'_{k-1} =
// exp(cum_L) dS'_k + V to block k - 1 (dstate0 from block 0), then forms
// the chunk's gradient. dB and dC of the group's heads add up in f32
// registers, in head order, and are written once, as the group's partial
// sums. Maps: x, dy as (P, H, T, B) and Bm, Cm as (N, G, T, B) of bf16,
// 128-byte swizzled boxes of 64 columns x 64 rows.
__global__ void __launch_bounds__(kClThreads, 2)
ssd_bwd_cluster_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_dy,
                       const __grid_constant__ CUtensorMap tm_b,
                       const __grid_constant__ CUtensorMap tm_c,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ state0,
                       const float* __restrict__ dstate_T,
                       bf16* __restrict__ dx, float* __restrict__ ddt,
                       float* __restrict__ dBp, float* __restrict__ dCp,
                       float* __restrict__ dA_part,
                       float* __restrict__ dstate0, int T_len, int H,
                       int heads) {
  // barriers: B and C in; x and dy in; S and dS' in (written by the
  // neighbours); the chain buffers free again (in the neighbours, which
  // this block may then write)
  __shared__ __align__(8) uint64_t bars[6];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t base = hp::smem_u32(smem);
  auto tile = [&](int i) { return base + i * kSwTile; };
  float* vec = reinterpret_cast<float*>(smem + kVec);
  float* dts = vec;
  float* cum = vec + 64;
  float* ecum = vec + 128;
  float* dec = vec + 192;
  float* wv = vec + 256;
  float* inter = vec + 320;
  float* dws = vec + 384;
  float* cole = vec + 448;   // warps x 64
  float* span = cole + 256;  // warps x 64
  float* part = span + 256;  // warps
  const uint32_t bar0 = hp::smem_u32(bars);
  const uint32_t bc_full = bar0, xy_full = bar0 + 8, s_full = bar0 + 16,
                 d_full = bar0 + 24, s_empty = bar0 + 32,
                 d_empty = bar0 + 40;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * warp;
  const int k = blockIdx.x;   // the chunk, the block's rank in the cluster
  const int K = gridDim.x;
  const int n_groups = gridDim.y;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = 64 * k;
  const int h0 = grp * heads;
  const size_t row0 = static_cast<size_t>(b) * T_len + t0;
  const bool first = k == 0;
  const bool last = k + 1 == K;
  // the block waits first for the state that reaches it first
  const bool s_sooner = 2 * k < K - 1;

  if (tid == 0) {
    hp::prefetch_tensormap(&tm_x);
    hp::prefetch_tensormap(&tm_dy);
    for (int i = 0; i < 6; ++i) hp::mbar_init(bar0 + 8 * i, 1);
    hp::fence_barrier_init();
  }
  // every block's barriers exist before a neighbour signals one
  hp::cluster_sync();
  if (tid == 0) {
    hp::mbar_expect_tx(bc_full, 2 * kSwTile);
    hp::tma_load_4d(tile(kTB), &tm_b, bc_full, 0, 0, t0, b);
    hp::tma_load_4d(tile(kTC), &tm_c, bc_full, 0, 0, t0, b);
    hp::mbar_expect_tx(xy_full, 2 * kSwTile);
    hp::tma_load_4d(tile(kTX), &tm_x, xy_full, 0, h0, t0, b);
    hp::tma_load_4d(tile(kTDy), &tm_dy, xy_full, 0, h0, t0, b);
  }
  float dBa[32], dCa[32];   // the group's dB and dC, rows s (t) of the chunk
  zero(dBa);
  zero(dCa);
  // warp 0 holds the next head's dt (rows lane, lane + 32) and A, loaded a
  // head ahead
  float dt0 = 0.0f, dt1 = 0.0f, a_next = 0.0f;
  if (warp == 0) {
    dt0 = dt[(row0 + lane) * H + h0];
    dt1 = dt[(row0 + lane + 32) * H + h0];
    a_next = A[h0];
  }
  // the first chunk's start state and the last chunk's end-state gradient
  // come from global memory: a head ahead, into the chain buffers that no
  // neighbour writes there
  auto prefetch_states = [&](int h) {
    const size_t at = (static_cast<size_t>(b) * H + h) * 4096;
    if (first) frag_prefetch(base + kSIn, state0 + at);
    if (last && dstate_T != nullptr) frag_prefetch(base + kDIn, dstate_T + at);
  };
  prefetch_states(h0);
  wait_phase(bc_full, 0);

  for (int i = 0; i < heads; ++i) {
    const int h = h0 + i;
    const size_t bh = static_cast<size_t>(b) * H + h;
    if (warp == 0) {
      // the chunk's vectors: cum (an inclusive scan of dt A), exp(cum),
      // exp(cum_L - cum), w = exp(cum_L - cum) dt
      const float a = a_next;
      float c0 = dt0 * a, c1 = dt1 * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, c0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, c1, off);
        if (lane >= off) {
          c0 += u0;
          c1 += u1;
        }
      }
      c1 += __shfl_sync(0xffffffffu, c0, 31);
      const float cl = __shfl_sync(0xffffffffu, c1, 31);
      const float d0 = expf(cl - c0), d1 = expf(cl - c1);
      dts[lane] = dt0;
      dts[lane + 32] = dt1;
      cum[lane] = c0;
      cum[lane + 32] = c1;
      ecum[lane] = expf(c0);
      ecum[lane + 32] = expf(c1);
      dec[lane] = d0;
      dec[lane + 32] = d1;
      wv[lane] = d0 * dt0;
      wv[lane + 32] = d1 * dt1;
      if (i + 1 < heads) {
        dt0 = dt[(row0 + lane) * H + h + 1];
        dt1 = dt[(row0 + lane + 32) * H + h + 1];
        a_next = A[h + 1];
      }
      if (lane == 0) {   // this head's S and dS' to come from the neighbours
        if (!first) hp::mbar_expect_tx(s_full, kFragBytes);
        if (!last) hp::mbar_expect_tx(d_full, kFragBytes);
      }
    }
    __syncthreads();   // (1) the head's vectors
    const float elast = ecum[63];
    wait_phase(xy_full, i & 1);

    // U = (B o w)^T x and V = (C o exp(cum))^T dy: rows n (this warp's
    // 16), k steps over the chunk; B o w and C o exp(cum) split into hi
    // and lo A fragments, x and dy MN-major
    float U[32], V[32];
    {
      uint32_t uh[4][4], ul[4][4], vh[4][4], vl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t fb[4], fc[4];
        lda_t_sw(fb, tile(kTB), r0, kk);
        lda_t_sw(fc, tile(kTC), r0, kk);
        const int s0 = 16 * kk + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = s0 + (q < 2 ? 0 : 8);
          const float2 f = tc::unpack_bf16(fb[q]);
          tc::split_bf16(f.x * wv[s], f.y * wv[s + 1], uh[kk][q], ul[kk][q]);
          const float2 e = tc::unpack_bf16(fc[q]);
          tc::split_bf16(e.x * ecum[s], e.y * ecum[s + 1], vh[kk][q],
                         vl[kk][q]);
        }
      }
      zero(U);
      zero(V);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_rs(U, uh[kk], desc_mn(tile(kTX), kk), 1);
        hp::mma_rs(U, ul[kk], desc_mn(tile(kTX), kk), 1);
        hp::mma_rs(V, vh[kk], desc_mn(tile(kTDy), kk), 1);
        hp::mma_rs(V, vl[kk], desc_mn(tile(kTDy), kk), 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(U);
      hp::fence_regs(V);
    }

    // The chain: S from block k - 1 (or state0), dS' from block k + 1 (or
    // dstate_T); each is passed on as soon as it is in, in whichever order
    // the two come, so both walks take K - 1 hops. Each then goes into its
    // hi and lo tiles (rows n, columns p)
    auto take = [&](int off, float (&r)[32]) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            smem + off + 16 * (q * kClThreads + tid));
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
    };
    auto to_tiles = [&](const float (&r)[32], int hi_tile, int lo_tile) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh;
          const uint32_t o = sw(r0 + g + 8 * hh, 8 * j + 2 * t);
          uint32_t hi, lo;
          tc::split_bf16(r[x], r[x + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(smem + hi_tile * kSwTile + o) = hi;
          *reinterpret_cast<uint32_t*>(smem + lo_tile * kSwTile + o) = lo;
        }
    };
    // S_{k+1} = exp(cum_L) S + U to block k + 1; S to its tiles
    auto pass_s = [&]() {
      float S[32];
      take(kSIn, S);
      if (!last) {
        if (i > 0) wait_phase(s_empty, (i - 1) & 1);
        const uint32_t dst = hp::map_rank(base + kSIn, k + 1) + 16 * tid;
        const uint32_t bar = hp::map_rank(s_full, k + 1);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          hp::st_async(dst + q * 16 * kClThreads,
                       make_float4(fmaf(elast, S[4 * q], U[4 * q]),
                                   fmaf(elast, S[4 * q + 1], U[4 * q + 1]),
                                   fmaf(elast, S[4 * q + 2], U[4 * q + 2]),
                                   fmaf(elast, S[4 * q + 3], U[4 * q + 3])),
                       bar);
        }
      }
      to_tiles(S, kTSh, kTSl);
    };
    // dS'_{k-1} = exp(cum_L) dS' + V to block k - 1 (dstate0 from block
    // 0); dS' to its tiles
    auto pass_d = [&]() {
      float dS[32];
      if (!last || dstate_T != nullptr) {
        take(kDIn, dS);
      } else {
        zero(dS);
      }
      if (first) {
#pragma unroll
        for (int x = 0; x < 32; ++x) V[x] = fmaf(elast, dS[x], V[x]);
        frag_store(dstate0 + bh * 4096, V);
      } else {
        if (i > 0) wait_phase(d_empty, (i - 1) & 1);
        const uint32_t dst = hp::map_rank(base + kDIn, k - 1) + 16 * tid;
        const uint32_t bar = hp::map_rank(d_full, k - 1);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          hp::st_async(dst + q * 16 * kClThreads,
                       make_float4(fmaf(elast, dS[4 * q], V[4 * q]),
                                   fmaf(elast, dS[4 * q + 1], V[4 * q + 1]),
                                   fmaf(elast, dS[4 * q + 2], V[4 * q + 2]),
                                   fmaf(elast, dS[4 * q + 3], V[4 * q + 3])),
                       bar);
        }
      }
      to_tiles(dS, kTDh, kTDl);
    };
    // whether a state has come, the warp's lanes agreeing (they wait with
    // the thread suspended, not spinning: the block beside this one on its
    // SM keeps the issue slots)
    auto arrived = [&](uint32_t bar) {
      if (!__shfl_sync(0xffffffffu,
                       hp::mbar_try_cluster(bar, i & 1, kSuspendNs), 0)) {
        return false;
      }
      wait_phase(bar, i & 1);
      return true;
    };
    if (first || last) tc::cp_async_wait<0>();   // the prefetched states
    if (first) pass_s();
    if (last) pass_d();
    bool need_s = !first, need_d = !last;
    for (uint32_t n = 0; need_s || need_d; ++n) {
      if (n == (1u << 22)) __trap();
      if (s_sooner) {
        if (need_s && arrived(s_full)) {
          pass_s();
          need_s = false;
        }
        if (need_d && arrived(d_full)) {
          pass_d();
          need_d = false;
        }
      } else {
        if (need_d && arrived(d_full)) {
          pass_d();
          need_d = false;
        }
        if (need_s && arrived(s_full)) {
          pass_s();
          need_s = false;
        }
      }
    }
    // the sum of S o dS', from the f32 copies the chain left
    {
      float S[32], dS[32];
      take(kSIn, S);
      if (!last || dstate_T != nullptr) {
        take(kDIn, dS);
      } else {
        zero(dS);
      }
      float ssd = 0.0f;
#pragma unroll
      for (int x = 0; x < 32; ++x) ssd = fmaf(S[x], dS[x], ssd);
      ssd = tc::warp_sum(ssd);
      if (lane == 0) part[warp] = ssd;
    }
    hp::fence_proxy_async();
    __syncthreads();   // (2) S and dS' in their tiles; the chain copies read

    // rows t: G = C.B^T and dM = dy.x^T (exact), and S dy_t beside them;
    // then in f32 as the mma.sync route forms them: M and dG (hi and lo
    // tiles where the chain copies were, rows t, columns s), the ddt
    // column sums, Q and its spanned prefix sums; dC += exp(cum_t) S dy_t
    // + dG.B
    {
      float gm[32], dm[32], acc[32];
      zero(gm);
      zero(dm);
      zero(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss(gm, desc_k(tile(kTC), kk), desc_k(tile(kTB), kk), 1);
        hp::mma_ss(dm, desc_k(tile(kTDy), kk), desc_k(tile(kTX), kk), 1);
      }
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss(acc, desc_k(tile(kTDy), kk), desc_k(tile(kTSh), kk), 1);
        hp::mma_ss(acc, desc_k(tile(kTDy), kk), desc_k(tile(kTSl), kk), 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(gm);
      hp::fence_regs(dm);
      // D = exp(min(cum_t - cum_s, 0)) at s <= t; M = G o D o dt_s and dG
      // = dM o D o dt_s to their tiles; the ddt products dM o G o D summed
      // down the columns; Q = dM o M at s < t where the clamp passes the
      // difference (in gm's place)
      const float ct0 = cum[r0 + g], ct1 = cum[r0 + g + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float col[2] = {0.0f, 0.0f};
        float mv[4], dg[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          const int tt = r0 + g + 8 * (e >> 1);
          const int ss = 8 * j + 2 * t + (e & 1);
          const float diff = ((e >> 1) ? ct1 : ct0) - cum[ss];
          const float d = ss <= tt ? expf(fminf(diff, 0.0f)) : 0.0f;
          const float gv = gm[x];
          const float dv = dm[x];
          mv[e] = gv * d * dts[ss];
          dg[e] = dv * d * dts[ss];
          col[e & 1] += dv * gv * d;
          gm[x] = ss < tt && diff <= 0.0f ? dv * mv[e] : 0.0f;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t o = sw(r0 + g + 8 * hh, 8 * j + 2 * t);
          uint32_t hi, lo;
          tc::split_bf16(mv[2 * hh], mv[2 * hh + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(smem + kTMh * kSwTile + o) = hi;
          *reinterpret_cast<uint32_t*>(smem + kTMl * kSwTile + o) = lo;
          tc::split_bf16(dg[2 * hh], dg[2 * hh + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(smem + kTGh * kSwTile + o) = hi;
          *reinterpret_cast<uint32_t*>(smem + kTGl * kSwTile + o) = lo;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = tc::column_sum(col[c]);
          if (g == 0) cole[warp * 64 + 8 * j + 2 * t + c] = v;
        }
      }
      hp::fence_proxy_async();
      // Q's rows to exclusive prefix sums U[t, j] = sum_{s<j} Q[t, s] (a
      // scan over the quad, tile by tile), summed down the columns at t >=
      // j: the Q[t, s] whose exponent spans a_j
      {
        float run[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float col[2] = {0.0f, 0.0f};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float qa = gm[4 * j + 2 * r];
            const float qb = gm[4 * j + 2 * r + 1];
            float inc = qa + qb;
            float y = __shfl_up_sync(0xffffffffu, inc, 1, 4);
            if (t >= 1) inc += y;
            y = __shfl_up_sync(0xffffffffu, inc, 2, 4);
            if (t >= 2) inc += y;
            float ex = __shfl_up_sync(0xffffffffu, inc, 1, 4);
            if (t == 0) ex = 0.0f;
            const float ua = run[r] + ex;
            const float ub = ua + qa;
            const int tt = r0 + g + 8 * r;
            const int s0 = 8 * j + 2 * t;
            col[0] += s0 <= tt ? ua : 0.0f;
            col[1] += s0 + 1 <= tt ? ub : 0.0f;
            run[r] += __shfl_sync(0xffffffffu, inc, 3, 4);
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float v = tc::column_sum(col[c]);
            if (g == 0) span[warp * 64 + 8 * j + 2 * t + c] = v;
          }
        }
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      // the readout's exponent gradient exp(cum_t) C_t . S dy_t
      float ip[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 c2 = tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
              smem + kTC * kSwTile + sw(r0 + g + 8 * hh, 8 * j + 2 * t)));
          ip[hh] = fmaf(c2.x, acc[4 * j + 2 * hh],
                        fmaf(c2.y, acc[4 * j + 2 * hh + 1], ip[hh]));
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float v = tc::quad_sum(ip[hh]);
        if (t == 0) inter[r0 + g + 8 * hh] = ecum[r0 + g + 8 * hh] * v;
      }
      const float e0 = ecum[r0 + g], e1 = ecum[r0 + g + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dCa[4 * j] = fmaf(acc[4 * j], e0, dCa[4 * j]);
        dCa[4 * j + 1] = fmaf(acc[4 * j + 1], e0, dCa[4 * j + 1]);
        dCa[4 * j + 2] = fmaf(acc[4 * j + 2], e1, dCa[4 * j + 2]);
        dCa[4 * j + 3] = fmaf(acc[4 * j + 3], e1, dCa[4 * j + 3]);
      }
    }
    __syncthreads();   // (3) the M and dG tiles are in
    // dC += dG.B (dG K-major, B MN-major); rows s: dB += w_s dS' x_s +
    // dG^T.C (dW_s = B_s . dS' x_s on the way) and dx = w_s dS'^T B_s +
    // M^T.dy (M and dG read MN-major as the transposed A)
    {
      float acc[32], ax[32];
      zero(acc);
      zero(ax);
      hp::fence_regs(dCa);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss_t<0, 1>(dCa, desc_k(tile(kTGh), kk),
                           desc_mn(tile(kTB), kk), 1);
        hp::mma_ss_t<0, 1>(dCa, desc_k(tile(kTGl), kk),
                           desc_mn(tile(kTB), kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss(acc, desc_k(tile(kTX), kk), desc_k(tile(kTDh), kk), 1);
        hp::mma_ss(acc, desc_k(tile(kTX), kk), desc_k(tile(kTDl), kk), 1);
        hp::mma_ss_t<0, 1>(ax, desc_k(tile(kTB), kk),
                           desc_mn(tile(kTDh), kk), 1);
        hp::mma_ss_t<0, 1>(ax, desc_k(tile(kTB), kk),
                           desc_mn(tile(kTDl), kk), 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dCa);
      hp::fence_regs(acc);
      hp::fence_regs(ax);
      const float w0 = wv[r0 + g], w1 = wv[r0 + g + 8];
      float wp[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 b2 = tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
              smem + kTB * kSwTile + sw(r0 + g + 8 * hh, 8 * j + 2 * t)));
          wp[hh] = fmaf(b2.x, acc[4 * j + 2 * hh],
                        fmaf(b2.y, acc[4 * j + 2 * hh + 1], wp[hh]));
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float v = tc::quad_sum(wp[hh]);
        if (t == 0) dws[r0 + g + 8 * hh] = v;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dBa[4 * j] = fmaf(acc[4 * j], w0, dBa[4 * j]);
        dBa[4 * j + 1] = fmaf(acc[4 * j + 1], w0, dBa[4 * j + 1]);
        dBa[4 * j + 2] = fmaf(acc[4 * j + 2], w1, dBa[4 * j + 2]);
        dBa[4 * j + 3] = fmaf(acc[4 * j + 3], w1, dBa[4 * j + 3]);
        ax[4 * j] *= w0;
        ax[4 * j + 1] *= w0;
        ax[4 * j + 2] *= w1;
        ax[4 * j + 3] *= w1;
      }
      hp::fence_regs(dBa);
      hp::fence_regs(ax);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss_t<1, 1>(dBa, desc_mn(tile(kTGh), kk),
                           desc_mn(tile(kTC), kk), 1);
        hp::mma_ss_t<1, 1>(dBa, desc_mn(tile(kTGl), kk),
                           desc_mn(tile(kTC), kk), 1);
        hp::mma_ss_t<1, 1>(ax, desc_mn(tile(kTMh), kk),
                           desc_mn(tile(kTDy), kk), 1);
        hp::mma_ss_t<1, 1>(ax, desc_mn(tile(kTMl), kk),
                           desc_mn(tile(kTDy), kk), 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dBa);
      hp::fence_regs(ax);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        bf16* dst = dx + ((row0 + r0 + g + 8 * hh) * H + h) * 64 + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              tc::pack_bf16(ax[4 * j + 2 * hh], ax[4 * j + 2 * hh + 1]);
        }
      }
    }
    __syncthreads();   // (4) x, dy, M and dG are read; the vectors are in
    if (i + 1 < heads) prefetch_states(h + 1);
    if (tid == 32 && i + 1 < heads) {
      // (warp 1, so that warp 0 goes on to the vectors) the chain buffers
      // (M and dG since (2)) may take the next head's states; x and dy the
      // next head's
      if (!first) hp::mbar_arrive_remote(hp::map_rank(s_empty, k - 1));
      if (!last) hp::mbar_arrive_remote(hp::map_rank(d_empty, k + 1));
      hp::mbar_expect_tx(xy_full, 2 * kSwTile);
      hp::tma_load_4d(tile(kTX), &tm_x, xy_full, 0, h + 1, t0, b);
      hp::tma_load_4d(tile(kTDy), &tm_dy, xy_full, 0, h + 1, t0, b);
    }
    // warp 0, lane holding rows j = lane and lane + 32: dloga_j = the
    // spanned Q + the readouts at t >= j (a suffix scan) + w_s's exponents
    // at s < j (a prefix scan) + exp(cum_L) sum S o dS'; then ddt and dA's
    // part, as the mma.sync route's chunk kernel. Warp 0 writes the next
    // head's vectors only after it; the other warps read them after (1)
    if (warp == 0) {
      const float a = A[h];
      const float tail = elast * (((part[0] + part[1]) + part[2]) + part[3]);
      float i0 = dws[lane] * wv[lane];
      float i1 = dws[lane + 32] * wv[lane + 32];
      float s0 = inter[63 - lane];
      float s1 = inter[31 - lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y0 = __shfl_up_sync(0xffffffffu, i0, off);
        const float y1 = __shfl_up_sync(0xffffffffu, i1, off);
        const float z0 = __shfl_up_sync(0xffffffffu, s0, off);
        const float z1 = __shfl_up_sync(0xffffffffu, s1, off);
        if (lane >= off) {
          i0 += y0;
          i1 += y1;
          s0 += z0;
          s1 += z1;
        }
      }
      const float tot = __shfl_sync(0xffffffffu, i0, 31);
      float e0 = __shfl_up_sync(0xffffffffu, i0, 1);
      float e1 = __shfl_up_sync(0xffffffffu, i1, 1);
      if (lane == 0) e0 = e1 = 0.0f;
      e1 += tot;
      s1 += __shfl_sync(0xffffffffu, s0, 31);
      const float suf0 = __shfl_sync(0xffffffffu, s1, 31 - lane);
      const float suf1 = __shfl_sync(0xffffffffu, s0, 31 - lane);
      float dA_acc = 0.0f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = lane + 32 * r;
        float sp = 0.0f, ce = 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          sp += span[w * 64 + j];
          ce += cole[w * 64 + j];
        }
        const float dloga = sp + (r ? e1 : e0) + tail + (r ? suf1 : suf0);
        ddt[(row0 + j) * H + h] = ce + dec[j] * dws[j] + a * dloga;
        dA_acc = fmaf(dts[j], dloga, dA_acc);
      }
      dA_acc = tc::warp_sum(dA_acc);
      if (lane == 0) dA_part[bh * K + k] = dA_acc;
    }
  }

  // the group's dB and dC, rows of the chunk, as one partial sum
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const size_t o = ((row0 + r0 + g + 8 * hh) * n_groups + grp) * 64 + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(dBp + o + 8 * j) =
          make_float2(dBa[4 * j + 2 * hh], dBa[4 * j + 2 * hh + 1]);
      *reinterpret_cast<float2*>(dCp + o + 8 * j) =
          make_float2(dCa[4 * j + 2 * hh], dCa[4 * j + 2 * hh + 1]);
    }
  }
  // no block leaves while a neighbour may still reach its shared memory
  hp::cluster_sync();
}

int set_smem_cluster() {
  return static_cast<int>(cudaFuncSetAttribute(
      ssd_bwd_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kClSmem)));
}

// The cluster kernel's launch: grid (K, H / heads, B) in clusters of the
// K chunks.
cudaLaunchConfig_t cluster_config(int K, int n_groups, int B,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, n_groups, B);
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = kClSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether the cluster route takes the shape: N = P = chunk = 64, one B/C
// group, at most kClMaxChunks chunks, `heads` dividing H, and every bf16
// tensor a TMA map can describe (16-byte aligned).
bool cluster_ok(const void* x, const void* Bm, const void* Cm,
                const void* dy, int B, int T_len, int H, int P, int G, int N,
                int chunk, int heads) {
  return chunk == 64 && N == 64 && P == 64 && G == 1 && T_len % 64 == 0 &&
         T_len / 64 >= 1 && T_len / 64 <= kClMaxChunks && heads >= 1 &&
         H % heads == 0 && B <= 65535 && tc::aligned16(x) &&
         tc::aligned16(Bm) && tc::aligned16(Cm) && tc::aligned16(dy);
}

int launch_cluster(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* state0,
                   const void* dy, const float* dstate_T, void* dx,
                   float* ddt, float* dA, void* dBm, void* dCm,
                   float* dstate0, float* dBp, float* dCp, float* dA_part,
                   int B, int T_len, int H, int heads, cudaStream_t stream) {
  int err = set_smem_cluster();
  if (err != 0) return err;
  CUtensorMap tm_x, tm_dy, tm_b, tm_c;
  if (!hp::encode_bshd(&tm_x, x, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_dy, dy, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_b, Bm, B, T_len, 1, 64, 64) ||
      !hp::encode_bshd(&tm_c, Cm, B, T_len, 1, 64, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = T_len / 64;
  const int n_groups = H / heads;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(K, n_groups, B, stream, &attr);
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, ssd_bwd_cluster_kernel, tm_x, tm_dy, tm_b, tm_c, dt, A, state0,
      dstate_T, static_cast<bf16*>(dx), ddt, dBp, dCp, dA_part, dstate0,
      T_len, H, heads));
  if (err != 0) return err;
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t quads = static_cast<size_t>(B) * T_len * 16;
  const size_t blocks = (quads + 255) / 256;
  ssd_bwd_reduce_kernel<bf16><<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                                  : 4096),
                              256, 0, stream>>>(
      dBp, dCp, dA_part, static_cast<bf16*>(dBm), static_cast<bf16*>(dCm), dA,
      B, static_cast<size_t>(B) * T_len, H, n_groups, 1, 64, K);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on max(N, P) padded to 16, 32, 64 or 128.
template <typename Fn>
int with_dim(int N, int P, Fn&& fn) {
  const int d = N > P ? N : P;
  if (d <= 16) return fn(std::integral_constant<int, 16>{});
  if (d <= 32) return fn(std::integral_constant<int, 32>{});
  if (d <= 64) return fn(std::integral_constant<int, 64>{});
  if (d <= 128) return fn(std::integral_constant<int, 128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The chunk the backward takes for the forward's `chunk`: for bf16
// (dtype 1 and 2) the forward's own; for f32 the largest divisor of T_len
// <= chunk whose shared memory fits the card; 0 if none.
extern "C" int mamba2_ssd_bwd_chunk(int T_len, int N, int P, int chunk,
                                    int dtype) {
  if (!valid(T_len, 1, P, 1, N, chunk)) return 0;
  if (dtype == 1 || dtype == 2) return chunk;
  return fit_chunk(T_len, N, P, chunk);
}

// x, dy, dx: (B, T, H, P); dt, ddt: (B, T, H) f32; A, dA: (H,) f32; Bm,
// Cm, dBm, dCm: (B, T, G, N); state0, dstate_T, dstate0: (B, H, N, P) f32
// (dstate_T may be null: zeros). x, dy, dx, Bm, Cm, dBm, dCm are f32
// (dtype 0: the CUDA-core scan) or bf16 (dtype 1: the mma.sync route;
// dtype 2: the cluster route, which cluster_ok must take); all contiguous.
// Workspaces, f32:
//   dtype 0: states (B * H * T/chunk * N * P), dBh and dCh (B, T, H, N),
//     dA_part (B, H); dstates null;
//   dtype 1: the same, dA_part (B, H, T/chunk) and dstates as states;
//   dtype 2: dBh and dCh (B, T, H / heads, N), the partial sums of each
//     group of `heads` heads, and dA_part (B, H, T/chunk); states and
//     dstates null.
// `chunk` divides T and is one mamba2_ssd_bwd_chunk gave; `heads` is read
// by dtype 2 only. Launches the kernels on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int mamba2_ssd_bwd_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* state0, const void* dy,
    const float* dstate_T, void* dx, float* ddt, float* dA, void* dBm,
    void* dCm, float* dstate0, float* states, float* dstates, float* dBh,
    float* dCh, float* dA_part, int B, int T_len, int H, int P, int G, int N,
    int chunk, int dtype, int heads, void* stream) {
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
    return with_dim(N, P, [&](auto d) {
      return launch_tc<decltype(d)::value>(
          x, dt, A, Bm, Cm, state0, dy, dstate_T, dx, ddt, dA, dBm, dCm,
          dstate0, states, dstates, dBh, dCh, dA_part, B, T_len, H, P, G, N,
          chunk, st);
    });
  }
  if (dtype == 2) {
    if (!cluster_ok(x, Bm, Cm, dy, B, T_len, H, P, G, N, chunk, heads)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_cluster(x, dt, A, Bm, Cm, state0, dy, dstate_T, dx, ddt,
                          dA, dBm, dCm, dstate0, dBh, dCh, dA_part, B, T_len,
                          H, heads, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The compiled kernel for `dtype` at (N, P, chunk): f32 its one scan
// kernel; bf16 (dtype 1) kernel `part` of the mma.sync route (0 the chunk
// kernel, 1 the walk); dtype 2 the cluster kernel (N = P = chunk = 64).
// info[0..5] as tc::kernel_info gives them (registers, static and dynamic
// shared memory, spill bytes, blocks an SM, threads a block). Returns a
// CUDA error code.
extern "C" int mamba2_ssd_bwd_info(int N, int P, int chunk, int dtype,
                                   int part, int* info) {
  if (P < 1 || P > kMaxDim || N < 1 || N > kMaxDim || chunk < 1 ||
      chunk > kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    const size_t smem = smem_floats(chunk, N, P) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return tc::kernel_info(ssd_bwd_kernel<float>, kThreads, smem, info);
  }
  if (dtype == 1) {
    return with_dim(N, P, [&](auto d) {
      return info_tc<decltype(d)::value>(part, info);
    });
  }
  if (dtype == 2) {
    if (N != 64 || P != 64 || chunk != 64) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int err = set_smem_cluster();
    if (err != 0) return err;
    return tc::kernel_info(ssd_bwd_cluster_kernel, kClThreads, kClSmem, info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `n_chunks` blocks of the cluster kernel the card
// holds at once (cudaOccupancyMaxActiveClusters; 0: it cannot place one),
// into *clusters. Returns a CUDA error code.
extern "C" int mamba2_ssd_bwd_clusters(int n_chunks, int* clusters) {
  *clusters = 0;
  if (n_chunks < 1 || n_chunks > kClMaxChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = set_smem_cluster();
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(n_chunks, 1, 1, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, ssd_bwd_cluster_kernel, &cfg));
}
