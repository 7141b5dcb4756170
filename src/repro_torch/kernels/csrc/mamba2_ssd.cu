// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Per (batch b, head h), with a_t = dt_t * A_h and cum_t the inclusive sum
// of a over the chunk, for every chunk of c time steps:
//
//   y_t    = exp(cum_t) C_t . S + sum_{s<=t} (C_t . B_s) exp(min(cum_t - cum_s, 0)) dt_s x_s
//   S_next = exp(cum_last) S + sum_s exp(cum_last - cum_s) dt_s B_s x_s^T
//
// with the (N, P) state S carried from chunk to chunk, from state0, and
// written out at the end (both f32). Replaces the Pallas TPU kernel
// kernels/mamba2_ssd.py::ssd of the JAX package (body _ssd_kernel,
// pallas_call at :106). The TPU grid walks the chunks in order with the
// state in VMEM scratch. One call is one CUDA launch. The B/C group of
// head h is h / (H / G): the kernels index it and never materialise the
// per-head repeat of the Pallas wrapper. The difference cum_t - cum_s is
// clamped at 0 before exp, as in the Pallas body: exact for s <= t, no
// overflow on the masked s > t entries. The chunk is the wrapper's: the
// largest c <= 64 that divides T.
//
// Bound: at (B, T, H, P, G, N) = (4, 512, 112, 64, 1, 64) with bf16 x, B, C
// and f32 dt and states, the function moves about 75 MB (x and y 29 MB
// each, the two f32 states 7.3 MB each): about 22 us at 3.35 TB/s. Its work
// is about 7.5 GFLOP (four 64^3 products per chunk and head): 7.6 us on the
// bf16 tensor cores, 112 us in f32 on the CUDA cores. So the bf16 routes
// are bound by bytes once their products are on the tensor cores.
//
// The dtype and shape pick the route (mamba2_ssd.py::fwd_route, the
// launcher's dtype code): f32 the CUDA cores (0); bf16 at N = P = chunk =
// 64 with x, B, C, y 16-byte aligned (a TMA map describes them) one
// warpgroup a (b, h) walking the chunks on Hopper's TMA and wgmma (2), any
// T (zamba2's serve and train paths); every other bf16 input mma.sync (1).
// Both bf16 routes round the same operands to bf16: B o w (the state's
// increment), the masked scores, and S's copy for the readout; the sums are
// f32. The warpgroup route also rounds C o exp(cum) (as the JAX reference
// forms it, Cm * exp(cum), before the product); mma.sync scales C . S by
// exp(cum) after it.
//
// bf16 warpgroup route (ssd_wg_kernel): 448 blocks of one warpgroup at the
// serve shape, 4 an SM (128 registers, 52,256 bytes of shared memory), so
// all of them run in one wave, each walking its 8 chunks with S in f32
// registers (the wgmma D fragment). A chunk's x, B and C come by TMA into
// one of two stages while the previous chunk computes; dt by cp.async. G =
// C . B^T (wgmma, both tiles K-major), masked in f32 and rounded to bf16 as
// A fragments (exp2 by the SFU, the column blocks past a warp's rows
// skipped); S's bf16 copy into B's tile by stmatrix; S scaled by
// exp(cum_L), then (B o w)^T x added onto it on the tensor cores (A from
// ldmatrix.trans of B's tile), while C's rows are scaled by exp(cum) in
// place; y = P . x + (C o exp(cum)) . S_c in one accumulator, y by
// stmatrix into x's tile and out by TMA. Four barriers a chunk. Holding C
// o exp(cum) as A fragments instead, or the increment in its own
// accumulator, took the kernel past 128 registers: ptxas then spilled and
// serialised the wgmma.
//
// A thread block cluster over the chunks of a (b, h), a block a chunk, the
// chunks' increments exchanged through distributed shared memory, was
// built first and measured no faster than mma.sync at the serve shape
// (0.1052 ms): its 448 clusters of 8 ran in 7.2 waves of 62 in lockstep,
// each wave's loads, products and exchange one after another. PERF.md
// keeps its times and phase trace.
//
// bf16 mma.sync route (ssd_tc_kernel, chunk 50, N or P below 64,
// unaligned views): the four products run as mma.sync.m16n8k16, bf16
// operands and f32 sums; one block per (b, h), the chunk loop inside it,
// and the next chunk's x, B, C and dt copied by cp.async (16 bytes a
// thread) into the other half of a two-stage buffer while the tensor cores
// work on this one. The carried state lives in registers as f32 C tiles,
// 16 state rows a warp, for the whole scan: its update is one more mma
// accumulation onto it, scaled by exp(cum_last) first; only its bf16 copy
// goes through shared memory, as the B operand of y_inter. Each of 4 warps
// owns 16 rows of the chunk for the scores and y, with the causally empty
// score tiles skipped; N and P are padded to kD = 16, 32, 64 or 128 with
// zeros in shared memory and the chunk to 64 rows (rows past c load as
// zeros with dt = 0 and are never stored), so chunk 50, G = 2 and N, P <=
// 128 all run (kD = 128 takes 8 warps). The cumsum is one warp's shuffle
// scan (a lane holds rows lane and lane + 32). Three barriers a chunk.
// Where N or P is not a multiple of 8, or an input is not 16-byte aligned,
// the same tiles fill element by element. tests/
// test_torch_tensor_core_rounding.py holds these roundings within the JAX
// package's bf16 tolerance; tests/test_torch_ssd_fwd_cluster.py emulates
// the warpgroup route's order of sums.
//
// f32 route (ssd_kernel, unchanged from the first port): 256 threads, f32
// on the CUDA cores, one output element a thread. It is kept for f32 inputs
// because it meets the f32 tolerance (1e-4), which TF32 tensor-core
// products cannot; the serve path draws bf16 weights and never takes it,
// the tests and chip_smoke.py do. Each chunk stages x (c x P), B and C
// (c x N) as f32 in shared memory (odd row pitches), and dt; one thread per
// step builds the inclusive cumsum of dt * A, then the c x c decay-masked
// score matrix, the readout y and last the state update (in shared
// memory), each separated by a barrier.
//
// Measured (tools/time_kernels.py --only ssd_fwd, in turns with the
// parent; NVIDIA H100 80GB HBM3, 700.00 W), bf16 at (4, 512, 112, 64, 1,
// 64): the warpgroup route 0.0475-0.0478 ms a launch (CUPTI busy
// 0.0439-0.0446), against the mma.sync route's 0.1054-0.1062 (168
// registers, 65,808 bytes of shared memory, 3 blocks an SM: 448 blocks in
// 1.13 waves of 396); the byte bound is 0.0223.
// The first design, f32 on the CUDA cores, took 1.2390 ms.

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
constexpr int kMaxChunk = 64;
constexpr int kMaxDim = 128;   // N and P

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

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


// --------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync), cp.async prefetch of the next chunk
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;   // chunk rows in shared memory (chunks <= 64)

// kD: N and P padded to 16, 32, 64 or 128. One warp per 16 state rows
// (at least 4 warps, so the 4 row tiles of the chunk each have one).
template <int kD>
__host__ __device__ constexpr int tc_warps() { return kD > 64 ? kD / 16 : 4; }

template <int kD>
__host__ __device__ constexpr int tc_pitch() { return kD + 8; }

template <int kD>
constexpr size_t tc_smem_bytes() {
  // x, B, C of two chunks; the state's bf16 copy; dt of two chunks, cum,
  // exp(cum), w and exp(cum_last)
  return sizeof(bf16) * (6 * kTcRows + kD) * tc_pitch<kD>() +
         sizeof(float) * (5 * kTcRows + 4);
}

template <int kD>
__global__ void __launch_bounds__(32 * tc_warps<kD>())
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ state0,
              bf16* __restrict__ y, float* __restrict__ state_out, int T_len,
              int H, int P, int G, int N, int c, bool vec) {
  constexpr int kWarps = tc_warps<kD>();
  constexpr int kThreads = 32 * kWarps;
  constexpr int kPitch = tc_pitch<kD>();
  constexpr int kTile = kTcRows * kPitch;
  constexpr int kSteps = kD / 16;           // k steps over N
  constexpr int kYCols = kD / (kWarps / 4); // y columns a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  auto x_buf = [&](int st) { return smem + (3 * st) * kTile; };
  auto b_buf = [&](int st) { return smem + (3 * st + 1) * kTile; };
  auto c_buf = [&](int st) { return smem + (3 * st + 2) * kTile; };
  bf16* s_bf = smem + 6 * kTile;             // kD x kPitch: bf16 state
  float* dts = reinterpret_cast<float*>(s_bf + kD * kPitch);  // 2 x 64
  float* cum = dts + 2 * kTcRows;
  float* ecum = cum + kTcRows;               // exp(cum_t)
  float* wts = ecum + kTcRows;               // exp(cum_last - cum_s) dt_s
  float* last = wts + kTcRows;               // exp(cum_last)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (H / G);
  const float a = A[h];
  const size_t x_stride = static_cast<size_t>(H) * P;
  const size_t bc_stride = static_cast<size_t>(G) * N;
  const bf16* xb = x + (static_cast<size_t>(b) * T_len * H + h) * P;
  const bf16* bb = Bm + (static_cast<size_t>(b) * T_len * G + grp) * N;
  const bf16* cb = Cm + (static_cast<size_t>(b) * T_len * G + grp) * N;
  const float* dtb = dt + static_cast<size_t>(b) * T_len * H + h;
  bf16* yb = y + (static_cast<size_t>(b) * T_len * H + h) * P;
  const size_t state_base = (static_cast<size_t>(b) * H + h) * N * P;

  // rows past the chunk load as zeros (and dt as 0, so they add nothing)
  auto load_chunk = [&](int t0, int st) {
    tc::load_rows<kTcRows, kD, kPitch, kThreads>(x_buf(st), xb, x_stride, t0,
                                                 t0 + c, P, vec);
    tc::load_rows<kTcRows, kD, kPitch, kThreads>(b_buf(st), bb, bc_stride,
                                                 t0, t0 + c, N, vec);
    tc::load_rows<kTcRows, kD, kPitch, kThreads>(c_buf(st), cb, bc_stride,
                                                 t0, t0 + c, N, vec);
    if (threadIdx.x < kTcRows) {
      const int r = threadIdx.x;
      const bool ok = r < c;
      tc::cp_async4(dts + st * kTcRows + r,
                    ok ? dtb + static_cast<size_t>(t0 + r) * H : dtb,
                    ok ? 4 : 0);
    }
  };

  // the state: warp w < kD / 16 holds rows 16 w..16 w + 15 (all kD columns)
  // in f32 registers as C tiles, for the whole scan
  const bool has_state = warp < kD / 16;
  float sacc[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = warp * 16 + g + (e >> 1) * 8;
      const int p = nd * 8 + 2 * t + (e & 1);
      sacc[nd][e] = has_state && n < N && p < P
                        ? state0[state_base + static_cast<size_t>(n) * P + p]
                        : 0.0f;
    }
  }
  auto store_state_bf16 = [&]() {
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      bf16* row = s_bf + (warp * 16 + g) * kPitch + nd * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(row) =
          tc::pack_bf16(sacc[nd][0], sacc[nd][1]);
      *reinterpret_cast<uint32_t*>(row + 8 * kPitch) =
          tc::pack_bf16(sacc[nd][2], sacc[nd][3]);
    }
  };
  if (has_state) store_state_bf16();

  load_chunk(0, 0);
  tc::cp_async_commit();

  const int mt = warp & 3;                  // y rows 16 mt..16 mt + 15
  const int ycol0 = (warp >> 2) * kYCols;   // y columns ycol0..+kYCols-1
  const int n_chunks = T_len / c;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int st = ci & 1;
    const int t0 = ci * c;
    if (ci + 1 < n_chunks) {
      load_chunk(t0 + c, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();   // chunk ci has landed, ci + 1 in flight
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xs = x_buf(st);
    const bf16* bs = b_buf(st);
    const bf16* cs = c_buf(st);
    const float* dtc = dts + st * kTcRows;

    // inclusive cumsum of dt * A over the chunk: one warp, a lane holding
    // rows lane and lane + 32, 5 shuffle steps
    if (warp == 0) {
      const float d0 = dtc[lane];
      const float d1 = dtc[lane + 32];
      float c0 = d0 * a;
      float c1 = d1 * a;
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
      const float cl = c > 32 ? hi : lo;   // cum of the chunk's last row
      cum[lane] = c0;
      cum[lane + 32] = c1;
      ecum[lane] = expf(c0);
      ecum[lane + 32] = expf(c1);
      wts[lane] = expf(cl - c0) * d0;
      wts[lane + 32] = expf(cl - c1) * d1;
      if (lane == 0) *last = expf(cl);
    }
    __syncthreads();

    // y rows 16 mt..: C as A fragments (bf16 straight from the input)
    {
      uint32_t cf[kSteps][4];
      const bf16* crow = cs + (mt * 16 + (lane & 15)) * kPitch +
                         (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) tc::ldsm_x4(cf[kk], crow + kk * 16);

      // y_inter = exp(cum_t) (C . S): S's bf16 copy as the B operand
      float yacc[kYCols / 8][4];
#pragma unroll
      for (int nd = 0; nd < kYCols / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[nd][e] = 0.0f;
      const bf16* srow = s_bf + (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
                         ycol0 + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int nd2 = 0; nd2 < kYCols / 16; ++nd2) {
          uint32_t bv[4];
          tc::ldsm_x4_trans(bv, srow + kk * 16 * kPitch + nd2 * 16);
          tc::mma_bf16(yacc[2 * nd2], cf[kk], bv[0], bv[1]);
          tc::mma_bf16(yacc[2 * nd2 + 1], cf[kk], bv[2], bv[3]);
        }
      }
      const float e0 = ecum[mt * 16 + g];
      const float e1 = ecum[mt * 16 + g + 8];
#pragma unroll
      for (int nd = 0; nd < kYCols / 8; ++nd) {
        yacc[nd][0] *= e0;
        yacc[nd][1] *= e0;
        yacc[nd][2] *= e1;
        yacc[nd][3] *= e1;
      }

      // scores = C . B^T for columns s <= 16 mt + 15 (the rest is masked)
      float s[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
      const bf16* brow = bs + ((lane >> 4) * 8 + (lane & 7)) * kPitch +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int nb2 = 0; nb2 < 4; ++nb2) {
          if (nb2 > mt) continue;
          uint32_t bk[4];
          tc::ldsm_x4(bk, brow + nb2 * 16 * kPitch + kk * 16);
          tc::mma_bf16(s[2 * nb2], cf[kk], bk[0], bk[1]);
          tc::mma_bf16(s[2 * nb2 + 1], cf[kk], bk[2], bk[3]);
        }
      }
      // ∘ exp(min(cum_t - cum_s, 0)) ∘ dt_s, masked to s <= t
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = mt * 16 + g + (e >> 1) * 8;
          const int ss = nb * 8 + 2 * t + (e & 1);
          s[nb][e] = ss <= tt ? s[nb][e] *
                                    expf(fminf(cum[tt] - cum[ss], 0.0f)) *
                                    dtc[ss]
                              : 0.0f;
        }
      }

      // y_intra = scores . x: the scores (rounded to bf16) as A fragments
      const bf16* xrow = xs + (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
                         ycol0 + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > mt) continue;
        const uint32_t pa[4] = {
            tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nd2 = 0; nd2 < kYCols / 16; ++nd2) {
          uint32_t bv[4];
          tc::ldsm_x4_trans(bv, xrow + kk * 16 * kPitch + nd2 * 16);
          tc::mma_bf16(yacc[2 * nd2], pa, bv[0], bv[1]);
          tc::mma_bf16(yacc[2 * nd2 + 1], pa, bv[2], bv[3]);
        }
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tt = mt * 16 + g + r * 8;
        if (tt >= c) continue;
        bf16* dst = yb + static_cast<size_t>(t0 + tt) * x_stride;
#pragma unroll
        for (int nd = 0; nd < kYCols / 8; ++nd) {
          const int p = ycol0 + nd * 8 + 2 * t;
          const float v0 = yacc[nd][2 * r];
          const float v1 = yacc[nd][2 * r + 1];
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

    // S = exp(cum_last) S + (B ∘ w)^T . x: B^T through ldmatrix.trans,
    // scaled by w_s and rounded to bf16 in the fragment
    if (has_state) {
      const float decay = *last;
#pragma unroll
      for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nd][e] *= decay;
      const bf16* arow = bs + ((lane >> 4) * 8 + (lane & 7)) * kPitch +
                         warp * 16 + ((lane >> 3) & 1) * 8;
      const bf16* xrow = xs + (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
                         (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        tc::ldsm_x4_trans(af, arow + kk * 16 * kPitch);
        const float w0 = wts[kk * 16 + 2 * t];
        const float w1 = wts[kk * 16 + 2 * t + 1];
        const float w2 = wts[kk * 16 + 8 + 2 * t];
        const float w3 = wts[kk * 16 + 9 + 2 * t];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = tc::unpack_bf16(af[i]);
          af[i] = i < 2 ? tc::pack_bf16(f.x * w0, f.y * w1)
                        : tc::pack_bf16(f.x * w2, f.y * w3);
        }
#pragma unroll
        for (int nd2 = 0; nd2 < kD / 16; ++nd2) {
          uint32_t bv[4];
          tc::ldsm_x4_trans(bv, xrow + kk * 16 * kPitch + nd2 * 16);
          tc::mma_bf16(sacc[2 * nd2], af, bv[0], bv[1]);
          tc::mma_bf16(sacc[2 * nd2 + 1], af, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the chunk's buffers and the old bf16 state are read
    if (has_state) store_state_bf16();
  }

  if (has_state) {
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = warp * 16 + g + (e >> 1) * 8;
        const int p = nd * 8 + 2 * t + (e & 1);
        if (n < N && p < P) {
          state_out[state_base + static_cast<size_t>(n) * P + p] =
              sacc[nd][e];
        }
      }
    }
  }
}

template <int kD>
int set_smem_tc() {
  return static_cast<int>(cudaFuncSetAttribute(
      ssd_tc_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tc_smem_bytes<kD>())));
}

template <int kD>
int launch_tc(const void* x, const float* dt, const float* A, const void* Bm,
              const void* Cm, const float* state0, void* y, float* state_out,
              int B, int T_len, int H, int P, int G, int N, int c,
              cudaStream_t stream) {
  const int err = set_smem_tc<kD>();
  if (err != 0) return err;
  const bool vec = P % 8 == 0 && N % 8 == 0 && tc::aligned16(x) &&
                   tc::aligned16(Bm) && tc::aligned16(Cm);
  const dim3 grid(H, B);
  ssd_tc_kernel<kD><<<grid, 32 * tc_warps<kD>(), tc_smem_bytes<kD>(),
                      stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), state0, static_cast<bf16*>(y), state_out,
      T_len, H, P, G, N, c, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int info_tc(int* info) {
  const int err = set_smem_tc<kD>();
  if (err != 0) return err;
  return tc::kernel_info(ssd_tc_kernel<kD>, 32 * tc_warps<kD>(),
                         tc_smem_bytes<kD>(), info);
}


// --------------------------------------------------------------------------
// bf16 warpgroup route on Hopper: one warpgroup a (b, h) walks the chunks,
// TMA tiles and wgmma (N = P = chunk = 64, any number of chunks)
// --------------------------------------------------------------------------

using hp::desc_k;
using hp::desc_mn;
using hp::kSwTile;
using hp::lda_t_sw;
using hp::sw;
using hp::zero;

constexpr int kWgThreads = 128;   // one warpgroup

constexpr int kWgStage = 3 * kSwTile;   // x, B and C of a chunk
constexpr float kLog2e = 1.4426950408889634f;
// two stages, then two sets of dt, cum, exp(cum), w and exp(cum_L)
constexpr int kWgVec = 4 * 64 + 4;
constexpr size_t kWgSmem = 1024 + 2 * kWgStage + 2 * sizeof(float) * kWgVec;

// A warpgroup's 64 x 64 f32 D fragment, rounded to bf16, into a swizzled
// tile of 64 columns (rows as the fragment's), by stmatrix: four 8 x 8
// blocks an instruction, lane l giving row l % 8 of block l / 8.
__device__ __forceinline__ void st_frag_sw(uint32_t tile,
                                           const float (&d)[32]) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  const int row = 16 * (threadIdx.x >> 5) + (m & 1) * 8 + (lane & 7);
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
        :: "r"(tile + sw(row, 8 * (j + (m >> 1)))),
           "r"(tc::pack_bf16(d[4 * j], d[4 * j + 1])),
           "r"(tc::pack_bf16(d[4 * j + 2], d[4 * j + 3])),
           "r"(tc::pack_bf16(d[4 * j + 4], d[4 * j + 5])),
           "r"(tc::pack_bf16(d[4 * j + 6], d[4 * j + 7]))
        : "memory");
  }
}

// The chunk's vectors from its dt, in v[0..63] (lane: rows lane, lane +
// 32): cum, an inclusive scan of dt A; exp(cum); w = exp(cum_L - cum) dt;
// exp(cum_L). One warp.
__device__ __forceinline__ void chunk_vectors(float* v, float a) {
  const int lane = threadIdx.x & 31;
  const float d0 = v[lane], d1 = v[lane + 32];
  float c0 = d0 * a, c1 = d1 * a;
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
  v[64 + lane] = c0;                  // cum
  v[96 + lane] = c1;
  v[128 + lane] = expf(c0);           // exp(cum)
  v[160 + lane] = expf(c1);
  v[192 + lane] = expf(cl - c0) * d0; // w
  v[224 + lane] = expf(cl - c1) * d1;
  if (lane == 0) v[256] = expf(cl);   // exp(cum_L)
}

// One warpgroup per (b, h) walks the chunks in order with the state S in
// f32 registers (the wgmma D fragment: rows n, columns p), the next
// chunk's x, B and C coming by TMA into the other stage meanwhile. A
// chunk:
//   1. G = C . B^T (wgmma), masked and scaled by exp(min(cum_t - cum_s, 0))
//      dt_s in f32, rounded to bf16 as P (A fragments); meanwhile warp 0
//      fetches the next chunk's dt (cp.async) and, once the TMA store of
//      chunk c - 1's y has read its stage, loads chunk c + 1 there;
//   2. (B o w)^T as A fragments (ldmatrix.trans, rounded to bf16); S's
//      bf16 copy into B's tile (stmatrix); S scaled by exp(cum_L), then S
//      += (B o w)^T x on the tensor cores, while C's rows are scaled by
//      exp(cum) in place (rounded to bf16);
//   3. y = P . x + (C o exp(cum)) . S_c in one accumulator (wgmma), while
//      warp 0 forms the next chunk's vectors; y in bf16 into x's tile
//      (stmatrix) and out by a TMA store.
// Maps: x, y as (P, H, T, B) and Bm, Cm as (N, G, T, B) of bf16, 128-byte
// swizzled boxes of 64 columns x 64 rows.
__global__ void __launch_bounds__(kWgThreads, 4)
ssd_wg_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_b,
              const __grid_constant__ CUtensorMap tm_c,
              const __grid_constant__ CUtensorMap tm_y,
              const float* __restrict__ dt, const float* __restrict__ A,
              const float* __restrict__ state0,
              float* __restrict__ state_out, int T_len, int H, int G) {
  __shared__ __align__(8) uint64_t full[2];   // a stage's tiles in (TMA)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t base = hp::smem_u32(smem);
  float* vecs = reinterpret_cast<float*>(smem + 2 * kWgStage);
  const uint32_t bar0 = hp::smem_u32(full);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * warp;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (H / G);
  const int K = T_len / 64;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row0 = static_cast<size_t>(b) * T_len;
  auto load = [&](int c) {
    const uint32_t sx = base + (c & 1) * kWgStage;
    const uint32_t bar = bar0 + 8 * (c & 1);
    hp::mbar_expect_tx(bar, 3 * kSwTile);
    hp::tma_load_4d(sx, &tm_x, bar, 0, h, 64 * c, b);
    hp::tma_load_4d(sx + kSwTile, &tm_b, bar, 0, grp, 64 * c, b);
    hp::tma_load_4d(sx + 2 * kSwTile, &tm_c, bar, 0, grp, 64 * c, b);
  };
  if (tid == 0) {
    hp::prefetch_tensormap(&tm_x);
    hp::prefetch_tensormap(&tm_y);
    hp::mbar_init(bar0, 1);
    hp::mbar_init(bar0 + 8, 1);
    hp::fence_barrier_init();
    load(0);
    if (K > 1) load(1);
  }
  float S[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 v = *reinterpret_cast<const float2*>(
          state0 + bh * 4096 + (r0 + g + 8 * hh) * 64 + 8 * j + 2 * t);
      S[4 * j + 2 * hh] = v.x;
      S[4 * j + 2 * hh + 1] = v.y;
    }
  if (warp == 0) {
    vecs[lane] = dt[(row0 + lane) * H + h];
    vecs[lane + 32] = dt[(row0 + lane + 32) * H + h];
    __syncwarp();
    chunk_vectors(vecs, A[h]);
  }
  __syncthreads();   // the barriers and chunk 0's vectors

  for (int c = 0; c < K; ++c) {
    const uint32_t sx = base + (c & 1) * kWgStage;
    const uint32_t sb = sx + kSwTile, sc = sx + 2 * kSwTile;
    const float* v = vecs + (c & 1) * kWgVec;
    hp::mbar_wait(bar0 + 8 * (c & 1), (c >> 1) & 1);

    // 1. G = C . B^T; masked and scaled by exp(min(cum_t - cum_s, 0)) dt_s
    // in f32 (the column blocks past the warp's rows are all masked),
    // rounded to bf16 as P
    uint32_t pa[4][4];
    {
      float gm[32];
      zero(gm);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::mma_ss(gm, desc_k(sc, kk), desc_k(sb, kk), 1);
      }
      hp::wgmma_commit();
      // warp 0: the next chunk's dt (cp.async into its vectors); the TMA
      // load of chunk c + 1 into the stage of chunk c - 1, once its y has
      // left it
      if (warp == 0 && c + 1 < K) {
        const size_t r = row0 + 64 * (c + 1);
        float* vn = vecs + ((c + 1) & 1) * kWgVec;
        tc::cp_async4(vn + lane, dt + (r + lane) * H + h, 4);
        tc::cp_async4(vn + lane + 32, dt + (r + lane + 32) * H + h, 4);
        tc::cp_async_commit();
        if (lane == 0 && c >= 1) {
          hp::tma_store_wait_read();
          load(c + 1);
        }
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(gm);
      const float ct0 = v[64 + r0 + g], ct1 = v[72 + r0 + g];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j <= 2 * warp + 1) {
          const int s0 = 8 * j + 2 * t;
          const float2 cs = *reinterpret_cast<const float2*>(v + 64 + s0);
          const float2 ds = *reinterpret_cast<const float2*>(v + s0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tt = r0 + g + 8 * (e >> 1);
            const int ss = s0 + (e & 1);
            const float diff =
                ((e >> 1) ? ct1 : ct0) - ((e & 1) ? cs.y : cs.x);
            gm[4 * j + e] =
                ss <= tt ? gm[4 * j + e] *
                               hp::exp2_approx(fminf(diff, 0.0f) * kLog2e) *
                               ((e & 1) ? ds.y : ds.x)
                         : 0.0f;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) gm[4 * j + e] = 0.0f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[kk][q] = tc::pack_bf16(gm[8 * kk + 2 * q],
                                    gm[8 * kk + 2 * q + 1]);
    }

    // 2. (B o w)^T as A fragments (ldmatrix.trans, rounded to bf16). Once
    // every warp has read B and C: S's bf16 copy into B's tile; S =
    // exp(cum_L) S + (B o w)^T x on the tensor cores while C's rows are
    // scaled by exp(cum) in place (rounded to bf16)
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      lda_t_sw(af[kk], sb, r0, kk);
      const int s0 = 16 * kk + 2 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + (q < 2 ? 0 : 8);
        const float2 f = tc::unpack_bf16(af[kk][q]);
        af[kk][q] = tc::pack_bf16(f.x * v[192 + s], f.y * v[193 + s]);
      }
    }
    __syncthreads();
    st_frag_sw(sb, S);
    {
      const float e = v[256];
#pragma unroll
      for (int i = 0; i < 32; ++i) S[i] *= e;
    }
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hp::mma_rs(S, af[kk], desc_mn(sx, kk), 1);
    }
    hp::wgmma_commit();
#pragma unroll
    for (int i = 0; i < kSwTile / 16 / kWgThreads; ++i) {
      const int chunk = i * kWgThreads + tid;   // 16 bytes of row chunk / 8
      uint4* p = reinterpret_cast<uint4*>(smem + (sc - base) + 16 * chunk);
      const float e = v[128 + (chunk >> 3)];
      uint4 q = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        const float2 f = tc::unpack_bf16(w[k2]);
        w[k2] = tc::pack_bf16(f.x * e, f.y * e);
      }
      *p = q;
    }
    hp::fence_proxy_async();
    __syncthreads();
    hp::wgmma_wait<0>();
    hp::fence_regs(S);

    // 3. y = P . x + (C o exp(cum)) . S_c; meanwhile warp 0 forms the next
    // chunk's vectors
    float yv[32];
    zero(yv);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hp::mma_rs(yv, pa[kk], desc_mn(sx, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hp::mma_ss_t<0, 1>(yv, desc_k(sc, kk), desc_mn(sb, kk), 1);
    }
    hp::wgmma_commit();
    if (warp == 0 && c + 1 < K) {
      tc::cp_async_wait<0>();
      chunk_vectors(vecs + ((c + 1) & 1) * kWgVec, A[h]);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(yv);
    // y in bf16 into x's tile (the products that read it are done),
    // swizzled as TMA wrote it, then one TMA store; the next chunk's
    // vectors are in
    st_frag_sw(sx, yv);
    hp::fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      hp::tma_store_4d(&tm_y, sx, 0, h, 64 * c, b);
      hp::tma_store_commit();
    }
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
      ssd_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmem)));
}

int launch_wg(const void* x, const float* dt, const float* A, const void* Bm,
              const void* Cm, const float* state0, void* y,
              float* state_out, int B, int T_len, int H, int G,
              cudaStream_t stream) {
  int err = set_smem_wg();
  if (err != 0) return err;
  CUtensorMap tm_x, tm_b, tm_c, tm_y;
  if (!hp::encode_bshd(&tm_x, x, B, T_len, H, 64, 64) ||
      !hp::encode_bshd(&tm_b, Bm, B, T_len, G, 64, 64) ||
      !hp::encode_bshd(&tm_c, Cm, B, T_len, G, 64, 64) ||
      !hp::encode_bshd(&tm_y, y, B, T_len, H, 64, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ssd_wg_kernel<<<dim3(H, B), kWgThreads, kWgSmem, stream>>>(
      tm_x, tm_b, tm_c, tm_y, dt, A, state0, state_out, T_len, H, G);
  return static_cast<int>(cudaGetLastError());
}

// Whether the warpgroup route takes the shape: N = P = chunk = 64, any
// number of chunks, and x, B, C a TMA map can describe (16-byte aligned).
bool wg_ok(const void* x, const void* Bm, const void* Cm, const void* y,
           int T_len, int H, int P, int G, int N, int chunk) {
  return chunk == 64 && N == 64 && P == 64 && T_len % 64 == 0 &&
         T_len >= 64 && G >= 1 && H % G == 0 && tc::aligned16(x) &&
         tc::aligned16(Bm) && tc::aligned16(Cm) && tc::aligned16(y);
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

// x, y: (B, T, H, P); dt: (B, T, H) f32; A: (H,) f32; Bm, Cm: (B, T, G, N);
// state0, state_out: (B, H, N, P) f32; all contiguous. x, y, Bm and Cm are
// f32 (dtype 0: the CUDA cores) or bf16 (dtype 1: the mma.sync route;
// dtype 2: the warpgroup route, which wg_ok must take). `chunk` divides
// T. Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes, types and contiguity.
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
    return with_dim(N, P, [&](auto d) {
      return launch_tc<decltype(d)::value>(x, dt, A, Bm, Cm, state0, y,
                                           state_out, B, T_len, H, P, G, N,
                                           chunk, st);
    });
  }
  if (dtype == 2) {
    if (!wg_ok(x, Bm, Cm, y, T_len, H, P, G, N, chunk)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_wg(x, dt, A, Bm, Cm, state0, y, state_out, B, T_len, H,
                     G, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The compiled kernel of the route that `dtype` takes at (N, P, chunk)
// (dtype 2: the warpgroup kernel, N = P = chunk = 64): info[0..5] as
// tc::kernel_info gives them (registers, static and dynamic shared memory,
// spill bytes, blocks an SM, threads a block).
// Returns a CUDA error code (0 on success).
extern "C" int mamba2_ssd_info(int N, int P, int chunk, int dtype,
                               int* info) {
  if (P < 1 || P > kMaxDim || N < 1 || N > kMaxDim || chunk < 1 ||
      chunk > kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    const int c = chunk;
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(N) * (P + 1) + c * (P + 1) +
                         2 * c * (N + 1) + c * (c + 1) + 3 * c);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return tc::kernel_info(ssd_kernel<float>, kThreads, smem, info);
  }
  if (dtype == 1) {
    return with_dim(N, P, [&](auto d) {
      return info_tc<decltype(d)::value>(info);
    });
  }
  if (dtype == 2) {
    if (N != 64 || P != 64 || chunk != 64) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int err = set_smem_wg();
    if (err != 0) return err;
    return tc::kernel_info(ssd_wg_kernel, kWgThreads, kWgSmem, info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
