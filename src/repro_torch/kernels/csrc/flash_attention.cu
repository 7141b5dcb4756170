// Causal flash attention forward for Hopper (sm_90a).
//
//   out[b,s,h,:] = sum_{t<=s} softmax_t(q[b,s,h,:] . k[b,t,h,:] / sqrt(hd)) v[b,t,h,:]
//   lse[b,s,h]   = log sum_{t<=s} exp(q . k / sqrt(hd))
//
// Replaces the Pallas TPU kernel kernels/flash_attention.py::flash_attention
// of the JAX package (forward body _flash_fwd_kernel, pallas_call at :103).
// The TPU grid walks kv blocks in order with (acc, m, l) in VMEM scratch;
// here one block owns one (b, h, 64-row q tile) and walks the kv tiles in a
// loop with (acc, m, l) in registers.
//
// Bound: at zamba2-7b's prefill shape (B, S, H, hd) = (4, 512, 32, 112) in
// bf16 the function moves q, k, v and out (58.7 MB) plus lse: about 17.6 us
// at 3.35 TB/s. Its causal work is 2*B*H*S^2*hd ~ 7.5 GFLOP: 7.6 us on the
// bf16 tensor cores (989 TFLOP/s), 112 us in f32 on the CUDA cores
// (67 TFLOP/s). This kernel computes in f32 on the CUDA cores, so its bound
// is the f32 rate, and it does not reach it: the products run out of shared
// memory with two loads per FMA. wgmma tiles and TMA loads are later work.
//
// Design: 256 threads as 16 x 16. Thread (ty, tx) owns q rows ty*4..ty*4+3
// of the tile. For S = Q K^T it computes the 4 x 4 scores at kv columns
// tx + 16 j; for O += P V it accumulates 4 rows x 8 head columns
// tx + 16 c, so any hd <= 128 works (hd = 112 is not a power of two: the
// columns past hd are masked, never assumed). The 16 threads of a row group
// sit in one half-warp and reduce the row max and row sum with shuffles.
// Q, then K and V of each tile, are staged in shared memory as f32 with an
// odd row pitch (no bank conflicts on the strided K reads); the probability
// tile P goes through shared memory too. Inputs may be f32 or bf16; all
// arithmetic and the running (acc, m, l) are f32; out is written in the
// input dtype (round to nearest), lse in f32.
//
// The causal skip comes from token positions: a q tile whose last row is
// s_last reads kv tiles up to s_last only, and each score is masked on
// kpos <= qpos and kpos < S. The Pallas kernel's tile-index skip (j <= i)
// is exact only for equal q and kv blocks and is not copied. The last
// tile of a ragged S is short: rows past S load as zeros, are masked, and
// are never stored, so any S works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;          // 16 x 16
constexpr int kMaxHeadDim = 128;
constexpr int kCols = kMaxHeadDim / 16;  // output columns a thread
constexpr int kPPitch = kBlockK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <typename T>
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

  const int kv_end = min(S, q0 + kBlockQ);  // past the tile's last q row
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
        ok[j] = kpos < S && kpos <= qpos;
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int hd, cudaStream_t stream) {
  const int pitch = hd | 1;  // odd: conflict-free strided K reads
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ + kBlockK) * pitch +
                       kBlockQ * kPPitch);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, hd, pitch,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (B, S, H, hd) contiguous, f32 (dtype 0) or bf16 (dtype 1);
// lse: (B, S, H) f32. Launches on `stream` and returns cudaGetLastError()
// (0 on success). The caller checks shapes, types and contiguity.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int S, int H, int hd, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd < 1 || hd > kMaxHeadDim || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, lse, B, S, H, hd, st);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, out, lse, B, S, H, hd, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
