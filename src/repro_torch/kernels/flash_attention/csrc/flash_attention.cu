// Forward flash attention for Hopper (sm_90a) on the CUDA cores, bound to
// Python through ctypes: the route of float32 at every head_dim and of
// bfloat16 at head_dim 16 and 32.  bfloat16 at 64 and 128 runs on the
// tensor cores, in flash_attention_wgmma.cu.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _kernel) of
// src/repro/kernels/flash_attention/flash_attention.py, and computes what
// that kernel computes:
//
//   out[b,h,r] = sum_c p[r,c] v[b,h/group,c] / sum_c p[r,c]
//   p[r,c]     = exp(q[b,h,r] . k[b,h/group,c] * sm_scale - m[r]) where
//                column c is visible to row r, else 0
//
// with f32 scores, running max, normalizer and accumulator whatever the
// input type.  Column c is visible to row r when c < Lk and, if causal,
// c <= r + (Lk - Lq): the causal mask is aligned to the end of the kv
// sequence, so Lq < Lk is a decode-style query over a cached prefix and
// Lq > Lk leaves the first Lq - Lk rows with no visible column.  Such a
// fully masked row comes out 0, as the TPU kernel's guards give it
// (m_safe = 0 where the running max is -inf, alpha = 0 where the previous
// max is -inf, a denominator of 1 where the normalizer is 0); the oracle
// ref.gqa_attention gives NaN there.  GQA maps q head h to kv head
// h / (Hq / Hkv), as the TPU kernel's kv_map does.
//
// Layout: q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), out (B, Hq, Lq, D),
// each given by its (batch, head, position) strides in elements with the
// head_dim contiguous, so the model's (B, S, H, D) activations are read
// and written in place, with no transposed copy.  Ragged Lq and Lk are
// masked here: the wrapper never pads.
//
// Bound: at the serving prefill's shape (B 4, H 32, L 2,048, D 128,
// causal) in f32 the work is 1.375e11 FLOP against 537 MB of q, k, v and
// out; at the 67 TFLOP/s of f32 outside the tensor cores operations bound
// it (2.05 ms), not bytes.
// Design (f32 on the tensor cores would round to TF32, so f32 stays on the
// CUDA cores; this design's bf16 form, 6.8 ms at the prefill shape, gave
// way to the tensor-core kernel): one block of 256 threads per (b*Hq + h,
// 64-row q tile) keeps its q tile in shared memory as f32 and loops over
// 64-column k tiles.  Each thread holds a 4x4 patch of the score tile and
// a 4 x D/16 patch of the accumulator in registers, on the CUDA cores.
// Four threads own each row's running max and normalizer and reduce with
// warp shuffles.  K and then V of a tile share one shared-memory buffer,
// so a D=128 block needs 83,200 bytes and two blocks fit on an SM; rows
// are padded by one float so the threads of a warp read distinct banks.
// The k loop stops at the last tile a causal row can see.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;           // q rows per block
constexpr int kBlockK = 64;           // k columns per tile
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kPRow = kBlockK + 1;    // padded score row

struct Strides {
  long long b, h, s;                  // in elements; head_dim stride is 1
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);       // round to nearest even, as astype does
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (D + 1)      // q tile
                          + kBlockK * (D + 1)    // k tile, then v tile
                          + kBlockQ * kPRow      // scores, then p
                          + 2 * kBlockQ);        // alpha and l per row
}

// two blocks an SM: at most 128 registers a thread
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int Hq, int group, int Lq, int Lk, int causal,
                       float sm_scale) {
  constexpr int kRow = D + 1;
  constexpr int kCols = D / 16;       // accumulator columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_kv = s_q + kBlockQ * kRow;
  float* s_p = s_kv + kBlockK * kRow;
  float* s_alpha = s_p + kBlockQ * kPRow;
  float* s_l = s_alpha + kBlockQ;

  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / group;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;            // score / output columns tx + 16 j
  const int ty = tid / 16;            // rows ty + 16 i
  const int srow = tid / 4;           // softmax: 4 threads per row,
  const int spart = tid % 4;          // 16 columns each
  const int offset = Lk - Lq;         // end-aligned causal offset

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = out + b * os.b + h * os.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    s_q[r * kRow + c] = q0 + r < Lq ? to_float(qb[(q0 + r) * qs.s + c]) : 0.f;
  }

  int n_tiles = (Lk + kBlockK - 1) / kBlockK;
  if (causal) {
    // the last column any row of this tile sees; k tiles past it are
    // wholly in the future and skipped
    const int last_visible = min(q0 + kBlockQ, Lq) - 1 + offset;
    n_tiles = last_visible < 0 ? 0 : min(n_tiles, last_visible / kBlockK + 1);
  }

  float m_run = -INFINITY;            // held by the 4 threads of row srow
  float l_run = 0.f;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();                  // the last tile's v and p are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      s_kv[r * kRow + c] =
          k0 + r < Lk ? to_float(kb[(k0 + r) * ks.s + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty + 16 * i) * kRow + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_kv[(tx + 16 * j) * kRow + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool visible =
            k0 + c < Lk && (!causal || k0 + c <= q0 + r + offset);
        s_p[r * kPRow + c] = visible ? sc[i][j] * sm_scale : -INFINITY;
      }
    }
    __syncthreads();                  // scores written, k tile consumed

    // v tile into the k buffer, while the row owners update the softmax
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      s_kv[r * kRow + c] =
          k0 + r < Lk ? to_float(vb[(k0 + r) * vs.s + c]) : 0.f;
    }
    {
      float* row = s_p + srow * kPRow + spart * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m_run, mx);
      // guard fully masked rows: exp(-inf - -inf) would be NaN
      const float m_safe = m_cur == -INFINITY ? 0.f : m_cur;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float s = row[c];
        const float p = s == -INFINITY ? 0.f : expf(s - m_safe);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_safe);
      l_run = l_run * alpha + sum;
      m_run = m_cur;
      if (spart == 0) s_alpha[srow] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = s_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(ty + 16 * i) * kPRow + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = s_kv[kk * kRow + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) s_l[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Lq) continue;
    const float l = s_l[r];
    const float denom = l == 0.f ? 1.f : l;   // a fully masked row gives 0
    T* orow = ob + (q0 + r) * os.s;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      orow[tx + 16 * j] = from_float<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int Hq, int Hkv, int Lq, int Lk, int causal, float sm_scale,
                   cudaStream_t stream) {
  const auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Lq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, Hq,
      Hq / Hkv, Lq, Lk, causal, sm_scale);
  return cudaGetLastError();
}

// float32 at D 16, 32, 64 and 128; bfloat16 at D 16 and 32 only
template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v,
                       void* out, Strides qs, Strides ks, Strides vs,
                       Strides os, int B, int Hq, int Hkv, int Lq, int Lk,
                       int causal, float sm_scale, cudaStream_t stream) {
  if (D == 16)
    return launch<T, 16>(q, k, v, out, qs, ks, vs, os, B, Hq, Hkv, Lq, Lk,
                         causal, sm_scale, stream);
  if (D == 32)
    return launch<T, 32>(q, k, v, out, qs, ks, vs, os, B, Hq, Hkv, Lq, Lk,
                         causal, sm_scale, stream);
  if constexpr (std::is_same<T, float>::value) {
    if (D == 64)
      return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, Hq, Hkv, Lq, Lk,
                           causal, sm_scale, stream);
    if (D == 128)
      return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, Hq, Hkv, Lq, Lk,
                            causal, sm_scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on `stream` of card `device`.  dtype: 0 float32 (D 16,
// 32, 64 or 128), 1 bfloat16 (D 16 or 32); q, k, v and out alike.  Strides are in elements, in the
// order (batch, head, position) for q, k, v and out; head_dim is
// contiguous.  B * Hq, Lq and Lk must be positive.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int Hq, int Hkv,
                           int Lq, int Lk, int D, int causal, float sm_scale,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long o_sb, long long o_sh, long long o_ss,
                           int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  switch (dtype) {
    case 0:
      return (int)launch_dim<float>(D, q, k, v, out, qs, ks, vs, os, B, Hq,
                                    Hkv, Lq, Lk, causal, sm_scale, stream);
    case 1:
      return (int)launch_dim<__nv_bfloat16>(D, q, k, v, out, qs, ks, vs, os,
                                            B, Hq, Hkv, Lq, Lk, causal,
                                            sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
