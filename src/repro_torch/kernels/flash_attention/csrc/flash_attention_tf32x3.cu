// Forward flash attention for Hopper (sm_90a) on the tensor cores in split
// TF32, bound to Python through ctypes: the route of float32 at every
// head_dim and of bfloat16 at every head_dim but 64 and 128, which run on
// flash_attention_wgmma.cu.  It is instantiated at every multiple of 16 up
// to 128, in both types; the wrapper zero-pads a head_dim between them up
// to the next one (QK^T reads 16 head_dim columns at a time).
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
// sequence.  A row that sees no column comes out 0, as the TPU kernel's
// guards give it (m_safe = 0 where the running max is -inf, a
// denominator of 1 where the normalizer is 0).  GQA maps q head h to kv
// head h / (Hq / Hkv).  q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D) and out
// (B, Hq, Lq, D) are given by their (batch, head, position) strides in
// elements with the head_dim contiguous, so the model's (B, S, H, D)
// activations are read in place.  Ragged Lq and Lk are masked here.
//
// Split TF32.  The tensor cores take TF32 (10 mantissa bits), so each f32
// operand x is split into big = x rounded to TF32 and small = x - big
// truncated to TF32, and a product is the sum of three mma.sync.m16n8k8
// TF32 products, small terms first: small*big, big*small, big*big (what
// CUTLASS's OpMultiplyAddFastF32 does).  The dropped small*small and the
// truncation of the small parts leave about 2^-21 of relative error a
// product, far inside f32 attention's 2e-5.  A bfloat16
// value is exact in TF32, so bfloat16 q and k take one product for QK^T,
// and P.V two (P is f32 and splits; V does not).  exp is ex2.approx.ftz
// on scores pre-scaled by sm_scale * log2(e).
//
// Bound: at the serving prefill's shape (B 4, H 32, L 2,048, D 128,
// causal) in f32 the work is 1.3751e11 FLOP, three times over in TF32:
// 0.833 ms at the H100's 495 TFLOP/s, against 537 MB of q, k, v and out
// (0.16 ms): operations bound it.  (The CUDA-core design this replaces was
// bound at 2.05 ms by 67 TFLOP/s of f32 FMAs and ran at 6.8 ms.)
//
// Design: one block of 4 warps per 64-row q tile, on a 1-D grid with q
// tiles fastest within a head (the heavy causal tiles first), so a head's
// K and V stay in L2 over its q tiles.  Each warp owns 16 q rows.  The q
// tile stays in shared memory; K and V tiles of kBlockK rows (32 past D 64,
// else 64) are loaded with cp.async, 16 bytes where the bases and strides
// allow, else 4 (a bfloat16 tile is converted on a plain load), into two
// stages, so tile t+1 loads while tile t is used.  S = QK^T stays in
// registers (mma C fragments); the online softmax runs there, with quad
// shuffles for a row's max and a per-thread partial normalizer.  P feeds
// P.V straight from the C fragments: the k index of an m16n8k8 product
// may be permuted as long as A and B agree, so A's k slots t and t+4 are
// taken as columns 2t and 2t+1, which a thread already holds, and V's
// rows are read in the same order.  QK^T permutes its k index the same
// way over 16 head_dim columns, so a thread's q and k fragments are one
// 16-byte shared load each.  Row strides are padded so that those loads
// and V's scalar loads meet no bank conflict.  O accumulates in registers
// (D/2 of them a thread).  The k loop stops at the last tile a causal row
// of the block can see, and only tiles on the diagonal or the ragged end
// are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;           // q rows a block
constexpr int kWarps = kBlockQ / 16;  // 16 q rows a warp
constexpr int kThreads = 32 * kWarps;

struct Strides {
  long long b, h, s;                  // in elements; head_dim stride is 1
};

template <int D>
struct Tile {
  // 32 keys past D 64: with 64 at D 112 the two stages would take 143 KB
  // and leave one block (4 warps) an SM
  static constexpr int kBlockK = D > 64 ? 32 : 64;
  // q and k rows are read 16 bytes a thread, a quarter warp at a time
  // over two rows: a row stride of 16 mod 32 words keeps those apart
  static constexpr int kQKRow = D % 32 == 16 ? D : D + 16;
  // v is read one word a thread from rows 2t and 2t + 1: 4 mod 32 words
  static constexpr int kVRow = D + 4;
  static constexpr int kQWords = kBlockQ * kQKRow;
  static constexpr int kKWords = kBlockK * kQKRow;
  static constexpr int kVWords = kBlockK * kVRow;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kQWords + 2 * (kKWords + kVWords));
};

// x = big + small, each a TF32 value (10 mantissa bits, the low 13 bits
// clear).  big is x rounded to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite value: half of the 13 dropped bits is
// added to the magnitude, then they are cleared.  small = x - big is exact
// in f32 and is truncated to TF32.  All of it is integer and f32 work at
// the full rate: cvt.rna.tf32.f32 runs on the conversion pipe, at a
// fraction of that rate, and bounded this kernel when it split with it.
// Error: |x - big - small| <= 2^-10 |small| <= 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c += a * b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows [row0, row0 + rows) of a (L, D) slab with row stride `stride`
// elements into shared rows of `dst_row` floats; rows at or past L are
// zero.  float: cp.async of 16 bytes (kVec16) or 4; bfloat16: a plain
// load converted to f32 (exact).
template <typename T, int D, bool kVec16>
__device__ __forceinline__ void load_rows(float* dst, int dst_row,
                                          const T* src, long long stride,
                                          int row0, int rows, int L) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kChunk = kVec16 ? 4 : 1;
    constexpr int kPerRow = D / kChunk;
    for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = i % kPerRow * kChunk;
      const bool ok = row0 + r < L;
      const T* p = src + (ok ? (long long)(row0 + r) * stride + c : 0);
      if constexpr (kVec16)
        cp_async16(dst + r * dst_row + c, p, ok);
      else
        cp_async4(dst + r * dst_row + c, p, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      dst[r * dst_row + c] =
          row0 + r < L ? __bfloat162float(src[(long long)(row0 + r) * stride
                                              + c])
                       : 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);       // round to nearest even, as astype does
}

// two blocks an SM: shared memory allows it at every D (at most 107,520
// bytes, at D 128)
template <typename T, int D, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_tf32x3_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              Strides qs, Strides ks, Strides vs, Strides os,
                              int Hq, int group, int Lq, int Lk, int q_tiles,
                              int causal, float scale_log2) {
  using Cfg = Tile<D>;
  constexpr int BK = Cfg::kBlockK;
  constexpr int NT = BK / 8;          // score n-tiles of a warp
  constexpr int ND = D / 8;           // output n-tiles of a warp
  constexpr int QK = Cfg::kQKRow, VR = Cfg::kVRow;
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_k = s_q + Cfg::kQWords;            // two stages
  float* s_v = s_k + 2 * Cfg::kKWords;        // two stages

  const int bh = blockIdx.x / q_tiles;
  const int qt = q_tiles - 1 - (int)(blockIdx.x % q_tiles);
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int q0 = qt * kBlockQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;       // mma group, thread in group
  const int offset = Lk - Lq;                 // end-aligned causal offset

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = out + b * os.b + h * os.h;

  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) {
    // the last column any row of this tile sees; later k tiles are skipped
    const int last_visible = min(q0 + kBlockQ, Lq) - 1 + offset;
    n_tiles = last_visible < 0 ? 0 : min(n_tiles, last_visible / BK + 1);
  }

  load_rows<T, D, kVec16>(s_q, QK, qb, qs.s, q0, kBlockQ, Lq);
  if (n_tiles > 0) {
    load_rows<T, D, kVec16>(s_k, QK, kb, ks.s, 0, BK, Lk);
    load_rows<T, D, kVec16>(s_v, VR, vb, vs.s, 0, BK, Lk);
  }
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};    // rows g and g + 8
  float l_part[2] = {0.f, 0.f};               // this thread's columns only
  const int row_lo = q0 + warp * 16 + g;
  const float* q_lo = s_q + (warp * 16 + g) * QK + 4 * t;
  const float* q_hi = q_lo + 8 * QK;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    const int st = it & 1;
    if (it + 1 < n_tiles) {                   // the next tile, other stage
      load_rows<T, D, kVec16>(s_k + (st ^ 1) * Cfg::kKWords, QK, kb, ks.s,
                              k0 + BK, BK, Lk);
      load_rows<T, D, kVec16>(s_v + (st ^ 1) * Cfg::kVWords, VR, vb, vs.s,
                              k0 + BK, BK, Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();                       // this tile has landed
    __syncthreads();
    const float* Ks = s_k + st * Cfg::kKWords + g * QK + 4 * t;
    const float* Vs = s_v + st * Cfg::kVWords + 2 * t * VR + g;

    // -- S = Q K^T: k slots t and t + 4 of the two k-steps of a 16-column
    // group are head_dim columns 4t, 4t + 1 and 4t + 2, 4t + 3
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int dg = 0; dg < D / 16; ++dg) {
      const float4 qa = *reinterpret_cast<const float4*>(q_lo + dg * 16);
      const float4 qc = *reinterpret_cast<const float4*>(q_hi + dg * 16);
      const float a_raw[2][4] = {{qa.x, qc.x, qa.y, qc.y},
                                 {qa.z, qc.z, qa.w, qc.w}};
      uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
      for (int ksi = 0; ksi < 2; ++ksi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kSplit)
            split(a_raw[ksi][e], a_big[ksi][e], a_small[ksi][e]);
          else
            a_big[ksi][e] = __float_as_uint(a_raw[ksi][e]);
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 kk =
            *reinterpret_cast<const float4*>(Ks + n * 8 * QK + dg * 16);
        const float b_raw[2][2] = {{kk.x, kk.y}, {kk.z, kk.w}};
#pragma unroll
        for (int ksi = 0; ksi < 2; ++ksi) {
          if constexpr (kSplit) {
            uint32_t b_big[2], b_small[2];
            split(b_raw[ksi][0], b_big[0], b_small[0]);
            split(b_raw[ksi][1], b_big[1], b_small[1]);
            mma(s[n], a_small[ksi], b_big[0], b_big[1]);
            mma(s[n], a_big[ksi], b_small[0], b_small[1]);
            mma(s[n], a_big[ksi], b_big[0], b_big[1]);
          } else {
            mma(s[n], a_big[ksi], __float_as_uint(b_raw[ksi][0]),
                __float_as_uint(b_raw[ksi][1]));
          }
        }
      }
    }

    // -- online softmax in registers, base 2.  s[n][e] is row
    // row_lo + 8 * (e / 2), column k0 + 8 n + 2 t + e % 2.
    const bool edge = k0 + BK > Lk ||
                      (causal && k0 + BK - 1 > q0 + warp * 16 + offset);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int row = row_lo + 8 * (e >> 1);
          if (col >= Lk || (causal && col > row + offset)) x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // guard fully masked rows: -inf - -inf would be NaN
      m_safe[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = ex2(m_run[i] - m_safe[i]);   // 0 while m_run is -inf
      m_run[i] = mx[i];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[n][e] - m_safe[e >> 1]);   // 0 where masked
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_part[i] = l_part[i] * alpha[i] + sum[i];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // -- O += P V: A's k slots t and t + 4 are columns 2t and 2t + 1 of
    // the 8-column step, so P's C fragment is its A fragment as it lies
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p_raw[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
      uint32_t p_big[4], p_small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(p_raw[e], p_big[e], p_small[e]);
      const float* v0 = Vs + n * 8 * VR;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float b0 = v0[j * 8], b1 = v0[VR + j * 8];
        if constexpr (kSplit) {
          uint32_t v_big[2], v_small[2];
          split(b0, v_big[0], v_small[0]);
          split(b1, v_big[1], v_small[1]);
          mma(o[j], p_small, v_big[0], v_big[1]);
          mma(o[j], p_big, v_small[0], v_small[1]);
          mma(o[j], p_big, v_big[0], v_big[1]);
        } else {
          mma(o[j], p_small, __float_as_uint(b0), __float_as_uint(b1));
          mma(o[j], p_big, __float_as_uint(b0), __float_as_uint(b1));
        }
      }
    }
    __syncthreads();                          // this stage is free again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_lo + 8 * i;
    if (row >= Lq) continue;
    const float inv = 1.f / (l == 0.f ? 1.f : l);  // a masked row gives 0
    T* orow = ob + (long long)row * os.s + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      orow[j * 8] = from_float<T>(o[j][2 * i] * inv);
      orow[j * 8 + 1] = from_float<T>(o[j][2 * i + 1] * inv);
    }
  }
}

template <typename T, int D, bool kVec16>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int Hq, int Hkv, int Lq, int Lk, int causal,
                   float scale_log2, cudaStream_t stream) {
  const auto kernel = flash_attention_tf32x3_kernel<T, D, kVec16>;
  constexpr size_t smem = Tile<D>::kSmemBytes;
  // above 48 KB a block's shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Lq + kBlockQ - 1) / kBlockQ;
  const long long blocks = (long long)B * Hq * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, Hq,
      Hq / Hkv, Lq, Lk, q_tiles, causal, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_vec(bool vec16, const void* q, const void* k,
                       const void* v, void* out, Strides qs, Strides ks,
                       Strides vs, Strides os, int B, int Hq, int Hkv, int Lq,
                       int Lk, int causal, float scale_log2,
                       cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec16)
      return launch<T, D, true>(q, k, v, out, qs, ks, vs, os, B, Hq, Hkv, Lq,
                                Lk, causal, scale_log2, stream);
  }
  return launch<T, D, false>(q, k, v, out, qs, ks, vs, os, B, Hq, Hkv, Lq,
                             Lk, causal, scale_log2, stream);
}

// every multiple of 16 up to 128, in float32 and bfloat16 (bfloat16 at 64
// and 128 is the tensor-core route's, and here serves a padded head_dim)
template <typename T>
cudaError_t launch_dim(int D, bool vec16, const void* q, const void* k,
                       const void* v, void* out, Strides qs, Strides ks,
                       Strides vs, Strides os, int B, int Hq, int Hkv, int Lq,
                       int Lk, int causal, float scale_log2,
                       cudaStream_t stream) {
#define FA_HEAD_DIM(DIM)                                                     \
  case DIM:                                                                  \
    return launch_vec<T, DIM>(vec16, q, k, v, out, qs, ks, vs, os, B, Hq,    \
                              Hkv, Lq, Lk, causal, scale_log2, stream);
  switch (D) {
    FA_HEAD_DIM(16)
    FA_HEAD_DIM(32)
    FA_HEAD_DIM(48)
    FA_HEAD_DIM(64)
    FA_HEAD_DIM(80)
    FA_HEAD_DIM(96)
    FA_HEAD_DIM(112)
    FA_HEAD_DIM(128)
  }
#undef FA_HEAD_DIM
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.h % 4 == 0 && s.s % 4 == 0;
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on `stream` of card `device`.  dtype: 0 float32, 1
// bfloat16, q, k, v and out alike; D a multiple of 16 up to 128.
// Strides are in elements, in the order (batch, head, position) for q, k,
// v and out; head_dim is contiguous.  B * Hq, Lq and Lk must be positive.
// float32 q, k and v are copied 16 bytes at a time when each base is
// 16-byte aligned and each stride a multiple of 4 elements, else 4.
int flash_attention_tf32x3_launch(const void* q, const void* k, const void* v,
                                  void* out, int dtype, int B, int Hq, int Hkv,
                                  int Lq, int Lk, int D, int causal,
                                  float sm_scale, long long q_sb,
                                  long long q_sh, long long q_ss,
                                  long long k_sb, long long k_sh,
                                  long long k_ss, long long v_sb,
                                  long long v_sh, long long v_ss,
                                  long long o_sb, long long o_sh,
                                  long long o_ss, int device,
                                  cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const bool vec16 = aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs);
  const float scale_log2 = (float)((double)sm_scale * 1.4426950408889634);
  switch (dtype) {
    case 0:
      return (int)launch_dim<float>(D, vec16, q, k, v, out, qs, ks, vs, os, B,
                                    Hq, Hkv, Lq, Lk, causal, scale_log2,
                                    stream);
    case 1:
      return (int)launch_dim<__nv_bfloat16>(D, vec16, q, k, v, out, qs, ks,
                                            vs, os, B, Hq, Hkv, Lq, Lk, causal,
                                            scale_log2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
