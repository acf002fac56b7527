// Forward flash attention for Hopper (sm_90a) on the tensor cores in split
// TF32, bound to Python through ctypes: the route of float32 at every
// head_dim (bfloat16 runs on flash_attention_wgmma.cu).  It is
// instantiated at every multiple of 16 up to 256 in float32 (and up to 128
// in bfloat16, which takes the tensor cores); past 256 one wide kernel
// takes any multiple of 16 at run time, in float32.  The
// wrapper zero-pads a head_dim between them up to the next one (QK^T reads
// 16 head_dim columns at a time).
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
// (D / 2 f32 registers a thread, at most 128).  The k loop stops
// at the last tile a causal row of the block can see, and only tiles on
// the diagonal or the ragged end are masked.
//
// Past head_dim 128 a block still holds every output column of its q tile
// and computes QK^T once a kv tile: at 144-256 each warp holds O for 16
// rows and all of D (up to 128 f32 registers a thread), one block an SM
// past D 144.  Past 128 each warp counts the mma.sync products it
// issues, q.k and P.V apart, where it issues them, and adds them to the
// card's counts at its end (flash_attention_tf32x3_products), so that a
// caller sees QK^T issued once a kv tile; the instantiations up to 128
// count nothing.
//
// Past head_dim 256 (the wide kernel, float32) O no longer fits four
// warps' registers.  A block owns a 32-row q tile (2 row groups of 16)
// and every output column up to D 512; its warps are the row groups x
// column owners of 128 columns each (3 owners to D 384, 4 to 512, 64 f32
// registers of O a thread).  Owner w of a row group computes the partial S
// of head_dim columns 128w .. 128w + 127 (its q and K slices, split as
// above), writes it to shared memory, and every owner of the row group
// sums the group's partials in the owners' order: all hold the same S, run
// the same softmax and split the same P, and each runs P.V on its own 128
// columns of V.  The sum's order is fixed, so two launches give the same
// bits.  K and V tiles of 32 rows have 2 stages where shared memory allows,
// else 1: K of tile j + 1 then loads while tile j's softmax and P.V run, V
// of tile j + 1 while its QK^T runs.  Past D 512 the output's columns are
// cut into chunks of at most 384 on the grid (a 32-row O of all of D would
// no longer fit the registers of 8 warps) and QK^T runs in rounds of 384
// head_dim columns, q's slice loaded with K's.  Against the sliced kernel
// it replaces (four 128-column chunks a q tile at D 512, each recomputing
// and re-splitting QK^T over all of D), q is split once a kv tile, not once
// a kv tile and chunk, and K once a row group and kv tile.  (Splitting K
// and V once a kv tile into shared memory as they are staged would double
// their footprint: at D 512 q, K and V already take 218 KB.)
// Tried on the H100 and measured slower (PERF.md, Findings): this
// wide kernel at D 144-256 (64 q rows, 2 owners), 1.4-2.5x the one-chunk
// template's time: the partial S's, four barriers a tile and a last owner
// of 16 or 80 columns at D 144 and 208 cost more than QK^T's half; and two
// accumulators a warp for QK^T's independent products.

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
  // a block holds every output column of its q tile (up to D 256, 128 f32
  // registers of O a thread) and computes QK^T once a kv tile
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  // 32 keys past D 64: with 64 at D 112 the two stages would take 143 KB
  // and leave one block (4 warps) an SM
  static constexpr int kBlockK = D > 64 ? 32 : 64;
  // q and k rows are read 16 bytes a thread, a quarter warp at a time
  // over two rows: a row stride of 16 mod 32 words keeps those apart
  static constexpr int kQKRow = D % 32 == 16 ? D : D + 16;
  // v is read one word a thread from rows 2t and 2t + 1: a row stride of
  // 4 or 12 mod 16 words puts the four t on four distinct 8-bank groups
  static constexpr int kVRow = D + 4;
  static constexpr int kQWords = kBlockQ * kQKRow;
  static constexpr int kKWords = kBlockK * kQKRow;
  static constexpr int kVWords = kBlockK * kVRow;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kQWords + 2 * (kKWords + kVWords));
  // blocks an SM its shared memory allows: 228 KB an SM, 1 KB of it
  // reserved a block
  static constexpr int kMinBlocks =
      2 * (kSmemBytes + 1024) <= 228 * 1024 ? 2 : 1;
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

// FLOP of the products the kernels past head_dim 128 have issued since the
// last reset, counted by each warp where it issues them: [0] q.k, [1] P.V
__device__ unsigned long long g_products[2];
constexpr unsigned long long kMmaFlop = 2ull * 16 * 8 * 8;   // m16n8k8

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

// two blocks an SM up to D 144 (at most 113,664 bytes of shared memory),
// one past it
template <typename T, int D, bool kVec16>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
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
  // past D 128 each warp counts the products it issues (g_products)
  constexpr bool kCount = D > 128;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_k = s_q + Cfg::kQWords;            // two stages
  float* s_v = s_k + 2 * Cfg::kKWords;        // two stages

  // q tiles fastest within a head
  const int tile = (int)blockIdx.x;
  const int bh = tile / q_tiles;
  const int qt = q_tiles - 1 - tile % q_tiles;
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
  uint32_t n_qk = 0, n_pv = 0;                // products issued (kCount)
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
            if constexpr (kCount) n_qk += 3;
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
          if constexpr (kCount) n_pv += 3;
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
  if constexpr (kCount) {
    if (lane == 0) {
      atomicAdd(&g_products[0], kMmaFlop * n_qk);
      atomicAdd(&g_products[1], kMmaFlop * n_pv);
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

// every multiple of 16 up to 256 in float32, up to 128 in bfloat16
// (bfloat16 is the tensor-core route's; its instantiations serve tests of
// this library and the bf16 tests' padded head_dims)
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
  // float32 takes 144-256 here too (bfloat16 runs on the tensor cores)
  if constexpr (std::is_same<T, float>::value) switch (D) {
    FA_HEAD_DIM(144)
    FA_HEAD_DIM(160)
    FA_HEAD_DIM(176)
    FA_HEAD_DIM(192)
    FA_HEAD_DIM(208)
    FA_HEAD_DIM(224)
    FA_HEAD_DIM(240)
    FA_HEAD_DIM(256)
  }
#undef FA_HEAD_DIM
  return cudaErrorInvalidValue;
}

// -- past head_dim 256: a block owns a q tile and every output column -----

constexpr int kWideBlockK = 32;        // kv rows a tile
constexpr int kOwnerColumns = 128;     // q.k and output columns a warp
constexpr int kWideThreads = 256;      // the most a block has: 8 warps
constexpr int kMaxWideSmem = 232448;   // a block's shared memory

// The wide kernel's geometry at head_dim D (past 256), the same on the host
// and the card.  Up to D 512 a block owns a 32-row q tile (so that q, K and
// V fit shared memory) and all of D's output columns; past it the columns
// are cut into chunks of at most 384 (a multiple of 64, the last
// narrower), one a block.  Its warps are row groups of 16 q rows x
// `owners` column owners of 128 columns each.  QK^T runs in rounds of
// owners x 128 head_dim columns: one up to D 512, q then staying in shared
// memory; past it q's slice of a round is loaded with K's.
struct WideLayout {
  int chunk_cols, chunks, owners, rows, warps, width, rounds;
  bool q_resident;
  int qk_row, v_row;                  // row strides in floats
  int q_words, k_words, v_words, part_words;
  int stages;                         // of K and of V: 2 where they fit

  __host__ __device__ explicit WideLayout(int D) {
    const int per = D <= 512 ? 1 : (D + 383) / 384;
    chunk_cols = per == 1 ? D : ((D + per - 1) / per + 63) / 64 * 64;
    chunks = (D + chunk_cols - 1) / chunk_cols;
    owners = (chunk_cols + kOwnerColumns - 1) / kOwnerColumns;
    rows = 32;
    warps = rows / 16 * owners;
    width = owners * kOwnerColumns;
    rounds = (D + width - 1) / width;
    q_resident = rounds == 1;
    // 16 mod 32 words, as Tile's kQKRow; 4 mod 16 words, as Tile's kVRow
    const int w = q_resident ? D : width;
    qk_row = w % 32 == 16 ? w : w + 16;
    v_row = chunk_cols + 4;
    q_words = rows * qk_row;
    k_words = kWideBlockK * qk_row;
    v_words = kWideBlockK * v_row;
    part_words = warps * 16 * 32;     // each warp's S fragments
    stages = q_resident && words(2) * sizeof(float) <= kMaxWideSmem ? 2 : 1;
  }
  __host__ __device__ int words(int n) const {
    return q_words + n * (k_words + v_words) + part_words;
  }
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(float) * words(stages);
  }
};

// rows [row0, row0 + rows) of `cols` float32 columns (a multiple of 4)
// from `src`, rows `stride` apart, into shared rows of `dst_row` floats by
// cp.async, 16 bytes (kVec16) or 4 a copy, `threads` threads sharing the
// copies; rows at or past L are zero
template <bool kVec16>
__device__ __forceinline__ void load_columns(float* dst, int dst_row,
                                             const float* src,
                                             long long stride, int row0,
                                             int rows, int L, int cols,
                                             int threads) {
  constexpr int kChunk = kVec16 ? 4 : 1;
  const int per_row = cols / kChunk;
  for (int i = threadIdx.x; i < rows * per_row; i += threads) {
    const int r = i / per_row, c = i % per_row * kChunk;
    const bool ok = row0 + r < L;
    const float* p = src + (ok ? (long long)(row0 + r) * stride + c : 0);
    if constexpr (kVec16)
      cp_async16(dst + r * dst_row + c, p, ok);
    else
      cp_async4(dst + r * dst_row + c, p, ok);
  }
}

// S[NT] += q . k over `groups` 16-column groups of one warp's slice, each
// f32 operand split into TF32 big and small parts (kGroups: a count known
// at compile time, so that the loop unrolls and its loads run ahead; 0
// takes `groups`); n_qk counts the m16n8k8 products issued
template <int kGroups, int NT>
__device__ __forceinline__ void qk_slice(float (&s)[NT][4], const float* q_lo,
                                         const float* q_hi, const float* Ks,
                                         int k_row, int groups,
                                         uint32_t& n_qk) {
  const int n_groups = kGroups > 0 ? kGroups : groups;
#pragma unroll
  for (int dg = 0; dg < n_groups; ++dg) {
    const float4 qa = *reinterpret_cast<const float4*>(q_lo + dg * 16);
    const float4 qc = *reinterpret_cast<const float4*>(q_hi + dg * 16);
    const float a_raw[2][4] = {{qa.x, qc.x, qa.y, qc.y},
                               {qa.z, qc.z, qa.w, qc.w}};
    uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
    for (int ksi = 0; ksi < 2; ++ksi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(a_raw[ksi][e], a_big[ksi][e], a_small[ksi][e]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 kk =
          *reinterpret_cast<const float4*>(Ks + n * 8 * k_row + dg * 16);
      const float b_raw[2][2] = {{kk.x, kk.y}, {kk.z, kk.w}};
#pragma unroll
      for (int ksi = 0; ksi < 2; ++ksi) {
        uint32_t b_big[2], b_small[2];
        split(b_raw[ksi][0], b_big[0], b_small[0]);
        split(b_raw[ksi][1], b_big[1], b_small[1]);
        mma(s[n], a_small[ksi], b_big[0], b_big[1]);
        mma(s[n], a_big[ksi], b_small[0], b_small[1]);
        mma(s[n], a_big[ksi], b_big[0], b_big[1]);
        n_qk += 3;
      }
    }
  }
}

// O[ND] += P V over `tiles` 8-column n-tiles of one warp's columns, P's
// C fragments as A (kTiles as kGroups above); n_pv counts the products
template <int kTiles, int NT, int ND>
__device__ __forceinline__ void pv_slice(float (&o)[ND][4],
                                         const float (&s)[NT][4],
                                         const float* Vs, int v_row,
                                         int tiles, uint32_t& n_pv) {
  const int n_tiles = kTiles > 0 ? kTiles : tiles;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float p_raw[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
    uint32_t p_big[4], p_small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(p_raw[e], p_big[e], p_small[e]);
    const float* v0 = Vs + n * 8 * v_row;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      if (j >= n_tiles) break;
      const float b0 = v0[j * 8], b1 = v0[v_row + j * 8];
      uint32_t v_big[2], v_small[2];
      split(b0, v_big[0], v_small[0]);
      split(b1, v_big[1], v_small[1]);
      mma(o[j], p_small, v_big[0], v_big[1]);
      mma(o[j], p_big, v_small[0], v_small[1]);
      mma(o[j], p_big, v_big[0], v_big[1]);
      n_pv += 3;
    }
  }
}

// float32 past D 256 only; one block an SM (up to 218 KB of shared memory)
template <bool kVec16>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_attention_tf32x3_wide_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   float* __restrict__ out, Strides qs,
                                   Strides ks, Strides vs, Strides os, int Hq,
                                   int group, int Lq, int Lk, int D,
                                   int q_tiles, int causal, float scale_log2) {
  constexpr int BK = kWideBlockK;
  constexpr int NT = BK / 8;              // score n-tiles of a warp
  constexpr int ND = kOwnerColumns / 8;   // output n-tiles of a warp
  const WideLayout lay(D);
  const int threads = 32 * lay.warps;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_k = s_q + lay.q_words;                 // stages slots
  float* s_v = s_k + lay.stages * lay.k_words;    // stages slots
  float* s_part = s_v + lay.stages * lay.v_words;

  // chunks fastest, then q tiles, longest first
  const int chunk = (int)(blockIdx.x % lay.chunks);
  const int tile = (int)(blockIdx.x / lay.chunks);
  const int bh = tile / q_tiles;
  const int qt = q_tiles - 1 - tile % q_tiles;
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int q0 = qt * lay.rows;
  const int c0 = chunk * lay.chunk_cols;          // first output column
  const int c_cols = min(lay.chunk_cols, D - c0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;           // mma group, thread in group
  const int rg = warp / lay.owners;               // row group: 16 q rows
  const int cw = warp % lay.owners;               // column owner
  const int offset = Lk - Lq;                     // end-aligned causal offset
  // this warp's output columns of the chunk (none past its end)
  const int out_cols = min(kOwnerColumns, c_cols - kOwnerColumns * cw);

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h + c0;
  float* ob = out + b * os.b + h * os.h + c0;

  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) {
    // the last column any row of this tile sees; later k tiles are skipped
    const int last_visible = min(q0 + lay.rows, Lq) - 1 + offset;
    n_tiles = last_visible < 0 ? 0 : min(n_tiles, last_visible / BK + 1);
  }
  // K's columns of round r of tile j into its slot, with q's unless q
  // stays; V's chunk of tile j into its slot
  auto load_k = [&](int j, int r) {
    const int c = r * lay.width;
    const int cols = min(lay.width, D - c);
    load_columns<kVec16>(s_k + j % lay.stages * lay.k_words, lay.qk_row,
                         kb + c, ks.s, j * BK, BK, Lk, cols, threads);
    if (!lay.q_resident)
      load_columns<kVec16>(s_q, lay.qk_row, qb + c, qs.s, q0, lay.rows, Lq,
                           cols, threads);
  };
  auto load_v = [&](int j) {
    load_columns<kVec16>(s_v + j % lay.stages * lay.v_words, lay.v_row, vb,
                         vs.s, j * BK, BK, Lk, c_cols, threads);
  };
  // cp.async groups in order: K and V of tiles 0 .. stages - 1, then for
  // each tile j, K of tile j + stages once tile j's QK^T is done and V of
  // tile j + stages once its P.V is done; a wait leaves 2 stages - 1
  // younger groups in flight.  With one stage, K of tile j + 1 loads while
  // tile j's softmax and P.V run, V of tile j + 1 while its QK^T runs.
  if (n_tiles > 0 && lay.q_resident)
    load_columns<kVec16>(s_q, lay.qk_row, qb, qs.s, q0, lay.rows, Lq, D,
                         threads);
  for (int j = 0; j < lay.stages; ++j) {
    if (j < n_tiles) load_k(j, 0);
    cp_async_commit();
    if (j < n_tiles) load_v(j);
    cp_async_commit();
  }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};    // rows g and g + 8
  float l_part[2] = {0.f, 0.f};               // this thread's columns only
  uint32_t n_qk = 0, n_pv = 0;                // products issued
  const int row_lo = q0 + rg * 16 + g;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    // -- this warp's partial S: q . k over its 128 columns of each round
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int r = 0; r < lay.rounds; ++r) {
      if (r > 0)
        cp_async_wait<0>();                   // the round just loaded
      else if (lay.stages == 2)
        cp_async_wait<3>();
      else
        cp_async_wait<1>();
      __syncthreads();
      const int cols = min(lay.width, D - r * lay.width);
      const int groups =
          max(0, min(kOwnerColumns, cols - kOwnerColumns * cw)) / 16;
      const float* q_lo =
          s_q + (rg * 16 + g) * lay.qk_row + kOwnerColumns * cw + 4 * t;
      const float* Ks = s_k + it % lay.stages * lay.k_words +
                        g * lay.qk_row + kOwnerColumns * cw + 4 * t;
      if (groups == kOwnerColumns / 16)
        qk_slice<kOwnerColumns / 16>(s, q_lo, q_lo + 8 * lay.qk_row, Ks,
                                     lay.qk_row, groups, n_qk);
      else
        qk_slice<0>(s, q_lo, q_lo + 8 * lay.qk_row, Ks, lay.qk_row, groups,
                    n_qk);
      if (r + 1 < lay.rounds) {
        __syncthreads();                      // the round's slot is read
        load_k(it, r + 1);
        cp_async_commit();
      }
    }

    // -- the row group's partial S's meet in shared memory; every owner
    // sums them in the owners' order, so all hold the same S and P
    float* mine = s_part + warp * 512;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32 + lane] = s[n][e];
    __syncthreads();                          // K is read, every part written
    if (it + lay.stages < n_tiles) load_k(it + lay.stages, 0);
    cp_async_commit();
    const float* row_parts = s_part + rg * lay.owners * 512;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = row_parts[(n * 4 + e) * 32 + lane];
        for (int w = 1; w < lay.owners; ++w)
          x += row_parts[w * 512 + (n * 4 + e) * 32 + lane];
        s[n][e] = x;
      }

    // -- online softmax in registers, base 2, as in the kernel above
    const bool edge = k0 + BK > Lk ||
                      (causal && k0 + BK - 1 > q0 + rg * 16 + offset);
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

    // -- O += P V over this warp's columns of the chunk
    if (lay.stages == 2)
      cp_async_wait<3>();                     // V of this tile has landed
    else
      cp_async_wait<1>();
    __syncthreads();
    const float* Vs = s_v + it % lay.stages * lay.v_words +
                      2 * t * lay.v_row + kOwnerColumns * cw + g;
    if (out_cols == kOwnerColumns)
      pv_slice<ND>(o, s, Vs, lay.v_row, ND, n_pv);
    else
      pv_slice<0>(o, s, Vs, lay.v_row, max(0, out_cols) / 8, n_pv);
    __syncthreads();                          // V's slot is read
    if (it + lay.stages < n_tiles) load_v(it + lay.stages);
    cp_async_commit();
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
    float* orow = ob + (long long)row * os.s + kOwnerColumns * cw + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      if (8 * j >= out_cols) break;
      orow[j * 8] = o[j][2 * i] * inv;
      orow[j * 8 + 1] = o[j][2 * i + 1] * inv;
    }
  }
  if (lane == 0) {
    atomicAdd(&g_products[0], kMmaFlop * n_qk);
    atomicAdd(&g_products[1], kMmaFlop * n_pv);
  }
}

template <bool kVec16>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, Strides qs, Strides ks, Strides vs,
                        Strides os, int B, int Hq, int Hkv, int Lq, int Lk,
                        int D, int causal, float scale_log2,
                        cudaStream_t stream) {
  const auto kernel = flash_attention_tf32x3_wide_kernel<kVec16>;
  const WideLayout lay(D);
  const size_t smem = lay.smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Lq + lay.rows - 1) / lay.rows;
  const long long blocks = (long long)B * Hq * q_tiles * lay.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, 32 * lay.warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), qs, ks, vs, os,
      Hq, Hq / Hkv, Lq, Lk, D, q_tiles, causal, scale_log2);
  return cudaGetLastError();
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.h % 4 == 0 && s.s % 4 == 0;
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on `stream` of card `device`.  dtype: 0 float32, 1
// bfloat16, q, k, v and out alike; D a positive multiple of 16, up to 256
// in bfloat16.
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
  if (D > 256 && D % 16 == 0 && dtype == 0)
    return (int)(vec16 ? launch_wide<true>(q, k, v, out, qs, ks, vs, os, B, Hq,
                                           Hkv, Lq, Lk, D, causal, scale_log2,
                                           stream)
                       : launch_wide<false>(q, k, v, out, qs, ks, vs, os, B,
                                            Hq, Hkv, Lq, Lk, D, causal,
                                            scale_log2, stream));
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

// The FLOP of the products the kernels past head_dim 128 have issued on
// card `device` since the last reset, as their warps count them where they
// issue each one (each split-TF32 product three m16n8k8 ones): q.k into
// flop[0], P.V into flop[1].  reset != 0 zeroes the counts after reading
// them.  Returns a CUDA error (0 on success); synchronizes with the card's
// work on the legacy stream.
int flash_attention_tf32x3_products(long long* flop, int reset, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(flop, g_products, 2 * sizeof(long long));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    err = cudaMemcpyToSymbol(g_products, zero, sizeof zero);
  }
  return (int)err;
}

// Blocks the kernel gives a q tile at head_dim D (a positive multiple of
// 16) in float32: 1 up to 512, past it WideLayout(D).chunks; 0 for another
// D.
int flash_attention_tf32x3_chunks(int D) {
  if (D % 16 != 0 || D < 16) return 0;
  return D > 256 ? WideLayout(D).chunks : 1;
}

}  // extern "C"
