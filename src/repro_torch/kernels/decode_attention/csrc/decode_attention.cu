// Single-token decode attention over a KV cache (flash-decoding) for
// Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces no TPU kernel: the JAX package's decode_attention
// (src/repro/models/attention.py) calls its plain _reference_attention.
// It was added because decode attention over a long cache is bound by
// the bytes of the cache alone, and the plain path upcast the whole
// cache to float32 (a copy written and read back) every layer and step.
//
// What it computes, for each batch row b and q head g (kv head
// g / (Hq / Hkv)), with the valid cache prefix [0, valid):
//
//   out[b,g] = sum_c p[c] v[b,c,h] / sum_c p[c]
//   p[c]     = exp(q[b,g] . k[b,c,h] * sm_scale - m)
//
// as _reference_attention(q, k, v, causal=False, kv_valid=valid) does:
// scores, softmax and the weighted sum in float32 whatever the cache's
// type (a bfloat16 value is exact in float32), the output rounded once to
// the input type.  Only the order of the sums differs.  exp is
// ex2.approx.ftz on scores pre-scaled by sm_scale * log2(e).
//
// Bound: far below the card's 295 FLOP/B line (two FMAs per cached value
// and q head), so only bytes count.  At the benchmark's decode batch (B
// 64, 32 heads of 128, 1,088 valid positions, bfloat16) one call reads
// 1.141 GB of k and v: 0.341 ms at 3.35 TB/s.
//
// Design:
// - Grid: one block per (kv head, head chunk, kv split, batch row), kv
//   heads fastest, so that neighbouring blocks read neighbouring pieces of
//   each cache row.  A block holds up to 16 q heads of its kv head (its
//   head chunk; more heads take more chunks) and reads each k and v row
//   of its split once, whatever the GQA group.
// - Threads: 128 as (tx, ty, tz).  bdx lanes (a power of two, 8 columns
//   each, >= D / 8) cover a row's head_dim; bdy groups of lanes share the
//   block's q heads, HPT heads each; bdz groups take different rows.  q
//   (pre-scaled) and O live in registers: 8 columns x HPT heads a thread.
// - Loads: only the valid rows, 16 bytes a cp.async, into a ring of
//   kStages stages of kRows rows of k and of v in shared memory: while a
//   tile is used, the next kStages - 1 are in flight.  A row past the
//   split's end and the columns past D are zero-filled (src-size 0), so a
//   masked row adds exactly 0.
// - Softmax: online, per thread, over the rows its tz takes; a tile's
//   scores are reduced across the bdx lanes by xor shuffles, and each tz
//   keeps its own running max, sum and accumulator in float32.  At the end
//   the bdz partial states meet in shared memory in a fixed order.
// - Splits: the wrapper picks them from the shapes (ops.plan).  With one
//   split the block writes the output; with more, each block writes its
//   (max, sum, accumulator) in float32 to scratch, and a second kernel
//   merges a row's splits in order.  No atomics: outputs do not change
//   from run to run.
// - Types and head_dims: float32 and bfloat16 (one template), any multiple
//   of 16 up to 256.  Strides (batch, position, head) of k and v are read,
//   so a layer's view of the stacked cache goes in without a copy; their
//   bases and strides must allow 16-byte copies (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;        // ring stages of k and v tiles
constexpr int kCols = 8;          // head_dim columns a thread holds
constexpr int kMaxHeads = 16;     // q heads a block holds
constexpr int kMaxDim = 256;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements a 16-byte copy
  static constexpr int kRows = 2; // rows a thread takes a tile
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kRows = 4;
};

struct Params {
  int Hq, Hkv, D, group, chunks, splits, chunk_rows, valid;
  int lbx, lby;                   // log2 of bdx and bdy
  float scale_log2;               // sm_scale * log2(e)
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

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
  return __float2bfloat16(x);     // round to nearest even, as .to() does
}

// The thread's 8 columns of a shared-memory row: 16-byte vectors
// v * bdx + tx, v < 8 / kVec (consecutive lanes on consecutive vectors).
__device__ __forceinline__ void load_cols(const float* row, int tx, int bdx,
                                          float (&x)[kCols]) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const float4 w = reinterpret_cast<const float4*>(row)[v * bdx + tx];
    x[4 * v] = w.x; x[4 * v + 1] = w.y; x[4 * v + 2] = w.z;
    x[4 * v + 3] = w.w;
  }
}

__device__ __forceinline__ void load_cols(const __nv_bfloat16* row, int tx,
                                          int bdx, float (&x)[kCols]) {
  const uint4 w = reinterpret_cast<const uint4*>(row)[tx];
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bfloat16 is a float's high half
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Column of a thread's j-th value (see load_cols).
template <typename T>
__device__ __forceinline__ int col_of(int j, int tx, int bdx) {
  constexpr int kVec = Elem<T>::kVec;
  return ((j / kVec) * bdx + tx) * kVec + j % kVec;
}

template <typename T, int HPT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml, Params p) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int R = Elem<T>::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int bdx = 1 << p.lbx, bdy = 1 << p.lby;
  const int lbz = 7 - p.lbx - p.lby;          // bdz = 128 / (bdx * bdy)
  const int tid = threadIdx.x;
  const int tx = tid & (bdx - 1);
  const int ty = (tid >> p.lbx) & (bdy - 1);
  const int tz = tid >> (p.lbx + p.lby);
  const int row_elems = bdx * kCols;          // a shared row, padded
  const int tile_rows = R << lbz;

  long long blk = blockIdx.x;
  const int h = (int)(blk % p.Hkv); blk /= p.Hkv;
  const int hc = (int)(blk % p.chunks); blk /= p.chunks;
  const int split = (int)(blk % p.splits);
  const int b = (int)(blk / p.splits);
  const int g0 = h * p.group + hc * kMaxHeads;   // the chunk's first q head
  const int heads = min(kMaxHeads, p.group - hc * kMaxHeads);
  const int r0 = split * p.chunk_rows;
  const int r1 = min(r0 + p.chunk_rows, p.valid);

  // q, pre-scaled, in registers; a missing head or column is 0
  float qf[HPT][kCols];
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    const int gl = ty * HPT + i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = col_of<T>(j, tx, bdx);
      qf[i][j] = gl < heads && c < p.D
                     ? to_float(q[b * p.q_sb + (g0 + gl) * p.q_sh + c]) *
                           p.scale_log2
                     : 0.f;
    }
  }

  // the ring's loads: 2 x tile_rows rows of vpr 16-byte vectors a stage
  const int lvpr = p.lbx + (kCols / kVec == 2 ? 1 : 0);
  const int vpr = 1 << lvpr;
  const int lrows = lvpr + __ffs(tile_rows) - 1;
  const int per_stage = 2 * tile_rows * vpr;
  const T* kb = k + b * p.k_sb + h * p.k_sh;
  const T* vb = v + b * p.v_sb + h * p.v_sh;
  const int tiles = (r1 - r0 + tile_rows - 1) / tile_rows;
  auto load_tile = [&](int t) {
    if (t < tiles) {
      T* stage = ring + (t % kStages) * 2 * tile_rows * row_elems;
      const int row0 = r0 + t * tile_rows;
      for (int i = tid; i < per_stage; i += kThreads) {
        const int vec = i & (vpr - 1);
        const int row = (i >> lvpr) & (tile_rows - 1);
        const int kv = i >> lrows;
        const int pos = row0 + row;
        const bool ok = pos < r1 && vec * kVec < p.D;
        const T* src = kv ? vb + pos * p.v_ss : kb + pos * p.k_ss;
        cp_async16(stage + (kv * tile_rows + row) * row_elems + vec * kVec,
                   ok ? src + vec * kVec : k, ok);
      }
    }
    cp_async_commit();            // an empty group past the last tile
  };

  float m[HPT], l[HPT], o[HPT][kCols];
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[i][j] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_tile(t);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();              // tile t is in, tile t - 1 is used
    load_tile(t + kStages - 1);
    const T* ks = ring + (t % kStages) * 2 * tile_rows * row_elems;
    const T* vs = ks + tile_rows * row_elems;
    const int row0 = r0 + t * tile_rows;

    float s[HPT][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x[kCols];
      load_cols(ks + (tz * R + r) * row_elems, tx, bdx, x);
#pragma unroll
      for (int i = 0; i < HPT; ++i) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) d = fmaf(qf[i][j], x[j], d);
        s[i][r] = d;
      }
    }
    for (int off = bdx >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < HPT; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r)
          s[i][r] += __shfl_xor_sync(0xffffffffu, s[i][r], off);
    }
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      float top = m[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + tz * R + r >= r1) s[i][r] = -INFINITY;
        top = fmaxf(top, s[i][r]);
      }
      // a thread that has seen no row yet keeps m = -inf: exp of -inf is 0
      const float use = top == -INFINITY ? 0.f : top;
      const float alpha = ex2(m[i] - use);
      m[i] = top;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j) o[i][j] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[i][r] = ex2(s[i][r] - use);
        l[i] += s[i][r];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x[kCols];
      load_cols(vs + (tz * R + r) * row_elems, tx, bdx, x);
#pragma unroll
      for (int i = 0; i < HPT; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) o[i][j] = fmaf(s[i][r], x[j], o[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // the ring is free for the merge

  // the bdz partial states meet in shared memory, then merge in tz order
  const int bh = bdy * HPT;       // head slots of the block
  const int bdz = 1 << lbz;
  float* mo = reinterpret_cast<float*>(smem);        // [bdz][bh][row_elems]
  float* ms = mo + bdz * bh * row_elems;              // [bdz][bh]
  float* ls = ms + bdz * bh;
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    const int slot = tz * bh + ty * HPT + i;
    if (tx == 0) {
      ms[slot] = m[i];
      ls[slot] = l[i];
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      mo[slot * row_elems + col_of<T>(j, tx, bdx)] = o[i][j];
  }
  __syncthreads();
  for (int i = tid; i < heads * p.D; i += kThreads) {
    const int gl = i / p.D, c = i - gl * p.D;
    float top = -INFINITY;
    for (int z = 0; z < bdz; ++z) top = fmaxf(top, ms[z * bh + gl]);
    const float use = top == -INFINITY ? 0.f : top;
    float sum = 0.f, acc = 0.f;
    for (int z = 0; z < bdz; ++z) {
      const float w = ex2(ms[z * bh + gl] - use);
      sum = fmaf(ls[z * bh + gl], w, sum);
      acc = fmaf(mo[(z * bh + gl) * row_elems + c], w, acc);
    }
    const long long row = (long long)b * p.Hq + g0 + gl;
    if (p.splits == 1) {
      out[row * p.D + c] = from_float<T>(sum > 0.f ? acc / sum : 0.f);
    } else {
      const long long at = row * p.splits + split;
      part_o[at * p.D + c] = acc;
      if (c == 0) {
        part_ml[2 * at] = top;
        part_ml[2 * at + 1] = sum;
      }
    }
  }
}

// A row's splits, merged in split order: out = sum_s w_s acc_s / sum_s w_s
// l_s with w_s = exp(m_s - max m).  One block a (batch row, q head).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_merge_kernel(const float* __restrict__ part_o,
                              const float* __restrict__ part_ml,
                              T* __restrict__ out, int D, int splits) {
  const long long row = blockIdx.x;
  const float* ml = part_ml + 2 * row * splits;
  float top = -INFINITY;
  for (int s = 0; s < splits; ++s) top = fmaxf(top, ml[2 * s]);
  const float use = top == -INFINITY ? 0.f : top;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s)
    sum = fmaf(ml[2 * s + 1], ex2(ml[2 * s] - use), sum);
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s)
      acc = fmaf(part_o[(row * splits + s) * D + c], ex2(ml[2 * s] - use),
                 acc);
    out[row * D + c] = from_float<T>(sum > 0.f ? acc / sum : 0.f);
  }
}

int log2_ceil(int x) {
  int n = 0;
  while ((1 << n) < x) ++n;
  return n;
}

// Dynamic shared memory of a block: the ring, or the merge of its bdz
// partial states, whichever is larger.
template <typename T, int HPT>
size_t smem_bytes(int lbx, int lby) {
  const size_t row_elems = (size_t)kCols << lbx;
  const size_t tile_rows = (size_t)Elem<T>::kRows << (7 - lbx - lby);
  const size_t ring = kStages * 2 * tile_rows * row_elems * sizeof(T);
  const size_t slots = ((size_t)1 << (7 - lbx)) * HPT;  // bdz * bdy * HPT
  const size_t merge = (slots * row_elems + 2 * slots) * sizeof(float);
  return ring > merge ? ring : merge;
}

template <typename T, int HPT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* part_o, void* part_ml, const Params& p,
                   long long blocks, int rows, int device,
                   cudaStream_t stream) {
  const auto kernel = decode_attention_kernel<T, HPT>;
  const size_t smem = smem_bytes<T, HPT>(p.lbx, p.lby);
  // above 48 KB a block's shared memory must be asked for: once a card,
  // for the most any call of this instantiation takes (lbx 1, lby 0)
  static unsigned long long asked = 0;     // bit d: card d was asked
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(asked & bit)) {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T, HPT>(1, 0));
    if (set != cudaSuccess) return set;
    asked |= bit;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)part_o,
      (float*)part_ml, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  decode_attention_merge_kernel<T><<<rows, kThreads, 0, stream>>>(
      (const float*)part_o, (const float*)part_ml, (T*)out, p.D, p.splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_heads(int hpt, const void* q, const void* k, const void* v,
                         void* out, void* part_o, void* part_ml,
                         const Params& p, long long blocks, int rows,
                         int device, cudaStream_t stream) {
  switch (hpt) {
    case 1: return launch<T, 1>(q, k, v, out, part_o, part_ml, p, blocks,
                                rows, device, stream);
    case 2: return launch<T, 2>(q, k, v, out, part_o, part_ml, p, blocks,
                                rows, device, stream);
    case 3: return launch<T, 3>(q, k, v, out, part_o, part_ml, p, blocks,
                                rows, device, stream);
    case 4: return launch<T, 4>(q, k, v, out, part_o, part_ml, p, blocks,
                                rows, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel (and, with splits > 1, the merge) on `stream` of
// card `device`; returns the CUDA error of the launches (0 on success).
// dtype: 0 float32, 1 bfloat16, q, k, v and out alike.  q (B, 1, Hq, D)
// by its (batch, head) strides; k and v (B, Lmax, Hkv, D) by their
// (batch, position, head) strides, in elements, each base 16-byte aligned
// and each stride a multiple of 16 bytes; out (B, 1, Hq, D) contiguous.
// D a multiple of 16 up to 256; 1 <= valid; split s covers positions
// [s * chunk_rows, min((s + 1) * chunk_rows, valid)), none empty.  part_o
// (B, Hq, splits, D) and part_ml (B, Hq, splits, 2) are float32 scratch,
// unused with one split.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, void* part_o, void* part_ml,
                            int dtype, int B, int Hq, int Hkv, int D,
                            int valid, int splits, int chunk_rows,
                            float sm_scale, long long q_sb, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D % 16 != 0 || D <= 0 ||
      D > kMaxDim || valid <= 0 || splits <= 0 || chunk_rows <= 0 ||
      (long long)(splits - 1) * chunk_rows >= valid)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.Hq = Hq; p.Hkv = Hkv; p.D = D; p.group = Hq / Hkv;
  p.chunks = (p.group + kMaxHeads - 1) / kMaxHeads;
  p.splits = splits; p.chunk_rows = chunk_rows; p.valid = valid;
  const int heads = p.group < kMaxHeads ? p.group : kMaxHeads;
  p.lbx = log2_ceil((D + kCols - 1) / kCols);     // bdx lanes cover D
  p.lby = log2_ceil((heads + 3) / 4);             // at most 4 heads a lane
  const int hpt = (heads + (1 << p.lby) - 1) >> p.lby;
  p.scale_log2 = (float)((double)sm_scale * 1.4426950408889634);
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  const long long blocks = (long long)B * Hkv * p.chunks * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int rows = B * Hq;
  switch (dtype) {
    case 0:
      return (int)launch_heads<float>(hpt, q, k, v, out, part_o, part_ml, p,
                                      blocks, rows, device, stream);
    case 1:
      return (int)launch_heads<__nv_bfloat16>(hpt, q, k, v, out, part_o,
                                              part_ml, p, blocks, rows, device,
                                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
