// VMSP support joins for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/bitmap_support/bitmap_support.py:
//
//   frontier_join_support  <- frontier_join_support_pallas (_frontier_kernel)
//   sstep_join_support     <- sstep_join_support_pallas    (_kernel)
//
// Words are the miner's packed session bitmaps: uint32, laid out
// (rows, S sessions, W words), row-major and contiguous.  Every result is
// an integer count, so the kernels are exact and independent of the
// order in which blocks run.
//
// frontier_join_support: support[p,k] = #sessions s with
//   OR_w (slots[p,s,w] & cand[k,s,w]) != 0.
//   Bound: bytes.  Every slot word must be read once, P*S*W words, to
//   find where a prefix occurs; past that, only a (prefix, session) pair
//   with a nonzero slot word can add support, and it needs that session's
//   K candidate words.  At the miner's levels about 1% of the pairs are
//   nonzero (45,508 of 4.67 M words at the SEQB floor), so a dense
//   P*K*S*W join ANDs zero 99% of the time.
//   Design: the join runs session-major and skips the zero pairs.  The
//   candidates come as cand_t (S, K, W), the session-major copy the miner
//   makes once per walk, so one session's K*W candidate words are
//   contiguous.  A block owns a tile of kTileRows prefixes, a range of
//   kJoinThreads sessions and a chunk of at most kJoinThreads*KPT
//   candidates.  Each thread scans one session's slot words for the tile;
//   the sessions where some prefix of the tile has a nonzero word go to a
//   list in shared memory, in session order (a warp ballot and a prefix
//   sum over the warps).  Then the threads walk the list, one candidate
//   each (KPT of them): a listed session's candidate words are one
//   coalesced read of cand_t, which fits the 50 MB L2 (18.7 MB at the
//   SEQB floor), kUnroll sessions in flight, and each word is
//   ANDed against the tile's kTileRows slot words there, so a word read
//   once serves kTileRows prefixes.  Counts stay in registers.  A block
//   adds its nonzero counts to the output with an int32 atomicAdd (exact
//   for integers) once the launcher has zeroed it, or stores them when it
//   covers every session.  At full density every session is listed and
//   the work is the dense join's, with each candidate word read once per
//   tile of prefixes.  Words are uint32 throughout: bit 31 is an ordinary
//   bit, and nothing is shifted.
//
// sstep_join_support: joined[k] = slots & cand[k] and support[k] =
//   #sessions with a nonzero word of joined[k].  It runs once per node of
//   the DFS spill walk.
//   Bound: bytes.  joined is written whole, K*S*W words, zeros included,
//   and the slots are read once; past that, a candidate word is needed
//   only where its slot word is nonzero, which in the SEQB walk is 12.6%
//   of the sessions at the densest node (the best root) and 0.4% at a
//   median one.  The dense design read all K*S*W candidate words, 99.6%
//   of them against a zero slot word at a median node.
//   Design: a block owns a range of 256 threads' sessions and up to
//   kSstepMaxK candidates.  It reads its slot words once into registers
//   and walks its candidates; for each one a thread loads its candidate
//   words only where its slot words are nonzero (a predicated load, so a
//   warp fetches only the sectors of nonzero sessions) and stores the AND
//   to joined, coalesced, 16 bytes a thread where the layout allows
//   (W == 1, S % 4 == 0, aligned bases: 4 sessions a thread).  Counts are
//   warp sums gathered per candidate in shared memory, skipped by a warp
//   whose slot words are all zero, and leave the block once: stored when
//   one block covers every session, else added with an int32 atomicAdd
//   into the output that the launcher zeroes.  The grid is
//   ops.sstep_plan's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kJoinThreads = kThreads;       // and sessions per block
constexpr int kWarps = kJoinThreads / 32;
constexpr int kTileRows = 8;                 // prefixes per block
constexpr int kUnroll = 8;                   // listed sessions in flight

// KPT candidates per thread; kW = 1 for one-word sessions (the list then
// keeps the tile's slot words beside each session), 0 for W given at run
// time.
template <int KPT, int kW>
__global__ void __launch_bounds__(kJoinThreads)
frontier_join_kernel(const uint32_t* __restrict__ slots,
                     const uint32_t* __restrict__ cand_t,
                     int32_t* __restrict__ support,
                     int P, int K, int S, int w_run, int n_ranges,
                     int n_tiles) {
  static_assert(kTileRows == 8, "a session's tile words are two uint4");
  __shared__ int s_list[kJoinThreads];
  __shared__ __align__(16)
      uint32_t s_words[kW == 1 ? kJoinThreads * kTileRows : 4];
  __shared__ int s_warp[kWarps];

  const int W = kW ? kW : w_run;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int range = blockIdx.x % n_ranges;
  const int tile = (blockIdx.x / n_ranges) % n_tiles;
  const int k_chunk = blockIdx.x / n_ranges / n_tiles;
  const int p0 = tile * kTileRows;
  const int rows = min(kTileRows, P - p0);
  const size_t row_words = (size_t)S * W;
  const uint32_t* tile_slots = slots + (size_t)p0 * row_words;
  const int k_first = k_chunk * kJoinThreads * KPT + tid;

  // -- scan: is this thread's session nonzero in any prefix of the tile?
  const int s = range * kJoinThreads + tid;
  uint32_t v[kTileRows];
  uint32_t any = 0u;
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) v[i] = 0u;
  if (s < S) {
    if constexpr (kW == 1) {
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        if (i < rows) v[i] = tile_slots[i * row_words + s];
        any |= v[i];
      }
    } else {
      for (int i = 0; i < rows; ++i)
        for (int w = 0; w < W; ++w)
          any |= tile_slots[i * row_words + (size_t)s * W + w];
    }
  }
  const bool nz = any != 0u;
  const unsigned ballot = __ballot_sync(0xffffffffu, nz);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int at = __popc(ballot & ((1u << lane) - 1u)), n = 0;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int c = s_warp[u];
    at += u < warp ? c : 0;
    n += c;
  }
  if (nz) {
    s_list[at] = s;
    if constexpr (kW == 1) {
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) s_words[at * kTileRows + i] = v[i];
    }
  }
  if (n == 0 && n_ranges > 1) return;   // nothing to add (block-uniform)
  __syncthreads();

  // -- join: every listed session against this thread's candidates
  int count[kTileRows][KPT];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j) count[i][j] = 0;
  if constexpr (kW == 1) {
    for (int e = 0; e < n; e += kUnroll) {
      uint32_t c[kUnroll][KPT];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = e + u < n;
        const uint32_t* row = cand_t + (size_t)(live ? s_list[e + u] : 0) * K;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int k = k_first + j * kJoinThreads;
          c[u][j] = live && k < K ? __ldg(row + k) : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (e + u >= n) break;
        // a zero slot word adds nothing, so no row is branched around
        const uint4* tw = reinterpret_cast<const uint4*>(
            s_words + (e + u) * kTileRows);
        const uint4 lo = tw[0], hi = tw[1];
        const uint32_t sw[kTileRows] = {lo.x, lo.y, lo.z, lo.w,
                                        hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
#pragma unroll
          for (int j = 0; j < KPT; ++j) count[i][j] += (sw[i] & c[u][j]) != 0u;
      }
    }
  } else {
    for (int e = 0; e < n; ++e) {
      const int se = s_list[e];
      const uint32_t* row = cand_t + (size_t)se * K * W;
      uint32_t hit[kTileRows][KPT];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) hit[i][j] = 0u;
      for (int w = 0; w < W; ++w) {
        uint32_t c[KPT];
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int k = k_first + j * kJoinThreads;
          c[j] = k < K ? __ldg(row + (size_t)k * W + w) : 0u;
        }
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          const uint32_t sw =
              i < rows ? tile_slots[i * row_words + (size_t)se * W + w] : 0u;
#pragma unroll
          for (int j = 0; j < KPT; ++j) hit[i][j] |= sw & c[j];
        }
      }
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) count[i][j] += hit[i][j] != 0u;
    }
  }

#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    if (i >= rows) break;
    int32_t* out = support + (size_t)(p0 + i) * K;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int k = k_first + j * kJoinThreads;
      if (k >= K) continue;
      if (n_ranges == 1) {
        out[k] = count[i][j];
      } else if (count[i][j] != 0) {
        atomicAdd(out + k, count[i][j]);
      }
    }
  }
}

template <int KPT>
void launch_frontier(const uint32_t* slots, const uint32_t* cand_t,
                     int32_t* support, int P, int K, int S, int W,
                     int n_ranges, int n_tiles, int blocks,
                     cudaStream_t stream) {
  if (W == 1) {
    frontier_join_kernel<KPT, 1><<<blocks, kJoinThreads, 0, stream>>>(
        slots, cand_t, support, P, K, S, W, n_ranges, n_tiles);
  } else {
    frontier_join_kernel<KPT, 0><<<blocks, kJoinThreads, 0, stream>>>(
        slots, cand_t, support, P, K, S, W, n_ranges, n_tiles);
  }
}

constexpr int kSstepThreads = 256;
constexpr int kSstepMaxK = 32;               // candidates a block, at most
constexpr int kSstepUnroll = 4;              // candidate loads in flight

__device__ __forceinline__ uint32_t and_words(uint32_t a, uint32_t b) {
  return a & b;
}
__device__ __forceinline__ uint4 and_words(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ bool any_word(uint32_t v) { return v != 0u; }
__device__ __forceinline__ bool any_word(uint4 v) {
  return (v.x | v.y | v.z | v.w) != 0u;
}
__device__ __forceinline__ int nonzero_words(uint32_t v) { return v != 0u; }
__device__ __forceinline__ int nonzero_words(uint4 v) {
  return (v.x != 0u) + (v.y != 0u) + (v.z != 0u) + (v.w != 0u);
}
template <typename V>
__device__ __forceinline__ V zero_words();
template <>
__device__ __forceinline__ uint32_t zero_words<uint32_t>() { return 0u; }
template <>
__device__ __forceinline__ uint4 zero_words<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// The block's per-candidate counts, gathered in shared memory, go out
// once: stored when the block covers every session, else added.
__device__ __forceinline__ void sstep_flush(const int* s_count,
                                            int32_t* support, int k0, int nk,
                                            int n_ranges) {
  __syncthreads();
  if ((int)threadIdx.x < nk) {
    const int n = s_count[threadIdx.x];
    if (n_ranges == 1) {
      support[k0 + threadIdx.x] = n;
    } else if (n != 0) {
      atomicAdd(support + k0 + threadIdx.x, n);
    }
  }
}

// One-word sessions (W == 1): a thread owns V = uint4 (4 sessions, one
// 16-byte load and store a candidate) or uint32_t (1 session).  A block
// owns a range of kSstepThreads V's and nk <= kSstepMaxK candidates; it
// reads its slot words once and keeps them in registers for all nk.
template <typename V>
__global__ void __launch_bounds__(kSstepThreads)
sstep_join_kernel(const V* __restrict__ slots, const V* __restrict__ cand,
                  V* __restrict__ joined, int32_t* __restrict__ support,
                  int K, int n_vec, int n_ranges, int k_per_block) {
  __shared__ int s_count[kSstepMaxK];
  const int range = blockIdx.x % n_ranges;
  const int k0 = blockIdx.x / n_ranges * k_per_block;
  const int nk = min(k_per_block, K - k0);
  const int i = range * kSstepThreads + threadIdx.x;
  const bool in = i < n_vec;
  const V sv = in ? slots[i] : zero_words<V>();
  const bool nz = any_word(sv);
  // warp-uniform: a warp whose slot words are all zero counts nothing
  const bool warp_nz = __any_sync(0xffffffffu, nz);
  if (threadIdx.x < kSstepMaxK) s_count[threadIdx.x] = 0;
  __syncthreads();
  const V* c = cand + (size_t)k0 * n_vec + i;
  V* j = joined + (size_t)k0 * n_vec + i;
  for (int kk = 0; kk < nk; kk += kSstepUnroll) {
    V cv[kSstepUnroll];
#pragma unroll
    for (int u = 0; u < kSstepUnroll; ++u)   // only where a slot is nonzero
      cv[u] = nz && kk + u < nk ? __ldg(c + (size_t)(kk + u) * n_vec)
                                : zero_words<V>();
#pragma unroll
    for (int u = 0; u < kSstepUnroll; ++u) {
      if (kk + u >= nk) break;
      const V jv = and_words(sv, cv[u]);
      if (in) j[(size_t)(kk + u) * n_vec] = jv;
      if (warp_nz) {
        const int n = __reduce_add_sync(0xffffffffu, nonzero_words(jv));
        if (threadIdx.x % 32 == 0 && n != 0) atomicAdd(s_count + kk + u, n);
      }
    }
  }
  sstep_flush(s_count, support, k0, nk, n_ranges);
}

// W > 1 words a session: a thread owns one session and reads a
// candidate word only where its slot word is nonzero.
__global__ void __launch_bounds__(kSstepThreads)
sstep_join_wide_kernel(const uint32_t* __restrict__ slots,
                       const uint32_t* __restrict__ cand,
                       uint32_t* __restrict__ joined,
                       int32_t* __restrict__ support, int K, int S, int W,
                       int n_ranges, int k_per_block) {
  __shared__ int s_count[kSstepMaxK];
  const int range = blockIdx.x % n_ranges;
  const int k0 = blockIdx.x / n_ranges * k_per_block;
  const int nk = min(k_per_block, K - k0);
  const int s = range * kSstepThreads + threadIdx.x;
  const bool in = s < S;
  const uint32_t* sl = slots + (size_t)s * W;
  bool nz = false;
  if (in)
    for (int w = 0; w < W; ++w) nz |= sl[w] != 0u;
  const bool warp_nz = __any_sync(0xffffffffu, nz);
  if (threadIdx.x < kSstepMaxK) s_count[threadIdx.x] = 0;
  __syncthreads();
  for (int kk = 0; kk < nk; ++kk) {
    const size_t row = ((size_t)(k0 + kk) * S + s) * W;
    uint32_t any = 0u;
    if (in) {
      for (int w = 0; w < W; ++w) {
        const uint32_t sw = sl[w];
        const uint32_t v = sw != 0u ? sw & __ldg(cand + row + w) : 0u;
        joined[row + w] = v;
        any |= v;
      }
    }
    if (warp_nz) {
      const int n = __reduce_add_sync(0xffffffffu, (int)(any != 0u));
      if (threadIdx.x % 32 == 0 && n != 0) atomicAdd(s_count + kk, n);
    }
  }
  sstep_flush(s_count, support, k0, nk, n_ranges);
}

}  // namespace

extern "C" {

// Both launchers return the CUDA error of the launch (0 on success); the
// kernels run asynchronously on `stream` of card `device`.

// cand_t is (S, K, W).  The grid is k_chunks * n_tiles * n_ranges blocks
// (ranges fastest) with n_ranges = ceil(S / kJoinThreads), n_tiles =
// ceil(P / kTileRows) and kpt * kJoinThreads * k_chunks >= K; kpt is 1, 2
// or 4.  support holds P*K int32; when n_ranges > 1 it is zeroed here, on
// the stream, before the kernel adds into it.
int frontier_join_support_launch(const uint32_t* slots, const uint32_t* cand_t,
                                 int32_t* support, int P, int K, int S, int W,
                                 int n_ranges, int n_tiles, int k_chunks,
                                 int kpt, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)k_chunks * n_tiles * n_ranges;
  if (blocks > 0x7fffffffLL ||
      (long long)n_ranges * kJoinThreads < S ||
      (long long)n_tiles * kTileRows < P ||
      (long long)k_chunks * kpt * kJoinThreads < K ||
      (kpt != 1 && kpt != 2 && kpt != 4))
    return (int)cudaErrorInvalidConfiguration;
  if (n_ranges > 1) {
    const cudaError_t zero = cudaMemsetAsync(
        support, 0, (size_t)P * K * sizeof(int32_t), stream);
    if (zero != cudaSuccess) return (int)zero;
  }
  if (kpt == 1)
    launch_frontier<1>(slots, cand_t, support, P, K, S, W, n_ranges, n_tiles,
                       (int)blocks, stream);
  else if (kpt == 2)
    launch_frontier<2>(slots, cand_t, support, P, K, S, W, n_ranges, n_tiles,
                       (int)blocks, stream);
  else
    launch_frontier<4>(slots, cand_t, support, P, K, S, W, n_ranges, n_tiles,
                       (int)blocks, stream);
  return (int)cudaGetLastError();
}

// joined holds K*S*W uint32, support K int32 (zeroed here, on the
// stream, when n_ranges > 1).  vec is 4 (W == 1, S % 4 == 0 and every
// base 16-byte aligned: a thread owns 4 sessions) or 1.  The grid is
// n_ranges * ceil(K / k_per_block) blocks (ranges fastest), n_ranges *
// kSstepThreads * vec >= S, k_per_block <= kSstepMaxK.
int sstep_join_support_launch(const uint32_t* slots, const uint32_t* cand,
                              uint32_t* joined, int32_t* support, int K, int S,
                              int W, int vec, int n_ranges, int k_per_block,
                              int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long units = W == 1 ? (long long)S / vec : S;
  const long long blocks =
      (long long)n_ranges * ((K + (long long)k_per_block - 1) / k_per_block);
  if (k_per_block < 1 || k_per_block > kSstepMaxK || blocks > 0x7fffffffLL ||
      (vec != 1 && vec != 4) || (vec == 4 && (W != 1 || S % 4 != 0)) ||
      (long long)n_ranges * kSstepThreads < units)
    return (int)cudaErrorInvalidConfiguration;
  if (n_ranges > 1) {
    const cudaError_t zero = cudaMemsetAsync(
        support, 0, (size_t)K * sizeof(int32_t), stream);
    if (zero != cudaSuccess) return (int)zero;
  }
  if (W > 1) {
    sstep_join_wide_kernel<<<(int)blocks, kSstepThreads, 0, stream>>>(
        slots, cand, joined, support, K, S, W, n_ranges, k_per_block);
  } else if (vec == 4) {
    sstep_join_kernel<uint4><<<(int)blocks, kSstepThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(slots),
        reinterpret_cast<const uint4*>(cand), reinterpret_cast<uint4*>(joined),
        support, K, (int)units, n_ranges, k_per_block);
  } else {
    sstep_join_kernel<uint32_t><<<(int)blocks, kSstepThreads, 0, stream>>>(
        slots, cand, joined, support, K, (int)units, n_ranges, k_per_block);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
