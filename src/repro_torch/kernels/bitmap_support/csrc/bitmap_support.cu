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
//   #sessions with a nonzero word of joined[k].
//   Bound: bytes, 2*K*S*W*4 + S*W*4 (read cand, write joined, read
//   slots once).  Design: one fused pass, one thread per session; a
//   block covers a session range of one candidate row, reduces its count
//   with warp shuffles and shared memory, and adds it with one atomicAdd.

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

constexpr int kSessionsPerThread = 4;
constexpr int kSessionsPerBlock = kThreads * kSessionsPerThread;

__global__ void __launch_bounds__(kThreads)
sstep_join_kernel(const uint32_t* __restrict__ slots,
                  const uint32_t* __restrict__ cand,
                  uint32_t* __restrict__ joined,
                  int32_t* __restrict__ support,
                  int K, int S, int W, int blocks_per_row) {
  __shared__ int warp_sums[kThreads / 32];
  const int k = blockIdx.x / blocks_per_row;
  const int s_lo = (blockIdx.x % blocks_per_row) * kSessionsPerBlock;
  const int s_hi = min(S, s_lo + kSessionsPerBlock);
  const size_t row = (size_t)k * S * W;

  int count = 0;
  for (int s = s_lo + threadIdx.x; s < s_hi; s += kThreads) {
    uint32_t a = 0u;
    for (int w = 0; w < W; ++w) {
      const size_t i = (size_t)s * W + w;
      const uint32_t v = slots[i] & cand[row + i];
      joined[row + i] = v;
      a |= v;
    }
    count += a != 0u;
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    if (total != 0) atomicAdd(&support[k], total);
  }
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

// support must hold K zeroed int32; joined K*S*W uint32.
int sstep_join_support_launch(const uint32_t* slots, const uint32_t* cand,
                              uint32_t* joined, int32_t* support, int K, int S,
                              int W, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks_per_row = (S + kSessionsPerBlock - 1) / kSessionsPerBlock;
  sstep_join_kernel<<<K * blocks_per_row, kThreads, 0, stream>>>(
      slots, cand, joined, support, K, S, W, blocks_per_row);
  return (int)cudaGetLastError();
}

}  // extern "C"
