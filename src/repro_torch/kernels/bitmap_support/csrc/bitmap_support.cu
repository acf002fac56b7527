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
//   Bound: a pure integer AND/OR/count, P*K*S*W word operations on the
//   CUDA cores (no tensor-core form exists) against (P+K)*S*W*4 bytes of
//   input.  At the frontiers the miner builds, P and K are in the
//   hundreds (P = K = 455: ~57 word operations per byte, where the card
//   has ~5 INT32 operations per byte of bandwidth), so operations bound
//   it, not bytes.  Design: each block owns a 32x32 (prefix, item) tile and
//   stages a 64-word slice of its 32 slot rows and 32 candidate rows in
//   shared memory, so every word loaded from device memory is used 32
//   times; each of the 256 threads keeps the counts of 4 pairs in
//   registers for the whole session loop and the block writes its tile
//   once.  A row is padded to 65 words so the 32 candidate rows a warp
//   reads at one column fall in 32 different banks.  When the (P,K) tiles
//   are too few to fill the 132 SMs (deep lattice levels hold few
//   prefixes), the session range is split across blocks, which add their
//   partial counts with an int32 atomicAdd (exact for integers).  Ragged
//   edges are masked here: the wrapper never pads.
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

constexpr int kTileP = 32;          // prefixes per block
constexpr int kTileK = 32;          // candidate items per block
constexpr int kChunk = 64;          // words of a row staged per step
constexpr int kRow = kChunk + 1;    // padded shared-memory row
constexpr int kThreads = 256;
constexpr int kPairs = kTileP * kTileK / kThreads;   // 4 per thread

__global__ void __launch_bounds__(kThreads)
frontier_join_kernel(const uint32_t* __restrict__ slots,
                     const uint32_t* __restrict__ cand,
                     int32_t* __restrict__ support,
                     int P, int K, int S, int W, int sessions_per_split) {
  __shared__ uint32_t s_slots[kTileP * kRow];
  __shared__ uint32_t s_cand[kTileK * kRow];

  const int k0 = blockIdx.x * kTileK;
  const int p0 = blockIdx.y * kTileP;
  const int s_lo = blockIdx.z * sessions_per_split;
  const int s_hi = min(S, s_lo + sessions_per_split);
  const int tid = threadIdx.x;
  const int tk = tid % kTileK;        // a warp spans 32 candidates
  const int tp = tid / kTileK;        // and one prefix row per pair
  const size_t row_words = (size_t)S * W;

  // whole sessions fit in a chunk: stage several per step; otherwise one
  // session is staged in word chunks and its any-bit is carried across
  const bool whole = W <= kChunk;
  const int sess_per_step = whole ? kChunk / W : 1;
  const int steps_per_sess = whole ? 1 : (W + kChunk - 1) / kChunk;

  int count[kPairs];
  uint32_t any[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    count[i] = 0;
    any[i] = 0u;
  }

  for (int s0 = s_lo; s0 < s_hi; s0 += sess_per_step) {
    const int ns = min(sess_per_step, s_hi - s0);
    for (int step = 0; step < steps_per_sess; ++step) {
      const int w0 = step * kChunk;
      const int span = whole ? ns * W : min(kChunk, W - w0);  // words/row
      const size_t base = (size_t)s0 * W + w0;
      __syncthreads();   // the previous slice has been consumed
      for (int idx = tid; idx < kTileP * kChunk; idx += kThreads) {
        const int r = idx / kChunk, c = idx % kChunk;
        uint32_t v = 0u;
        if (p0 + r < P && c < span) v = slots[(p0 + r) * row_words + base + c];
        s_slots[r * kRow + c] = v;
      }
      for (int idx = tid; idx < kTileK * kChunk; idx += kThreads) {
        const int r = idx / kChunk, c = idx % kChunk;
        uint32_t v = 0u;
        if (k0 + r < K && c < span) v = cand[(k0 + r) * row_words + base + c];
        s_cand[r * kRow + c] = v;
      }
      __syncthreads();
      const int wps = whole ? W : span;   // staged words of one session
      const bool closes = whole || step == steps_per_sess - 1;
      for (int j = 0; j < ns; ++j) {
        for (int w = j * wps; w < (j + 1) * wps; ++w) {
          const uint32_t c = s_cand[tk * kRow + w];   // reused by 4 pairs
#pragma unroll
          for (int i = 0; i < kPairs; ++i)
            any[i] |= s_slots[(tp + i * (kThreads / kTileK)) * kRow + w] & c;
        }
        if (closes) {
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            count[i] += any[i] != 0u;
            any[i] = 0u;
          }
        }
      }
    }
  }

  const int k = k0 + tk;
  if (k >= K) return;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = p0 + tp + i * (kThreads / kTileK);
    if (p >= P) continue;
    if (gridDim.z == 1) {
      support[(size_t)p * K + k] = count[i];
    } else if (count[i] != 0) {
      atomicAdd(&support[(size_t)p * K + k], count[i]);
    }
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

// support must hold P*K int32; it must be zeroed when splits > 1.
int frontier_join_support_launch(const uint32_t* slots, const uint32_t* cand,
                                 int32_t* support, int P, int K, int S, int W,
                                 int splits, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int per_split = (S + splits - 1) / splits;
  const dim3 grid((K + kTileK - 1) / kTileK, (P + kTileP - 1) / kTileP,
                  splits);
  frontier_join_kernel<<<grid, kThreads, 0, stream>>>(slots, cand, support,
                                                      P, K, S, W, per_split);
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
