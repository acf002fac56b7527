// Forward flash attention on Hopper's tensor cores (sm_90a), bf16 at every
// head_dim that is a multiple of 16, bound to Python through ctypes.  The
// wrapper (ops.py) runs any other head_dim on copies zero-padded to the
// next multiple of 16.  Up to 128 the kernel is instantiated at each such
// head_dim; past it one wide kernel takes the head_dim at run time (the
// second design below).
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _kernel) of
// src/repro/kernels/flash_attention/flash_attention.py for bf16 inputs,
// and computes what that kernel computes (and what
// flash_attention_tf32x3.cu, which keeps float32, computes):
//
//   out[b,h,r] = sum_c p[r,c] v[b,h/group,c] / sum_c p[r,c]
//   p[r,c]     = exp(q[b,h,r] . k[b,h/group,c] * sm_scale - m[r]) where
//                column c is visible to row r, else 0
//
// Column c is visible to row r when c < Lk and, if causal,
// c <= r + (Lk - Lq) (the mask is aligned to the end of the kv sequence).
// Scores, the running max m, the normalizer l and the accumulator are f32.
// A row that sees no column comes out 0, by the TPU kernel's three guards
// (m_safe = 0 where the running max is -inf, alpha = 0 where the previous
// max is -inf, a denominator of 1 where l = 0).  The tensor cores take p
// in bf16, so f32 p is split into kParts bf16 parts, each the bf16
// rounding of what the earlier ones left, and P V is one product a part,
// smallest first.  Three parts (the wrapper's choice) carry all 24 bits of
// f32 p, as the TPU kernel multiplies f32 p by f32 v; two carry 2^-16 of
// relative error and one bf16's 2^-8, and the bf16 logits of a 32-layer
// model drifted past bf16's own floor with one, and a moe model's with
// two (PERF.md, Findings).  l sums the f32 p.
// The kernel needs sm_scale > 0: the wrapper folds a sign or a zero into q.
//
// Bound: at the serving prefill (B 4, H 32, L 2,048, D 128, causal) the
// work is 1.375e11 FLOP of bf16 products against 268 MB of q, k, v and
// out, about 500 FLOP a byte, above the H100's ridge of about 295: the
// tensor cores' 989 TFLOP/s bound it (0.139 ms), not memory.  At
// zamba2-7b's shared attention (the same shape at D 112) it is 1.2032e11
// FLOP against 235 MB, 0.1217 ms; at D 256, 2.7501e11 FLOP, 0.2781 ms.
//
// Design (head_dim up to 128): the shape of a Hopper GEMM with the online
// softmax between its two products.
//  * One block of 256 threads owns a 128-row q tile of one (b, h): two
//    warpgroups of 64 rows each.  The grid
//    is 1-D over (B * Hq) x q tiles (up to 2^31 - 1 blocks), the q tile
//    varying fastest: the blocks run head by head, so the 16 q tiles
//    of a 2,048-row head re-read its K and V from L2, not from HBM (with
//    every head's longest tile first, the prefill's 134 MB of K and V
//    cycled through the 50 MB L2 and the kernel took 1.2x as long);
//    within a head the q tiles are issued longest causal row first.
//  * Thread 0 issues TMA copies (rank-4 tensor maps over
//    (D, S, H, B) built from the caller's strides, so the model's
//    (B, S, H, D) views are read in place) into 128-byte-swizzled shared
//    memory: the q tile once, then a 2-stage ring of 128-row K and V tiles
//    with mbarriers for full and empty slots, tile j + 1 as tile j is
//    used.  (A producer warp would make a block of 288 threads, for which
//    ptxas holds a thread to 168 registers, too few for three parts of P:
//    it spilled.)  Rows past Lq or Lk arrive as zeros.  A tile is stored
//    as ceil(D / 64) regions of 128 rows x 64 columns (128 bytes), one TMA
//    box each: at a D that is not a multiple of 64 the last region's
//    columns past D arrive as zeros too, and TMA counts them toward the
//    mbarrier's bytes, so a tile always expects whole regions.  No padded
//    copy is made in memory.  At D = 128 (and 80-112) that is 32 KB of q
//    and 2 x 64 KB of K and V, so one block runs on an SM; at D <= 64
//    half of it.
//  * S = Q K^T is D/16 wgmma.m64n128k16 per warpgroup (7 at D 112), both
//    operands read from shared memory, f32 out: the k-steps stop at D, so
//    the zero columns are never multiplied.  Masks are applied only on
//    tiles that cross the diagonal or the ragged end; tiles wholly in the
//    future are never loaded.  The softmax runs in registers: each thread
//    holds 2 rows x 32 columns, reduces a row with two quad shuffles, and
//    takes exp2(s * sm_scale * log2(e) - m) as one FMA and one ex2.approx.
//  * O = alpha O + P V: P is split into bf16 parts in registers, where
//    the accumulator layout of the first product is the A-operand layout
//    of the second, and each part is fed to wgmma.m64nNk16 with V read
//    from shared memory as an MN-major (transposed) B operand, one
//    instruction per part and region of D: N = 64, and in the last region
//    N = D - 64 (regions - 1), its live columns (48 at D 112; Hopper
//    takes N in multiples of 8), so no product is spent on the zero
//    columns and the accumulator holds only live ones.  A tile's products
//    are summed from zero into a region's accumulator, which joins O in
//    f32 registers by one FMA an element (a sum chained through every
//    tile's products drifts further from the f32 attention).
//  * Epilogue: O / l in f32, rounded to bf16, stored through the (B, S, H,
//    D) strides of the output, columns below D only.
// Tried on the H100 and measured no faster (PERF.md, Findings): issuing
// S_{j+1} with P_j V_j and running softmax j+1 meanwhile; the two
// warpgroups taking turns on the tensor cores; a producer warpgroup with
// setmaxnreg; a third stage.  ptxas held 288- and 384-thread blocks to 168
// registers and serialized the wgmma of most overlapped forms.
//
// Past head_dim 128 (the wide kernel) that tiling does not scale: at D 256
// a 128-row tile is 64 KB, and q with a 2-stage K and V ring would take
// 320 KB of the SM's 227.  So a block owns a 64-row q tile and every
// output column, and issues QK^T once a kv tile (kv tiles of 64 rows):
//  * Up to D 256 one warpgroup owns it all: S = Q K^T over D (4 k-steps of
//    wgmma.m64n64k16 a 64-column region, 3 or 4 regions, both operands in
//    shared memory), the softmax in registers, p's three bf16 parts in
//    registers as P.V's A operand and O in 3 or 4 regions (up to 128 f32
//    registers a thread), as up to D 128.  A tile's P.V is summed from zero
//    a 64-column region at a time and added to O in f32 (pv_region_into),
//    in one set of 32 registers that every region reuses: O, p's parts and
//    that one tile sum take 208 of the 255 registers a thread has at two
//    blocks an SM (ptxas: 237 used at D 256, 203 at D 192, no spill).  With
//    a tile sum zeroed in each region ptxas held two of them and spilled
//    (272 bytes at D 256), and with P.V chained into O across the tiles the
//    kernel rounded 3.6 times as many outputs unlike f32 attention (0.00201
//    of them at D 256; PERF.md, Findings).  q, one K slot and one V slot
//    take 98 KB at D 256, so two blocks share an SM and each runs while the
//    other waits.  At D 256 the products issued are 2x the function's
//    (5.5e11 FLOP), not 2.5x as with 128-column chunks on the grid.
//  * Past D 256 O no longer fits one warpgroup's registers: one warpgroup
//    (an "owner") for each 128 output columns, 3 up to D 384, 4 to 512.
//    Owner w computes the partial S of the same 128 head_dim columns, q[:,
//    128w..] K[:, 128w..]^T, and accumulates O[:, 128w..] (64 f32 registers
//    a thread) from P and V[:, 128w..].  The partial S's meet in shared
//    memory: each owner writes its own (64 x 64 f32) into its own K regions
//    of the ring slot, which only its products read, and sums, in the
//    owners' order, the k-steps of S it takes through the softmax (kk = w,
//    w + owners, ...): each element of S is summed once, in the same order
//    on every run, so two launches give the same bits.  The owners exchange
//    row maxima (exact in any order); each makes p, its share of l and p's
//    three bf16 parts for its k-steps, and writes the parts into shared
//    memory (24 KB) in the 128-byte-swizzled layout of a K-major A operand;
//    every owner's P.V reads A and B (V, MN-major) from shared memory.  l is
//    summed over the owners in the epilogue.  A tile's P.V is summed from
//    zero, a 64-column region at a time, and added to O in f32, as up to D
//    128.  (With P.V chained into O at 4 owners, O was a wgmma accumulator
//    live across thread 0's copies and ptxas serialized that
//    instantiation's wgmma, C7520; the tile sum fits its 128 registers a
//    thread once no count of products is carried across the tiles.)
//  * q stays in shared memory.  K and V have rings of their own with
//    mbarriers for full and free slots (WideSlots): 1 slot each for one
//    owner; 1 and 2 at 3 owners, 1 and 1 at 4 (q, K, V and p's parts take
//    219 KB at D 512).  Thread 0 issues every copy: the next K into a slot
//    once every warp has read it (and the partial S's there), the next V
//    once every warp has finished its P.V.
//  * Past D 512 a 64-row O no longer fits the register file, so the output
//    columns are cut into chunks of at most 384 (a multiple of 64) on the
//    grid, one a block of 3 owners, and each block computes QK^T over all
//    of D in rounds of 384 head_dim columns, q's slice loaded with K's:
//    there QK^T is issued once a kv tile for each chunk (ceil(D / 384)
//    times).
//  * Each warpgroup adds to the card's counts of products
//    (flash_attention_wgmma_products) the tiles and rounds it ran times the
//    wgmma its loop body issues a round and a tile, so that a caller sees
//    q.k issued once a kv tile; chip_smoke.py holds those per-tile counts
//    to the HGMMA instructions in each instantiation's SASS.  (Counting in
//    the loop, in registers or in shared memory, cost 4 owners the
//    register that made ptxas spill.)
//  * Slice widths are compile-time (the kernel is instantiated at one
//    owner of 3 or 4 regions, at 3 and 4 owners, and at 3 in rounds): a
//    wgmma group's count of k-steps is fixed.  With a run-time count, or
//    with O as the accumulator at 4 owners, ptxas serialized the wgmma
//    ("WG.AR in divergent path"; D 256 took 2.18 ms, not 1.71: PERF.md,
//    Findings).  A region wholly past D
//    arrives as zeros (TMA fills boxes past D) and is multiplied as such.
// Bound: the function's 2.7501e11 FLOP at D 256 (5.5002e11 at D 512) at
// 989 TFLOP/s, 0.2781 ms (0.5561); the kernel issues about twice that
// (2.06x, whole tiles on the diagonal), three bf16 parts of p being what
// keeps its rounding that of f32 attention.
// Tried on the H100 and measured slower or no faster (PERF.md, Findings):
// up to D 256, two owners of 128 columns (their partial S's, a barrier a
// tile and their lockstep cost more than QK^T's half), with p's parts
// through shared memory or in registers, and with QK^T of tile j + 1
// issued before tile j's softmax to run beside it; kv tiles of 32 rows at
// one owner (S and p's parts in half the registers, but twice the waits,
// row reductions and rescales a kv row, and q.k in m64n32k16 products);
// and a tile's P.V in halves of 32 columns with two sums in flight, the
// next half's products running while the last joins O.
// A wait on an mbarrier that has not completed after about ten seconds
// traps, so a fault in the pipeline ends the launch with an error instead
// of hanging the card.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;          // q rows per block, kv rows per tile
constexpr int kConsumerWarps = 8;              // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps;
constexpr int kStages = 2;
constexpr int kRegionBytes = kBlock * 128;     // 128 rows x 64 bf16 columns
constexpr long long kWatchdogCycles = 1ll << 34;
constexpr int kMaxDevices = 64;

struct Strides {
  long long b, h, s;                 // in elements; head_dim stride is 1
};

// regions of 64 columns a tile holds at head_dim D
template <int D>
__host__ __device__ constexpr int regions() { return (D + 63) / 64; }

// a tile's shared memory, whole regions: what TMA delivers, zeros past D
// included, and what an mbarrier of the tile expects
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return regions<D>() * kRegionBytes;
}

// live columns of region r at head_dim D: 64, or what the last one holds
template <int D>
__host__ __device__ constexpr int region_columns(int r) {
  return r + 1 < regions<D>() ? 64 : D - 64 * (regions<D>() - 1);
}

template <int D>
constexpr size_t smem_bytes() {
  // 1024 bytes of slack to align the swizzled tiles, q, the K and V ring,
  // then 7 barriers
  return 1024 + tile_bytes<D>() * (1 + 2 * kStages) + 8 * (1 + 3 * kStages);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// waits for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWatchdogCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand whose
// 1024-byte swizzle atoms (8 rows x 128 bytes) start 1024-aligned.
// Offsets are in bytes: lbo between 64-element chunks of the leading
// (contiguous) dimension, sbo between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;       // layout: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d[64] (+)= A (64 x 16, K-major in shared memory) . B (16 x 128, K-major
// in shared memory); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0 .. N/2) (+)= A (64 x 16 bf16 in registers) . B (16 x N, MN-major in
// shared memory), N 16, 32, 48 or 64; scale_d = 0 overwrites d.  The
// accumulator layout of m64nN is that of m64n64 cut to its first N
// columns, so d[N/2 ..] are not touched
template <int N>
__device__ __forceinline__ void wgmma_m64nNk16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64, "wgmma width");
  if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, "
        "%28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
        "1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

// 2^x by the SFU alone (ex2.approx.ftz): exp2f adds a range fix-up of
// three instructions per call for results below 2^-126, which p never
// needs (a weight below 2^-126 of the row's largest adds nothing)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as kParts pairs of bf16, largest first: each part rounds to bf16
// what the earlier parts left (the remainder is exact in f32), so three
// parts carry all 24 bits of an f32
template <int kParts>
__device__ __forceinline__ void split_bf16(float x, float y,
                                           uint32_t (&parts)[kParts]) {
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    parts[i] = *reinterpret_cast<const uint32_t*>(&h);
    x -= hf.x;
    y -= hf.y;
  }
}

// O = alpha O + P V over one region of N columns of D, the V tile's
// region (kSteps x 16 rows) at shared address v_region: the tensor cores
// sum this tile's products, smallest part first, from zero into t, and t
// joins O in f32 (a sum chained through every tile's products drifts
// more).  o[0 .. N/2) are the region's live accumulator elements
template <int N, int kParts, int kSteps = 8>
__device__ __forceinline__ void pv_region(
    float (&o)[32], const uint32_t (&pp)[kSteps][4][kParts],
    const float (&alpha)[2], uint32_t v_region) {
  float t[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = 0.f;   // overwritten (scale_d = 0)
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint64_t dv = smem_desc(v_region + kk * 16 * 128, 1024, 1024);
#pragma unroll
    for (int part = kParts - 1; part >= 0; --part) {
      const uint32_t a[4] = {pp[kk][0][part], pp[kk][1][part],
                             pp[kk][2][part], pp[kk][3][part]};
      wgmma_m64nNk16_rs<N>(t, a, dv, kk > 0 || part < kParts - 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    o[i] = fmaf(o[i], alpha[(i / 2) % 2], t[i]);
}

// Accumulator layout of wgmma.m64nN (f32), for thread `lane` of warp w of
// the warpgroup: element j sits at row 16 w + lane / 4 + 8 ((j / 2) % 2)
// and column 8 (j / 4) + 2 (lane % 4) + j % 2.
template <int D, int kParts>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ out, Strides os,
                             int Hq, int group, int Lq, int Lk, int causal,
                             float scale_log2) {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head_dim");
  constexpr int kRegions = regions<D>();
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;
  const uint32_t s_k = s_q + kTile;                   // kStages tiles
  const uint32_t s_v = s_k + kStages * kTile;         // kStages tiles
  const uint32_t bar_q = s_v + kStages * kTile;
  const uint32_t bar_k = bar_q + 8;                   // kStages: K landed
  const uint32_t bar_v = bar_k + 8 * kStages;         // kStages: V landed
  const uint32_t bar_free = bar_v + 8 * kStages;      // kStages: slot read

  // a 1-D grid over (B * Hq) x q tiles, the q tile varying fastest
  const int q_tiles = (Lq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / group;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * kBlock;  // longest first
  const int offset = Lk - Lq;                             // end-aligned causal
  int n_tiles = (Lk + kBlock - 1) / kBlock;
  if (causal) {
    // the last column any row of this tile sees; later tiles are skipped
    const int last_visible = min(q0 + kBlock, Lq) - 1 + offset;
    n_tiles = last_visible < 0 ? 0 : min(n_tiles, last_visible / kBlock + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_free + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // thread 0 issues the copies: K and V of tile jj into ring slot
  // jj % kStages, once every warp has read the tile the slot held before
  const bool issuer = threadIdx.x == 0;
  auto issue = [&](int jj) {
    const int s = jj % kStages;
    if (jj >= kStages) mbar_wait(bar_free + 8 * s, ((jj / kStages) & 1) ^ 1);
    mbar_expect_tx(bar_k + 8 * s, kTile);
    for (int r = 0; r < kRegions; ++r)
      tma_load_4d(s_k + s * kTile + r * kRegionBytes, &tm_k, bar_k + 8 * s,
                  64 * r, jj * kBlock, hk, b);
    mbar_expect_tx(bar_v + 8 * s, kTile);
    for (int r = 0; r < kRegions; ++r)
      tma_load_4d(s_v + s * kTile + r * kRegionBytes, &tm_v, bar_v + 8 * s,
                  64 * r, jj * kBlock, hk, b);
  };
  if (issuer && n_tiles > 0) {
    mbar_expect_tx(bar_q, kTile);
    for (int r = 0; r < kRegions; ++r)
      tma_load_4d(s_q + r * kRegionBytes, &tm_q, bar_q, 64 * r, q0, h, b);
    issue(0);
  }
  __syncwarp();

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread owns
  // rows row0 and row0 + 8 of them
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_wg = s_q + 64 * wg * 128;   // its 64 rows in each region

  float o[kRegions][32];
#pragma unroll
  for (int r = 0; r < kRegions; ++r)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[r][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // scaled by sm_scale log2(e)
  float l_part[2] = {0.f, 0.f};              // this thread's columns only

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = j * kBlock;
    if (issuer && j + 1 < n_tiles) issue(j + 1);   // while tile j is used
    __syncwarp();

    // S = Q K^T
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;   // overwritten (scale_d = 0)
    mbar_wait(bar_k + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * kRegionBytes + (ks % 4) * 32;
      wgmma_m64n128k16_ss(sc, smem_desc(q_wg + off, 16, 1024),
                          smem_desc(s_k + s * kTile + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    // mask the ragged end and, on tiles crossing the diagonal, the future
    const int wg_first = q0 + 64 * wg;
    if (k0 + kBlock > Lk || (causal && k0 + kBlock - 1 > wg_first + offset)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int c = k0 + 8 * (i / 4) + col0 + i % 2;
        const int r = row0 + 8 * ((i / 2) % 2);
        if (c >= Lk || (causal && c > r + offset)) sc[i] = -INFINITY;
      }
    }

    // online softmax, rows row0 (rr 0) and row0 + 8 (rr 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float m_safe[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_cur = fmaxf(m_run[rr], mx[rr] * scale_log2);
      // guard fully masked rows: exp(-inf - -inf) would be NaN
      m_safe[rr] = m_cur == -INFINITY ? 0.f : m_cur;
      alpha[rr] =
          m_run[rr] == -INFINITY ? 0.f : fast_exp2(m_run[rr] - m_safe[rr]);
      m_run[rr] = m_cur;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m_safe[(i / 2) % 2]));
      sum[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      l_part[rr] = l_part[rr] * alpha[rr] + sum[rr];

    // P's bf16 parts, laid out as the A operand: k-step kk takes columns
    // 16 kk .. 16 kk + 15, which are accumulator elements 8 kk .. 8 kk + 7
    uint32_t pp[8][4][kParts];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16<kParts>(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1],
                           pp[kk][e]);

    // O = alpha O + P V, a region of D at a time: 64 columns, and the last
    // region's live ones only
    mbar_wait(bar_v + 8 * s, parity);
    const uint32_t v_tile = s_v + s * kTile;
    pv_region<region_columns<D>(0), kParts>(o[0], pp, alpha, v_tile);
    if constexpr (kRegions > 1)
      pv_region<region_columns<D>(1), kParts>(o[1], pp, alpha,
                                               v_tile + kRegionBytes);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_free + 8 * s);
  }

  // epilogue: O / l, rounded to bf16, columns below D
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_part[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = l == 0.f ? 1.f : l;   // a fully masked row gives 0
    const int r = row0 + 8 * rr;
    if (r >= Lq) continue;
    __nv_bfloat16* orow = ob + r * os.s;
#pragma unroll
    for (int reg = 0; reg < kRegions; ++reg)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (8 * nb >= region_columns<D>(reg)) continue;
        const int i = 4 * nb + 2 * rr;
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * reg + 8 * nb + col0) =
            __floats2bfloat162_rn(o[reg][i] / denom, o[reg][i + 1] / denom);
      }
  }
}

// -- the wide kernel: head_dim past 128, a multiple of 16, at run time ----

constexpr int kWideRows = 64;                 // q rows a block, kv rows a tile
constexpr int kWideRegion = kWideRows * 128;  // 64 rows x 64 bf16 columns
constexpr int kOwnerColumns = 128;   // output columns a warpgroup past D 256
constexpr int kMaxWideSmem = 232448;          // a block's shared memory

// The wide kernel's geometry at head_dim D, the same on the host and the
// card.  Up to D 512 a block owns a q tile and all of D's output columns;
// past it the columns are cut into chunks of at most 384 (a multiple of 64,
// the last narrower), one a block.  Up to D 256 one warpgroup (an "owner")
// holds all of them, in owner_regions = 3 or 4 regions of 64; past it a
// block has one owner for each 128 of its columns (2 regions).  QK^T runs
// in rounds of owners x owner_regions x 64 head_dim columns: one up to D
// 512, q then staying in shared memory; past it q's slice of a round comes
// with K's.
struct WideLayout {
  int chunk_cols, chunks, owners, owner_regions, rounds;
  bool q_resident;

  __host__ __device__ explicit WideLayout(int D) {
    const int per = D <= 512 ? 1 : (D + 383) / 384;
    chunk_cols = per == 1 ? D : ((D + per - 1) / per + 63) / 64 * 64;
    chunks = (D + chunk_cols - 1) / chunk_cols;
    owners = D <= 256 ? 1 : (chunk_cols + kOwnerColumns - 1) / kOwnerColumns;
    owner_regions = owners == 1 ? (D + 63) / 64 : kOwnerColumns / 64;
    const int width = owners * owner_regions * 64;
    rounds = (D + width - 1) / width;
    q_resident = rounds == 1;
  }
};

// One owner keeps p's bf16 parts in registers; three and four, whose
// registers do not hold them beside O, share them through shared memory.
__host__ __device__ constexpr bool wide_shares_p(int owners) {
  return owners > 1;
}

// A block's shared memory, known at compile time from its owners, their
// regions and whether q stays: 1024 bytes of slack to align the swizzled
// tiles, q, a ring of K slots (K's slice of a round, and q's when q does
// not stay), a ring of V slots, p's three bf16 parts where shared, each
// owner's row maxima and row sums, 9 barriers.  One owner takes one slot
// each, so that two blocks share an SM and hide each other's loads;
// several owners take 2 slots each where shared memory allows, else 1 (V
// first).
struct WideSlots {
  int regions, q_bytes, k_slot, v_slot, p_bytes, fixed, k_stages, v_stages,
      bytes;

  __host__ __device__ constexpr WideSlots(int owners, int owner_regions,
                                          bool q_resident)
      : regions(owners * owner_regions),
        q_bytes(q_resident ? regions * kWideRegion : 0),
        k_slot(regions * kWideRegion * (q_resident ? 1 : 2)),
        v_slot(regions * kWideRegion),
        p_bytes(wide_shares_p(owners) ? 3 * kWideRegion : 0),
        fixed(1024 + q_bytes + p_bytes + 2 * owners * kWideRows * 4 + 8 * 9),
        k_stages(owners > 1 && fixed + 2 * k_slot + 2 * v_slot <= kMaxWideSmem
                     ? 2 : 1),
        v_stages(owners > 1 && fixed + k_slot + 2 * v_slot <= kMaxWideSmem
                     ? 2 : 1),
        bytes(fixed + k_stages * k_slot + v_stages * v_slot) {}
};

// d (+)= A (64 x 16, K-major in shared memory) . B (16 x 64 in shared
// memory, K-major, or MN-major with kMajorMN); scale_d = 0 overwrites d.
// The descriptors da and db are advanced by oa and ob (16-byte units)
// inside the instruction's own block, so that only their bases stay live
// (a base and its offsets never carry out of the 14-bit address field:
// shared memory is below 2^18 bytes).
template <bool kMajorMN>
__device__ __forceinline__ void wgmma_m64n64k16_at(float (&d)[32],
                                                   uint64_t da, uint32_t oa,
                                                   uint64_t db, uint32_t ob,
                                                   int scale_d) {
#define FA_WGMMA_AT(TRANS_B)                                                 \
  asm volatile(                                                              \
      "{\n .reg .pred p;\n .reg .b64 da, db;\n setp.ne.b32 p, %36, 0;\n"     \
      " cvt.u64.u32 da, %33;\n add.s64 da, da, %32;\n"                       \
      " cvt.u64.u32 db, %35;\n add.s64 db, db, %34;\n"                       \
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, da, db, p, 1, 1, 0, " TRANS_B ";\n}\n"           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "l"(da), "r"(oa), "l"(db), "r"(ob), "r"(scale_d))
  if constexpr (kMajorMN)
    FA_WGMMA_AT("1");
  else
    FA_WGMMA_AT("0");
#undef FA_WGMMA_AT
}

// x, as far as the compiler can tell, changed here: what is computed from
// it inside a loop stays there rather than holding registers across it
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// orders this thread's shared-memory accesses through the generic proxy
// with those of the async proxy (TMA writes, wgmma reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// O = alpha O + P V over one 64-column region: P's kParts bf16 parts (64 x
// 64 each, K-major, kWideRegion apart from p_parts) and the V tile's region
// at v_region, both read from shared memory.  The tile's products are
// summed from zero, smallest part first, and the sum joins O in f32, as in
// pv_region.  kWideRows / 16 x kParts products.
template <int kParts>
__device__ __forceinline__ void pv_region_ss(float (&o)[32], uint32_t p_parts,
                                             const float (&alpha)[2],
                                             uint32_t v_region) {
  const uint64_t dp = smem_desc(p_parts, 16, 1024);
  const uint64_t dv = smem_desc(v_region, 1024, 1024);
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;   // overwritten (scale_d = 0)
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWideRows / 16; ++kk)
#pragma unroll
    for (int part = kParts - 1; part >= 0; --part)
      wgmma_m64n64k16_at<true>(acc, dp, (part * kWideRegion + kk * 32) / 16,
                               dv, kk * 16 * 128 / 16,
                               kk > 0 || part < kParts - 1);
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = fmaf(o[e], alpha[(e / 2) % 2], acc[e]);
}

// O = alpha O + P V over one 64-column region with P's bf16 parts in
// registers, as pv_region: the tile's products summed from zero, smallest
// part first, into t, and t added to O in f32.  t is the caller's, the
// same registers region after region: the accumulator operands of the
// first product are read (its scale_d = 0 ignores them), so the products
// of region r + 1 wait for region r's sum to join O, and ptxas holds one
// tile sum beside O and p.  (With a sum of its own zeroed in each region,
// as pv_region's, ptxas held two and spilled: 272 bytes at D 256.)
// kSteps x kParts products.
template <int kParts, int kSteps>
__device__ __forceinline__ void pv_region_into(
    float (&o)[32], float (&t)[32], const uint32_t (&pp)[kSteps][4][kParts],
    const float (&alpha)[2], uint32_t v_region) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint64_t dv = smem_desc(v_region + kk * 16 * 128, 1024, 1024);
#pragma unroll
    for (int part = kParts - 1; part >= 0; --part) {
      const uint32_t a[4] = {pp[kk][0][part], pp[kk][1][part],
                             pp[kk][2][part], pp[kk][3][part]};
      wgmma_m64nNk16_rs<64>(t, a, dv, kk > 0 || part < kParts - 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = fmaf(o[e], alpha[(e / 2) % 2], t[e]);
}

// FLOP of the products the wide kernel has issued since the last reset,
// [0] q.k, [1] P.V: each warpgroup adds the tiles it ran times the
// products its loop body issues a tile
__device__ unsigned long long g_wide_products[2];
constexpr unsigned long long kWgmmaFlop = 2ull * 64 * 64 * 16;  // m64n64k16

// The accumulator layout is that of the kernel above, cut to the m64n64
// tile: element i of a thread sits at row 16 w + lane / 4 + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 (lane % 4) + i % 2, the same in every owner.
// kMulti: QK^T in rounds, q's slice loaded with K's (past D 512).
template <int kParts, int kOwners, int kOR, bool kMulti>
__global__ void __launch_bounds__(128 * kOwners, kOwners == 1 ? 2 : 1)
flash_attention_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  __nv_bfloat16* __restrict__ out, Strides os,
                                  int Hq, int group, int Lq, int Lk, int D,
                                  int causal, float scale_log2) {
  static_assert(kParts >= 1 && kParts <= 3, "bf16 parts of p");
  constexpr bool kShareP = wide_shares_p(kOwners);
  static_assert(kShareP || !kMulti, "rounds share p");
  constexpr WideSlots kSlots(kOwners, kOR, !kMulti);
  constexpr int kKStages = kSlots.k_stages, kVStages = kSlots.v_stages;
  constexpr int kWarps = 4 * kOwners;
  constexpr int kRegions = kOwners * kOR;   // a round's, of K and of q
  constexpr int kSteps = kWideRows / 16;              // k-steps of P.V
  // the k-steps of S an owner takes through the softmax where p is shared:
  // wg, wg + kOwners, ...
  constexpr int kOwned = (kSteps + kOwners - 1) / kOwners;
  // the wgmma (m64n64k16) a warpgroup issues: q.k a K step (a round of a
  // tile), P.V a tile (kOR regions of kSteps x kParts); chip_smoke.py holds
  // their sum to the HGMMA instructions of each instantiation's SASS, which
  // has the loop body once
  constexpr int kQkWgmma = 4 * kOR;
  constexpr int kPvWgmma = kOR * kSteps * kParts;
  const WideLayout lay(D);   // lay.owners == kOwners, owner_regions == kOR
  const int rounds = kMulti ? lay.rounds : 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;
  const uint32_t s_k = s_q + kSlots.q_bytes;                 // K's ring
  const uint32_t s_v = s_k + kKStages * kSlots.k_slot;       // V's ring
  const uint32_t s_p = s_v + kVStages * kSlots.v_slot;       // p's parts
  const uint32_t s_x = s_p + kSlots.p_bytes;                 // maxima, sums
  const uint32_t bar_q = s_x + 2 * kOwners * kWideRows * 4;
  const uint32_t bar_k = bar_q + 8;                  // 2: K landed
  const uint32_t bar_k_free = bar_k + 16;            // 2: K read
  const uint32_t bar_v = bar_k_free + 16;            // 2: V landed
  const uint32_t bar_v_free = bar_v + 16;            // 2: V read
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };
  float* const x_max = reinterpret_cast<float*>(at(s_x));   // [owner][row]
  float* const x_sum = x_max + kOwners * kWideRows;         // [owner][row]

  // a 1-D grid over (B * Hq) x q tiles x chunks, the chunk varying fastest
  // and then the q tile, longest first; the (batch, head, first output
  // column) of the block, computed where used so that no register holds
  // them across the tile loop
  const int q_tiles = (Lq + kWideRows - 1) / kWideRows;
  const int tile = blockIdx.x / lay.chunks;
  const int q0 = (q_tiles - 1 - tile % q_tiles) * kWideRows;
  auto bhc = [&](int& b, int& h, int& c0) {
    const int bh = (int)(blockIdx.x / lay.chunks) / q_tiles;
    b = bh / Hq;
    h = bh % Hq;
    c0 = (int)(blockIdx.x % lay.chunks) * lay.chunk_cols;
  };
  const int offset = Lk - Lq;                        // end-aligned causal
  int n_tiles = (Lk + kWideRows - 1) / kWideRows;
  if (causal) {
    const int last_visible = min(q0 + kWideRows, Lq) - 1 + offset;
    n_tiles = last_visible < 0 ? 0 : min(n_tiles, last_visible / kWideRows + 1);
  }
  const int n_steps = n_tiles * rounds;              // K slots in order

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_k_free + 8 * s, kWarps);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_v_free + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool issuer = threadIdx.x == 0;
  // K step i (round i % rounds of tile i / rounds) into ring slot i %
  // kKStages, with q's slice in rounds, once every warp is done with step
  // i - kKStages
  auto issue_k = [&](int i) {
    int b, h, c0;
    bhc(b, h, c0);
    const int hk = h / group;
    const int st = i % kKStages;
    if (i >= kKStages)
      mbar_wait(bar_k_free + 8 * st, ((i / kKStages) & 1) ^ 1);
    const int j = i / rounds, r = i % rounds;
    const uint32_t slot = s_k + st * kSlots.k_slot;
    mbar_expect_tx(bar_k + 8 * st, kSlots.k_slot);
    for (int g = 0; g < kRegions; ++g)
      tma_load_4d(slot + g * kWideRegion, &tm_k, bar_k + 8 * st,
                  64 * (kRegions * r + g), j * kWideRows, hk, b);
    if constexpr (kMulti) {
      for (int g = 0; g < kRegions; ++g)
        tma_load_4d(slot + (kRegions + g) * kWideRegion, &tm_q,
                    bar_k + 8 * st, 64 * (kRegions * r + g), q0, h, b);
    }
  };
  // V's chunk of tile j into its ring slot, once every warp is done with
  // tile j - kVStages's
  auto issue_v = [&](int j) {
    int b, h, c0;
    bhc(b, h, c0);
    const int hk = h / group;
    const int st = j % kVStages;
    if (j >= kVStages)
      mbar_wait(bar_v_free + 8 * st, ((j / kVStages) & 1) ^ 1);
    mbar_expect_tx(bar_v + 8 * st, kSlots.v_slot);
    for (int g = 0; g < kRegions; ++g)
      tma_load_4d(s_v + st * kSlots.v_slot + g * kWideRegion, &tm_v,
                  bar_v + 8 * st, c0 + 64 * g, j * kWideRows, hk, b);
  };
  if (issuer && n_tiles > 0) {
    if constexpr (!kMulti) {
      int b, h, c0;
      bhc(b, h, c0);
      mbar_expect_tx(bar_q, kSlots.q_bytes);
      for (int g = 0; g < kRegions; ++g)
        tma_load_4d(s_q + g * kWideRegion, &tm_q, bar_q, 64 * g, q0, h, b);
    }
    for (int i = 0; i < kKStages && i < n_steps; ++i) issue_k(i);
    for (int j = 0; j < kVStages && j < n_tiles; ++j) issue_v(j);
  }
  __syncwarp();

  // owner wg: head_dim (and output) columns 128 wg .. 128 wg + 127 of each
  // round (of the chunk); this thread holds rows row_a and row_a + 8
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int row_a = 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);

  float o[kOR][32];
#pragma unroll
  for (int r = 0; r < kOR; ++r)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[r][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // scaled by sm_scale log2(e)
  float l_part[2] = {0.f, 0.f};              // this thread's columns only

  // the owners' partial S's of a K slot meet there, each owner's over its
  // own K regions (16 KB, which only its products read), as [owner][i][tid]
  auto slot_parts = [&](int st) {
    return reinterpret_cast<float*>(at(s_k + st * kSlots.k_slot));
  };
  auto write_part = [&](int st, const float (&sc)[32]) {
    float* const parts = slot_parts(st);
    fence_proxy_async();                      // the products read these bytes
#pragma unroll
    for (int e = 0; e < 32; ++e) parts[(wg * 32 + e) * 128 + tid] = sc[e];
  };
  // this owner's products of q . k over its 128 columns of K slot st
  // (q's slice too in rounds), kQkWgmma of them, summed from zero into acc;
  // the caller waits
  auto qk_issue = [&](int st, float (&acc)[32]) {
    const uint32_t slot = s_k + st * kSlots.k_slot;
    const uint32_t q_slice =
        (kMulti ? slot + kRegions * kWideRegion : opaque(s_q)) +
        wg * kOR * kWideRegion;
    const uint64_t dq = smem_desc(q_slice, 16, 1024);
    const uint64_t dk =
        smem_desc(slot + wg * kOR * kWideRegion, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kQkWgmma; ++ks) {
      const uint32_t off = ((ks / 4) * kWideRegion + (ks % 4) * 32) / 16;
      wgmma_m64n64k16_at<false>(acc, dq, off, dk, off, ks > 0);
    }
    wgmma_commit();
  };
  // the slot of the tile's last K step is read: recycle it
  auto free_k = [&](int j, int st) {
    fence_proxy_async();                      // before TMA reuses the slot
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_k_free + 8 * st);
    if (issuer && (j + 1) * rounds - 1 + kKStages < n_steps)
      issue_k((j + 1) * rounds - 1 + kKStages);
    __syncwarp();
  };
  auto free_v = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_v_free + 8 * (j % kVStages));
    if (issuer && j + kVStages < n_tiles) issue_v(j + kVStages);
    __syncwarp();
  };
  auto v_mine = [&](int j) {
    mbar_wait(bar_v + 8 * (j % kVStages), (j / kVStages) & 1);
    return s_v + (j % kVStages) * kSlots.v_slot +
           wg * kOR * kWideRegion;
  };

  if constexpr (!kShareP) {
    // One owner (up to D 256): S over all of D, the whole softmax, and p's
    // bf16 parts in registers as P.V's A operand, as up to D 128
    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * kWideRows;
      const int st = j % kKStages;
      mbar_wait(bar_k + 8 * st, (j / kKStages) & 1);
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;   // overwritten (scale_d = 0)
      qk_issue(st, sc);
      wgmma_wait_all();
      free_k(j, st);
      // mask the ragged end and, on tiles crossing the diagonal, the future
      if (k0 + kWideRows > Lk ||
          (causal && k0 + kWideRows - 1 > q0 + offset)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = k0 + 8 * (i / 4) + col0 + i % 2;
          const int r = q0 + row_a + 8 * ((i / 2) % 2);
          if (c >= Lk || (causal && c > r + offset)) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float m_safe[2], alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_cur = fmaxf(m_run[rr], mx[rr] * scale_log2);
        // guard fully masked rows: exp(-inf - -inf) would be NaN
        m_safe[rr] = m_cur == -INFINITY ? 0.f : m_cur;
        alpha[rr] =
            m_run[rr] == -INFINITY ? 0.f : fast_exp2(m_run[rr] - m_safe[rr]);
        m_run[rr] = m_cur;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m_safe[(i / 2) % 2]));
        sum[(i / 2) % 2] += sc[i];
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        l_part[rr] = l_part[rr] * alpha[rr] + sum[rr];
      // p's bf16 parts as the A operand: k-step kk takes kv columns 16 kk ..
      // 16 kk + 15, accumulator elements 8 kk .. 8 kk + 7
      uint32_t pp[kSteps][4][kParts];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_bf16<kParts>(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1],
                             pp[kk][e]);
      // O = alpha O + P V a region at a time, the tile's products summed
      // from zero in t and added to O in f32
      const uint32_t v = v_mine(j);
      float t[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) t[e] = 0.f;
#pragma unroll
      for (int r = 0; r < kOR; ++r)
        pv_region_into<kParts, kSteps>(o[r], t, pp, alpha,
                                       v + r * kWideRegion);
      free_v(j);
    }
  } else {
    // Three or four owners: each sums the k-steps of S it owns, the owners
    // exchange row maxima, and p's bf16 parts meet in shared memory.
    if (n_tiles > 0 && !kMulti) mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * kWideRows;
      // this owner's partial S over its 128 columns of each round: each
      // round's products summed from zero by the tensor cores, then in
      // registers (an accumulator live across thread 0's copies would
      // serialize the wgmma)
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      int st = 0;
      for (int r = 0; r < rounds; ++r) {
        const int i = j * rounds + r;
        st = i % kKStages;
        mbar_wait(bar_k + 8 * st, (i / kKStages) & 1);
        float part[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) part[e] = 0.f;   // overwritten
        qk_issue(st, part);
        wgmma_wait_all();
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] += part[e];
        if (r + 1 < rounds) {                 // the slot is read: recycle it
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_k_free + 8 * st);
          if (issuer && i + kKStages < n_steps) issue_k(i + kKStages);
          __syncwarp();
        }
      }
      write_part(st, sc);
      __syncthreads();
      // S over this owner's k-steps, the owners' parts summed in order
      const float* const parts = slot_parts(st);
      float s[kOwned][8];
#pragma unroll
      for (int u = 0; u < kOwned; ++u) {
        const int kk = wg + u * kOwners;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float x = -INFINITY;
          if (kk < kSteps) {
            x = parts[(8 * kk + e) * 128 + tid];
#pragma unroll
            for (int w = 1; w < kOwners; ++w)
              x += parts[(w * 32 + 8 * kk + e) * 128 + tid];
          }
          s[u][e] = x;
        }
      }
      free_k(j, st);

      // mask the ragged end and, on tiles crossing the diagonal, the
      // future; the row maxima of this owner's columns, then of the tile's
      const bool edge = k0 + kWideRows > Lk ||
                        (causal && k0 + kWideRows - 1 > q0 + offset);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int u = 0; u < kOwned; ++u) {
        const int kk = wg + u * kOwners;
        if (kk >= kSteps) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (edge) {
            const int c = k0 + 16 * kk + 8 * (e / 4) + col0 + e % 2;
            const int r = q0 + row_a + 8 * ((e / 2) % 2);
            if (c >= Lk || (causal && c > r + offset)) s[u][e] = -INFINITY;
          }
          mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], s[u][e]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        if (lane % 4 == 0) x_max[wg * kWideRows + row_a + 8 * rr] = mx[rr];
      }
      __syncthreads();
      float m_safe[2], alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float m = x_max[row_a + 8 * rr];
#pragma unroll
        for (int w = 1; w < kOwners; ++w)
          m = fmaxf(m, x_max[w * kWideRows + row_a + 8 * rr]);
        const float m_cur = fmaxf(m_run[rr], m * scale_log2);
        // guard fully masked rows: exp(-inf - -inf) would be NaN
        m_safe[rr] = m_cur == -INFINITY ? 0.f : m_cur;
        alpha[rr] =
            m_run[rr] == -INFINITY ? 0.f : fast_exp2(m_run[rr] - m_safe[rr]);
        m_run[rr] = m_cur;
      }

      // p over this owner's k-steps, its share of l, and p's bf16 parts into
      // shared memory as every owner's A operand: K-major, 128-byte swizzled
      // (16-byte chunk c of row r at chunk c ^ (r % 8))
      float sum[2] = {0.f, 0.f};
      fence_proxy_async();                    // the last P.V read these bytes
#pragma unroll
      for (int u = 0; u < kOwned; ++u) {
        const int kk = wg + u * kOwners;
        if (kk >= kSteps) continue;
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const int rr = (e / 2) % 2;
          const float p0 = fast_exp2(fmaf(s[u][e], scale_log2, -m_safe[rr]));
          const float p1 =
              fast_exp2(fmaf(s[u][e + 1], scale_log2, -m_safe[rr]));
          sum[rr] += p0;
          sum[rr] += p1;
          uint32_t pp[kParts];
          split_bf16<kParts>(p0, p1, pp);
          const int row = row_a + 8 * rr;
          const uint32_t off =
              row * 128 + (((2 * kk + e / 4) ^ (row % 8)) * 16) + col0 * 2;
#pragma unroll
          for (int part = 0; part < kParts; ++part)
            *reinterpret_cast<uint32_t*>(at(s_p + part * kWideRegion + off)) =
                pp[part];
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        l_part[rr] = l_part[rr] * alpha[rr] + sum[rr];
      fence_proxy_async();                    // p's parts, for the wgmma
      __syncthreads();

      // O = alpha O + P V over this owner's two regions of the V tile
      const uint32_t v = v_mine(j);
      const uint32_t p_parts = opaque(s_p);
#pragma unroll
      for (int r = 0; r < kOR; ++r)
        pv_region_ss<kParts>(o[r], p_parts, alpha, v + r * kWideRegion);
      free_v(j);
    }
  }

  // epilogue: l (summed over the owners where they share p), O / l rounded
  // to bf16, this owner's columns of the chunk
  float l_row[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_part[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[rr] = l;
    if (lane % 4 == 0) x_sum[wg * kWideRows + row_a + 8 * rr] = l;
  }
  __syncthreads();
  int b, h, c0;
  bhc(b, h, c0);
  const int c_cols = min(lay.chunk_cols, D - c0);    // a multiple of 16
  __nv_bfloat16* ob = out + b * os.b + h * os.h + c0;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_row[rr];                      // all of l where p is not shared
    if constexpr (kShareP) {
      l = x_sum[row_a + 8 * rr];
#pragma unroll
      for (int w = 1; w < kOwners; ++w)
        l += x_sum[w * kWideRows + row_a + 8 * rr];
    }
    const float denom = l == 0.f ? 1.f : l;   // a fully masked row gives 0
    const int r = q0 + row_a + 8 * rr;
    if (r >= Lq) continue;
    __nv_bfloat16* orow = ob + r * os.s;
#pragma unroll
    for (int reg = 0; reg < kOR; ++reg)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int c = 64 * kOR * wg + 64 * reg + 8 * nb;
        if (c >= c_cols) continue;
        const int i = 4 * nb + 2 * rr;
        *reinterpret_cast<__nv_bfloat162*>(orow + c + col0) =
            __floats2bfloat162_rn(o[reg][i] / denom, o[reg][i + 1] / denom);
      }
  }
  // the products this warpgroup issued: the tiles (and rounds) it ran,
  // each issuing kQkWgmma q.k and kPvWgmma P.V products
  if (tid == 0) {
    atomicAdd(&g_wide_products[0],
              kWgmmaFlop * kQkWgmma * (unsigned long long)n_steps);
    atomicAdd(&g_wide_products[1],
              kWgmmaFlop * kPvWgmma * (unsigned long long)n_tiles);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found at run time: no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-4 map over (D, L, H, B) of a bf16 tensor with the given
// (batch, head, position) strides in elements, in boxes of 64 columns x
// `rows` rows; a box reaching past D or L is filled with zeros there.
CUresult make_map(CUtensorMap* map, EncodeTiled encode, const void* base,
                  int D, int L, int H, int B, Strides st, int rows = kBlock) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);   // out of bounds: zeros
}

template <int D, int kParts>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int Hq,
           int Hkv, int Lq, int Lk, int causal, float sm_scale, int device,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult res = make_map(&tm_q, encode, q, D, Lq, Hq, B, qs);
  if (res == CUDA_SUCCESS) res = make_map(&tm_k, encode, k, D, Lk, Hkv, B, ks);
  if (res == CUDA_SUCCESS) res = make_map(&tm_v, encode, v, D, Lk, Hkv, B, vs);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  const auto kernel = flash_attention_wgmma_kernel<D, kParts>;
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory must be asked for, once a card
  static bool configured[kMaxDevices] = {};
  if (device >= kMaxDevices || !configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) configured[device] = true;
  }
  const long long blocks = (long long)((Lq + kBlock - 1) / kBlock) * B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), os, Hq, Hq / Hkv, Lq,
      Lk, causal, (float)(sm_scale * 1.4426950408889634));   // log2(e)
  return (int)cudaGetLastError();
}

template <int kParts, int kOwners, int kOR, bool kMulti>
int launch_wide(const void* q, const void* k, const void* v, void* out,
                Strides qs, Strides ks, Strides vs, Strides os, int B, int Hq,
                int Hkv, int Lq, int Lk, int D, int causal, float sm_scale,
                int device, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult res = make_map(&tm_q, encode, q, D, Lq, Hq, B, qs, kWideRows);
  if (res == CUDA_SUCCESS)
    res = make_map(&tm_k, encode, k, D, Lk, Hkv, B, ks, kWideRows);
  if (res == CUDA_SUCCESS)
    res = make_map(&tm_v, encode, v, D, Lk, Hkv, B, vs, kWideRows);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  const auto kernel =
      flash_attention_wgmma_wide_kernel<kParts, kOwners, kOR, kMulti>;
  // asked for once a card, at the most any head_dim takes
  static bool configured[kMaxDevices] = {};
  if (device >= kMaxDevices || !configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxWideSmem);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) configured[device] = true;
  }
  const WideLayout lay(D);
  const long long blocks =
      (long long)((Lq + kWideRows - 1) / kWideRows) * B * Hq * lay.chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr WideSlots slots(kOwners, kOR, !kMulti);
  kernel<<<(unsigned)blocks, 128 * kOwners, slots.bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), os, Hq, Hq / Hkv, Lq,
      Lk, D, causal, (float)(sm_scale * 1.4426950408889634));   // log2(e)
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a CUDA runtime error of the launch, or 10000 plus
// the CUresult when a tensor map cannot be built.  q, k, v and out
// are bfloat16 with a contiguous head_dim, 16-byte-aligned bases and
// (batch, head, position) strides in elements that are multiples of 8;
// D is a positive multiple of 16 (the wide kernel past 128); p_parts, the
// bf16 parts P is split into for the tensor cores, 3, or at D 64 and 128
// also 1 or 2 (for tools/flash_rounding.py); sm_scale > 0; B * Hq, Lq and
// Lk positive, and the blocks, B * Hq * ceil(Lq / 128) up to D 128 and
// B * Hq * ceil(Lq / 64) * WideLayout(D).chunks past it, at most 2^31 - 1.
// The kernel runs asynchronously on `stream` of card `device`.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int Hq, int Hkv, int Lq,
                                 int Lk, int D, int p_parts, int causal,
                                 float sm_scale,
                                 long long q_sb, long long q_sh, long long q_ss,
                                 long long k_sb, long long k_sh, long long k_ss,
                                 long long v_sb, long long v_sh, long long v_ss,
                                 long long o_sb, long long o_sh, long long o_ss,
                                 int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Hkv <= 0 || Hq % Hkv != 0 || !(sm_scale > 0.f))
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
#define FA_LAUNCH(d, parts)                                                  \
  return launch<d, parts>(q, k, v, out, qs, ks, vs, os, B, Hq, Hkv, Lq, Lk, \
                          causal, sm_scale, device, stream)
  switch (D * 4 + p_parts) {
    case 64 * 4 + 1: FA_LAUNCH(64, 1);
    case 64 * 4 + 2: FA_LAUNCH(64, 2);
    case 64 * 4 + 3: FA_LAUNCH(64, 3);
    case 128 * 4 + 1: FA_LAUNCH(128, 1);
    case 128 * 4 + 2: FA_LAUNCH(128, 2);
    case 128 * 4 + 3: FA_LAUNCH(128, 3);
    case 16 * 4 + 3: FA_LAUNCH(16, 3);
    case 32 * 4 + 3: FA_LAUNCH(32, 3);
    case 48 * 4 + 3: FA_LAUNCH(48, 3);
    case 80 * 4 + 3: FA_LAUNCH(80, 3);
    case 96 * 4 + 3: FA_LAUNCH(96, 3);
    case 112 * 4 + 3: FA_LAUNCH(112, 3);
  }
#undef FA_LAUNCH
#define FA_LAUNCH_WIDE(owners, regions, multi)                              \
  return launch_wide<3, owners, regions, multi>(                             \
      q, k, v, out, qs, ks, vs, os, B, Hq, Hkv, Lq, Lk, D, causal, sm_scale, \
      device, stream)
  if (D > 128 && D % 16 == 0 && p_parts == 3) {
    const WideLayout lay(D);
    switch ((lay.owners * 8 + lay.owner_regions) * 2 +
            (lay.q_resident ? 0 : 1)) {
      case (1 * 8 + 3) * 2: FA_LAUNCH_WIDE(1, 3, false);
      case (1 * 8 + 4) * 2: FA_LAUNCH_WIDE(1, 4, false);
      case (3 * 8 + 2) * 2: FA_LAUNCH_WIDE(3, 2, false);
      case (4 * 8 + 2) * 2: FA_LAUNCH_WIDE(4, 2, false);
      case (3 * 8 + 2) * 2 + 1: FA_LAUNCH_WIDE(3, 2, true);
    }
  }
#undef FA_LAUNCH_WIDE
  return (int)cudaErrorInvalidValue;
}

// The FLOP of the products the wide kernel (head_dim past 128) has issued
// on card `device` since the last reset, as its warpgroups count them (the
// tiles each ran times its loop body's products a tile): q.k into flop[0],
// P.V into flop[1].  reset != 0
// zeroes the counts after reading them.  Returns a CUDA error (0 on
// success); synchronizes with the card's work on the legacy stream.
int flash_attention_wgmma_products(long long* flop, int reset, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(flop, g_wide_products, 2 * sizeof(long long));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    err = cudaMemcpyToSymbol(g_wide_products, zero, sizeof zero);
  }
  return (int)err;
}

// Blocks the kernel gives a q tile at head_dim D (a positive multiple of
// 16): 1 up to 512, past it WideLayout(D).chunks; 0 for another D.
int flash_attention_wgmma_chunks(int D) {
  if (D % 16 != 0 || D < 16) return 0;
  return D > 128 ? WideLayout(D).chunks : 1;
}

// Dynamic shared memory of a block at head_dim D (a positive multiple of
// 16), in bytes; 0 for another D.
int flash_attention_wgmma_smem_bytes(int D) {
  if (D % 16 != 0 || D < 16) return 0;
  if (D > 128) {
    const WideLayout lay(D);
    return WideSlots(lay.owners, lay.owner_regions, lay.q_resident).bytes;
  }
  return (int)(D <= 64 ? smem_bytes<64>() : smem_bytes<128>());
}

}  // extern "C"
