// Dequant-matmul kernels for Hopper (sm_90a): the MoP expert FFN's hot spot.
//
// Replaces the reference's Pallas TPU kernels:
//   dequant_matmul<4>  <- src/repro/kernels/q4_matmul.py  _q4_kernel (B1)
//                         and grouped_matmul.py _grouped_q_kernel, bits=4 (B3)
//   dequant_matmul<8>  <- src/repro/kernels/q4_matmul.py  _q8_kernel (B2)
//                         and grouped_matmul.py _grouped_q_kernel, bits=8 (B3)
//   bf16_matmul        <- src/repro/kernels/grouped_matmul.py
//                         _grouped_bf16_kernel (B4)
// and, in the epilogue of each, the f32 accumulator that those kernels
// carry across their sequential K grid axis and flush once (_flush).
// The matmuls compute out[g] = x[g] @ W[g] for a bank of G experts in one
// launch: x (G, M, K) bf16, W (G, K/2, N) uint8 | (G, K, N) int8 |
// (G, K, N) bf16, scales (G, K/group, N) bf16, out (G, M, N) bf16. B1/B2 are a launch with
// G = 1 through the same code, so the grouped result equals the per-expert
// result bit for bit.
//
// Three bodies, chosen by the plan's token tile (launch_plan in
// kernels/q4_matmul.py names it): the mma.sync body below for tiles of 8,
// 16, 32 and 64 tokens (C <= 64: decode, the speculative verify), the
// wgmma body of wgmma_body.cuh for the 128-token tile (64 < C <= 128, and
// C = 161-256 in two tiles), and its wide variant (wgmma_wide.cuh) for the
// 160-token tile (the other C > 128: prompts of 257 tokens and more at
// Mixtral's top-2 of 8). All compute the same arithmetic and replace the
// same TPU kernels.
//
// The mma.sync body: one templated tensor-core body, swap-AB. The kernel computes
// out[g]^T = W[g]^T . x[g]^T with mma.sync.m16n8k16 (bf16 x bf16 -> f32):
// weight columns N are the mma's M side (16 per fragment), tokens C its N
// side (8 per fragment), so a decode buffer of C = 8 rows is exactly one
// fragment and nothing is padded to 64 rows. A block is 4 warps over 128
// columns and 8 * NT tokens (NT = 1, 2, 4 or 8); thread (gid, tig) of a
// warp holds the four consecutive columns 4*gid .. 4*gid+3 of the warp's
// 32, so one 32-bit shared load gives it one K pair of all four (int4 packs
// the K pair (2b, 2b+1) of a column in one byte: one bf16x2 A register).
// B comes from the x rows of the stage with ldmatrix.
//
// The wgmma body: three warpgroups over 128 columns and 128 tokens. A
// producer warp keeps TMA loads (cp.async.bulk.tensor, 3-D tensor maps over
// (G, rows, cols), 128-byte swizzle) of 64-K stages in flight on mbarriers;
// two consumer warpgroups of 64 columns issue wgmma.m64n128k16, swap-AB as
// above, x the B operand from shared memory, int4/int8 codes converted in
// registers (the conversions below) as the register A operand, bf16 weights
// the A operand from shared memory (MN-major).
//
// Arithmetic (both bodies). Integer codes enter the tensor core as bf16 integers
// (|code| <= 128 is exact in bf16's 8-bit significand): int4 through the
// 0x4300 magic number (bf16 128 + nibble, minus 136), int8 as the bf16
// difference (128 + low 7 bits) - (128 or 256 by the sign bit). Each
// quantization group (or each 64 K, whichever is smaller) accumulates into
// a fresh f32 fragment, which is then added into the output accumulator
// times the column's f32 scale: acc = fmaf(part, scale[n], acc). W is
// never rounded to bf16: every product x * code is exact in the tensor
// core, and an integer-valued partial times a bf16 scale is exact in f32
// while it fits 24 bits, so an all-zero activation group gives exact
// zeros and integer-friendly inputs are exact. Within a K split the group partials of an output are added in
// ascending K order; bf16_matmul is the same body with BITS = 16, no scale
// step, and the mma accumulating straight into acc (the tensor core's own
// order within each k16 step, ascending k16 steps).
//
// Split-K. launch_plan(c, k, n, bits) in kernels/q4_matmul.py fixes the
// body, the tile and the K splits from the shape alone (no G): split
// boundaries are multiples of 64, at most 16 splits. With one split the
// kernel writes bf16. With more, each split block writes its f32 partial
// to a workspace (splits, G, M, N) that the wrapper allocates and counts
// itself in on its tile's counter (one int per (expert, token tile, column
// tile), handed in by the wrapper). The block that arrives last reads
// every split's partial of its tile back, adds them in order 0, 1, ...
// and rounds once to bf16 (split_last and the two bodies' epilogues; the
// mma.sync body loads several planes of its outputs at once, the wgmma
// body brings the planes into shared memory with TMA). The order of the
// adds does not depend on the order in which the blocks arrive, and there
// are no float atomics: the same inputs give the same bits on every run
// and for every G. No second kernel runs: a stand-alone reduction cost a
// launch of its own, more than its bound, after every split launch. (A
// reduction inside a thread-block cluster, through distributed shared
// memory, was tried during development and was slower at the decode
// shapes.)
//
// Folded grids. The splits fix a row's arithmetic; how many blocks run
// them is the grid's choice. A "spread" launch gives each split a block
// of its own (above). A "folded" launch (fold_splits in q4_matmul.py
// chooses it, from G x tiles against a wave of the card) gives each tile
// one block that runs the plan's splits in turn as K segments: each
// segment's f32 partial is computed as a split block computes it (fresh
// accumulator, the same groups and fmaf), then added into a running sum in
// segment order, ((p0 + p1) + p2) + ..., the first segment stored as it
// is: split_last's and reduce_tile's order. The sum is rounded once to
// bf16. So a folded tile's bytes equal the spread tile's, and the grid may
// depend on G while no bit does. A folded launch has no workspace, no
// arrival and no read-back. The entry points hand it to the kernels as a
// launch of one split over the whole K (Args::seg, the segment, set).
//
// What bounds it on the H100, and what the design does about it:
//   * decode (C <= 16, the mma.sync body): the weight bytes. ~2*C FLOPs per weight element is
//     far below the card's ~295 FLOP/byte ridge. Weights stream through a
//     per-block ring of cp.async (16-byte, .cg) stages, 64 K deep, as many
//     as fit 72 KB (up to 8, so up to 7 in flight) with one __syncthreads
//     per stage; the split-K plan puts >= 2 blocks on every SM at G = 1
//     (the down-projection's N = 4096 alone gives only 32 column tiles).
//     No f32 weight tile exists in shared memory: codes go from the ring
//     to registers to the mma. At int4 the per-byte instruction count
//     (conversion, ldmatrix, mma, group flush), not the bytes, is what
//     is left.
//   * prefill (C > 64, the wgmma body): the tensor-core operations at
//     int4 (0.046 ms for three up-projection experts at C = 128 against
//     0.028 ms of bytes), the weight bytes at int8 and bf16. mma.sync at
//     64-token tiles converted and loaded every weight tile twice at C =
//     128 (four times at C = 256), fed one converted fragment to at most 8
//     token fragments and issued every copy from the threads. The wgmma
//     body converts each weight fragment once for 128 tokens, leaves the
//     x operand to the tensor core's own shared-memory reads and the copies
//     to the TMA unit, and gives the registers the producer does not need
//     to the consumers' f32 partials and accumulator (64 + 2 x 64 a
//     thread). What is left at int4 and int8 is the conversions, group
//     flushes and barrier waits, one serial chain a stage per consumer
//     warpgroup, about twice the tensor core's time (wgmma_body.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;                 // K per pipeline stage
constexpr int WARPS_N = 4;             // warps across the block's columns
constexpr int WN = 32;                 // columns per warp (2 m16 fragments)
constexpr int BN = WARPS_N * WN;       // columns per block
constexpr int SCALE_ROWS = 4;          // scale rows per stage (group 16)
constexpr int X_STRIDE = 144;          // bytes per token row of a stage
constexpr int SMEM_BUDGET = 72 * 1024; // three blocks per SM (NT <= 4)
constexpr int SMEM_BUDGET_NT8 = 112 * 1024;  // two blocks per SM (NT = 8)
constexpr int MAX_SPLITS = 16;         // K splits a plan may take
constexpr int MAX_FOLD_NT = 2;         // mma.sync tiles that may fold: 8, 16

// Shared-memory layout of one (BITS, NT) instantiation. A stage holds
// the raw weight rows (padded so a warp's four K-pair rows fall on distinct
// banks), the scale rows and the x rows of one 64-K step.
template <int BITS, int NT>
struct Tile {
  static constexpr int THREADS = 32 * WARPS_N;
  static constexpr int BC = 8 * NT;                      // tokens per block
  static constexpr int ELEM = BITS == 16 ? 2 : 1;        // bytes per code
  static constexpr int W_ROWS = BITS == 4 ? BK / 2 : BK; // stored rows
  static constexpr int W_ROW_BYTES = BN * ELEM;
  static constexpr int W_STRIDE = W_ROW_BYTES + (BITS == 8 ? 16 : 32);
  static constexpr int W_BYTES = W_ROWS * W_STRIDE;
  static constexpr int S_BYTES = BITS == 16 ? 0 : SCALE_ROWS * BN * 2;
  static constexpr int X_BYTES = BC * X_STRIDE;
  static constexpr int STAGE_BYTES = W_BYTES + S_BYTES + X_BYTES;
  static constexpr int STAGES_FIT =
      (NT >= 8 ? SMEM_BUDGET_NT8 : SMEM_BUDGET) / STAGE_BYTES;
  static constexpr int STAGES =
      STAGES_FIT < 2 ? 2 : (STAGES_FIT > 8 ? 8 : STAGES_FIT);
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static constexpr int MIN_BLOCKS = NT >= 8 ? 2 : 3;   // per SM
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; ``bytes`` = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t lds32(const char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint2 lds64(const char* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void store_bf16x4(uint16_t* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 o;
  o.x = *reinterpret_cast<uint32_t*>(&lo);
  o.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = o;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// Byte j of ``w`` (K pair (2b, 2b+1) of one column as (low, high) nibbles,
// offset by 8) -> bf16x2 (low - 8, high - 8). ``u`` is w >> 4.
__device__ __forceinline__ uint32_t int4_pair(uint32_t w, uint32_t u, int j) {
  const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
  const uint32_t v = (__byte_perm(w, u, sel) & 0x000F000Fu) | 0x43004300u;
  const uint32_t bias = 0x43084308u;               // bf16x2 (136, 136)
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Int8 codes in bytes 0 and 2 of ``p`` -> bf16x2 (code_0, code_2),
// exactly: a code b is (b & 0x7F) - 128 * sign, so bf16 (128 + (b & 0x7F))
// minus bf16 (128 or 256, by the sign bit) is b.
__device__ __forceinline__ uint32_t int8_bf16x2(uint32_t p) {
  const uint32_t mag = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t sub = (p & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                             *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Int8 byte j of ``lo`` and of ``hi`` -> bf16x2 (code_lo, code_hi).
__device__ __forceinline__ uint32_t int8_pair(uint32_t lo, uint32_t hi,
                                              int j) {
  const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
  return int8_bf16x2(__byte_perm(lo, hi, sel));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of one k16 step for token fragments t and t+1 (x4) or t
// alone (x2), from the x rows of a stage; ``addr`` is this lane's row.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const char* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const char* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

struct Args {
  const uint16_t* x;       // (G, M, K)
  const uint8_t* w;        // the expert bank, BITS-dependent layout
  const uint16_t* scales;  // (G, K/gs, N) or null
  uint16_t* out;           // (G, M, N) bf16
  float* ws;               // (splits, G, M, N) f32, written when splits > 1
  unsigned* counters;      // one per tile, zero between launches (splits > 1)
  int G, M, K, N, gs, k_chunk, splits;
  int seg;                 // K per segment when folded (the plan's k_chunk)
};

// A block's place: expert g, K split ``split``, token tile mt of mtiles
// and column tile nt of ntiles. Each body's grid has one decoder into it
// (grid_place below, block_place in wgmma_body.cuh), which its kernel, its
// counter and its epilogue all read.
struct Place {
  int g, split, mt, nt, mtiles, ntiles;
};

// The counter of the block's tile, (g, token tile, column tile): one per
// tile, whatever order the grid runs the tiles in.
__device__ __forceinline__ int tile_index(const Place& p) {
  return (p.g * p.mtiles + p.mt) * p.ntiles + p.nt;
}

// The mma.sync body's grid: (column tiles, token tiles x splits, G).
__device__ __forceinline__ Place grid_place(const Args& a) {
  const int mtiles = gridDim.y / a.splits;
  const int ntiles = gridDim.x;
  const int mt = blockIdx.y / a.splits;
  const int nt = blockIdx.x;
  const int split = blockIdx.y % a.splits;
  const int g = blockIdx.z;
  return Place{g, split, mt, nt, mtiles, ntiles};
}

// A barrier over the threads that write the block's partial: the whole
// block (THREADS = 0: __syncthreads), or named barrier 1 over the first
// THREADS threads (the wgmma body's consumer warpgroups; its producer
// warpgroup may have exited).
template <int THREADS>
__device__ __forceinline__ void split_sync() {
  if constexpr (THREADS == 0) __syncthreads();
  else asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

// The split-K arrival, called by every writing thread once its partial is
// in the workspace: after a barrier one thread counts the block in on its
// tile's counter with an acquire-release atomic (release: the block's
// partial, ordered before it by the barrier; acquire: the partials of the
// blocks counted before), and every thread learns through ``slot`` (a word
// of the caller's dynamic shared memory that no thread uses past the first
// barrier) whether the block arrived last: then it reduces the tile. inc
// with limit splits - 1 wraps the counter to 0 on the last arrival, so it
// is zero again for the next launch and for the next replay of a captured
// graph. Hazard: two split launches on one device running at once on
// different streams would share the counters; the port launches its
// matmuls on the current stream only. (A static __shared__ word here would
// move the mma.sync body's dynamic shared memory off its 128-byte
// alignment, which cost its decode launches ~10% on the card.)
template <int THREADS>
__device__ __forceinline__ bool split_last(const Args& a, int tile,
                                           int* slot) {
  split_sync<THREADS>();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
                 : "=r"(old)
                 : "l"(a.counters + tile), "r"(a.splits - 1)
                 : "memory");
    *slot = old == static_cast<unsigned>(a.splits - 1);
  }
  split_sync<THREADS>();
  return *slot;
}

// Issue the cp.async copies of one 64-K stage starting at ``k0``; rows at
// or past ``kend`` (and columns past N, tokens past M) are zero-filled.
template <int BITS, int NT>
__device__ __forceinline__ void load_stage(
    char* st, const uint16_t* xg, const uint8_t* wg, const uint16_t* sg,
    const Args& a, int k0, int kend, int m0, int n0) {
  using T = Tile<BITS, NT>;
  const int tid = threadIdx.x;
  // weights: rows of W_ROW_BYTES, 16-byte chunks, consecutive threads on
  // consecutive chunks of a row
  constexpr int W_CPR = T::W_ROW_BYTES / 16;
  constexpr int W_CHUNKS = T::W_ROWS * W_CPR;
  static_assert(W_CHUNKS % T::THREADS == 0, "weight chunks split evenly");
  const int row0 = BITS == 4 ? k0 / 2 : k0;
  const int row_end = BITS == 4 ? kend / 2 : kend;
#pragma unroll
  for (int i = 0; i < W_CHUNKS / T::THREADS; ++i) {
    const int e = tid + i * T::THREADS;
    const int r = e / W_CPR, c = e % W_CPR;
    const int col = n0 + c * 16 / T::ELEM;
    const bool ok = row0 + r < row_end && col < a.N;
    const uint8_t* src =
        wg + (static_cast<size_t>(row0 + r) * a.N + col) * T::ELEM;
    cp_async16(st + r * T::W_STRIDE + c * 16, ok ? src : wg, ok ? 16 : 0);
  }
  if constexpr (BITS != 16) {
    // scale rows of the groups this stage touches (one when gs >= 64)
    const int rows = a.gs >= BK ? 1 : BK / a.gs;
    char* ss = st + T::W_BYTES;
    if (tid < rows * 16) {
      const int r = tid / 16, c = tid % 16;
      const int srow = k0 / a.gs + r;
      const int col = n0 + c * 8;
      const bool ok = srow * a.gs < kend && col < a.N;
      const uint16_t* src = sg + static_cast<size_t>(srow) * a.N + col;
      cp_async16(ss + r * BN * 2 + c * 16, ok ? src : sg, ok ? 16 : 0);
    }
  }
  // x: BC token rows of 64 bf16 (8 chunks each)
  char* xs = st + T::W_BYTES + T::S_BYTES;
  constexpr int X_CHUNKS = T::BC * 8;
#pragma unroll
  for (int i = 0; i < (X_CHUNKS + T::THREADS - 1) / T::THREADS; ++i) {
    const int e = tid + i * T::THREADS;
    if (e < X_CHUNKS) {
      const int r = e / 8, c = e % 8;
      const int m = m0 + r, k = k0 + c * 8;
      const bool ok = m < a.M && k < kend;
      const uint16_t* src = xg + static_cast<size_t>(m) * a.K + k;
      cp_async16(xs + r * X_STRIDE + c * 16, ok ? src : xg, ok ? 16 : 0);
    }
  }
}

// The A fragments of one k16 step for the thread's two m16 fragments:
// a[j] = {row gid, row gid+8} x {k 2tig.., k 2tig+8..} of fragment j, where
// fragment j's rows gid and gid+8 are the thread's columns 2j and 2j+1.
template <int BITS>
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const char* wsm,
                                       int stride, int step, int colb,
                                       int tig) {
  if constexpr (BITS == 4) {
    const char* base = wsm + (step * 8 + tig) * stride + colb;
    const uint32_t w0 = lds32(base), w1 = lds32(base + 4 * stride);
    const uint32_t u0 = w0 >> 4, u1 = w1 >> 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      a[j][0] = int4_pair(w0, u0, 2 * j);
      a[j][1] = int4_pair(w0, u0, 2 * j + 1);
      a[j][2] = int4_pair(w1, u1, 2 * j);
      a[j][3] = int4_pair(w1, u1, 2 * j + 1);
    }
  } else if constexpr (BITS == 8) {
    const char* base = wsm + (step * 16 + 2 * tig) * stride + colb;
    const uint32_t r0 = lds32(base), r1 = lds32(base + stride);
    const uint32_t r2 = lds32(base + 8 * stride);
    const uint32_t r3 = lds32(base + 9 * stride);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      a[j][0] = int8_pair(r0, r1, 2 * j);
      a[j][1] = int8_pair(r0, r1, 2 * j + 1);
      a[j][2] = int8_pair(r2, r3, 2 * j);
      a[j][3] = int8_pair(r2, r3, 2 * j + 1);
    }
  } else {
    const char* base = wsm + (step * 16 + 2 * tig) * stride + colb;
    const uint2 r0 = lds64(base), r1 = lds64(base + stride);
    const uint2 r2 = lds64(base + 8 * stride), r3 = lds64(base + 9 * stride);
    a[0][0] = __byte_perm(r0.x, r1.x, 0x5410);
    a[0][1] = __byte_perm(r0.x, r1.x, 0x7632);
    a[0][2] = __byte_perm(r2.x, r3.x, 0x5410);
    a[0][3] = __byte_perm(r2.x, r3.x, 0x7632);
    a[1][0] = __byte_perm(r0.y, r1.y, 0x5410);
    a[1][1] = __byte_perm(r0.y, r1.y, 0x7632);
    a[1][2] = __byte_perm(r2.y, r3.y, 0x5410);
    a[1][3] = __byte_perm(r2.y, r3.y, 0x7632);
  }
}

// FOLD: the launch is folded (a.seg > 0): one block a tile runs its K
// segments in turn, streaming the cp.async ring straight through their
// boundaries (each stage lies in one segment: segments are multiples of
// BK), and keeps their running sum in registers (2 NT 4 floats).
template <int BITS, int NT, bool FOLD>
__global__ void __launch_bounds__(Tile<BITS, NT>::THREADS,
                                  Tile<BITS, NT>::MIN_BLOCKS)
tc_matmul_kernel(Args a) {
  using T = Tile<BITS, NT>;
  constexpr int S = T::STAGES;
  extern __shared__ __align__(16) char smem[];
  const Place place = grid_place(a);
  const int g = place.g, split = place.split;
  const int m0 = place.mt * T::BC;
  const int n0 = place.nt * BN;
  const int kbeg = split * a.k_chunk;
  const int kend = min(a.K, kbeg + a.k_chunk);
  const int nst = (kend - kbeg + BK - 1) / BK;

  const size_t w_expert = static_cast<size_t>(BITS == 4 ? a.K / 2 : a.K)
      * a.N * T::ELEM;
  const uint16_t* xg = a.x + static_cast<size_t>(g) * a.M * a.K;
  const uint8_t* wg = a.w + g * w_expert;
  const uint16_t* sg = BITS == 16 ? a.x
      : a.scales + static_cast<size_t>(g) * (a.K / a.gs) * a.N;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = warp;
  const int colb = (wn * WN + 4 * gid) * T::ELEM;  // byte in a weight row
  const int spf = (a.gs < BK ? a.gs : BK) / 16;    // k16 steps per flush

  float acc[2][NT][4], part[2][NT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = part[j][t][i] = 0.0f;
  float tot[2][NT][4];                      // folded: the segments' sum
  const int sst = FOLD ? a.seg / BK : 0;    // folded: stages a segment
  int left = sst;                           // stages left in the segment
  // this lane's row address for ldmatrix: matrix q = lane / 8 is token
  // fragment q / 2, K half q % 2
  const int ldm = ((NT >= 2 ? lane >> 4 : 0) * 8 + (lane & 7)) * X_STRIDE
      + ((lane >> 3) & 1) * 16;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst)
      load_stage<BITS, NT>(smem + s * T::STAGE_BYTES, xg, wg, sg, a,
                               kbeg + s * BK, kend, m0, n0);
    cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();       // stage ``it`` landed; stage it-1 fully read
    const int nx = it + S - 1;
    if (nx < nst)
      load_stage<BITS, NT>(smem + (nx % S) * T::STAGE_BYTES, xg, wg, sg,
                           a, kbeg + nx * BK, kend, m0, n0);
    cp_async_commit();
    const char* st = smem + (it % S) * T::STAGE_BYTES;
    const char* xs = st + T::W_BYTES + T::S_BYTES;
#pragma unroll
    for (int step = 0; step < BK / 16; ++step) {
      uint32_t af[2][4];
      load_a<BITS>(af, st, T::W_STRIDE, step, colb, tig);
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t bf[4];
        const char* xr = xs + t * 8 * X_STRIDE + ldm + step * 32;
        if constexpr (NT >= 2) ldmatrix_x4(bf, xr);
        else ldmatrix_x2(bf, xr);
#pragma unroll
        for (int u = 0; u < (NT >= 2 ? 2 : 1); ++u)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t b0 = bf[2 * u], b1 = bf[2 * u + 1];
            if constexpr (BITS == 16) mma_bf16(acc[j][t + u], af[j], b0, b1);
            else mma_bf16(part[j][t + u], af[j], b0, b1);
          }
      }
      if constexpr (BITS != 16) {
        if ((step + 1) % spf == 0) {      // a group's partial is complete
          const int srow = a.gs >= BK ? 0 : step * 16 / a.gs;
          const uint2 sv = lds64(st + T::W_BYTES + srow * BN * 2
                                 + (wn * WN + 4 * gid) * 2);
          const float sc[2][2] = {{bf16_lo(sv.x), bf16_hi(sv.x)},
                                  {bf16_lo(sv.y), bf16_hi(sv.y)}};
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[j][t][i] = fmaf(part[j][t][i], sc[j][i >> 1],
                                    acc[j][t][i]);
                part[j][t][i] = 0.0f;
              }
        }
      }
    }
    if constexpr (FOLD) {
      // a segment's last stage: its partial joins the running sum in
      // segment order (the first as it is: split_last's adds), and acc
      // starts the next segment from zero
      if (--left == 0 || it + 1 == nst) {
        const bool first = it < sst;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              tot[j][t][i] = first ? acc[j][t][i]
                                   : tot[j][t][i] + acc[j][t][i];
              acc[j][t][i] = 0.0f;
            }
        left = sst;
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (FOLD) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][t][i] = tot[j][t][i];
  }

  // thread's outputs: columns n .. n+3, tokens m and m+1 per fragment
  const int n = n0 + wn * WN + 4 * gid;
  const bool cols = n < a.N;             // N % 16 == 0: all four or none
  if (a.splits == 1) {
    if (!cols) return;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + t * 8 + 2 * tig + h;
        if (m < a.M)
          store_bf16x4(a.out + (static_cast<size_t>(g) * a.M + m) * a.N + n,
                       make_float4(acc[0][t][h], acc[0][t][2 + h],
                                   acc[1][t][h], acc[1][t][2 + h]));
      }
    return;
  }
  // K split: this split's f32 partial goes to the workspace (splits, G,
  // M, N); the tile's last block adds the splits in order
  const size_t plane = static_cast<size_t>(a.G) * a.M * a.N;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + t * 8 + 2 * tig + h;
      if (cols && m < a.M)
        *reinterpret_cast<float4*>(
            a.ws + split * plane + (static_cast<size_t>(g) * a.M + m) * a.N
            + n) = make_float4(acc[0][t][h], acc[0][t][2 + h], acc[1][t][h],
                               acc[1][t][2 + h]);
    }
  // the ring's first word: every thread is past its last stage
  if (!split_last<0>(a, tile_index(place), reinterpret_cast<int*>(smem))
      || !cols)
    return;
  // the tile's last block: the split planes in order, U planes of all the
  // thread's outputs in flight at once (64 registers of loads)
  constexpr int U = NT >= 8 ? 1 : 8 / NT;
  const float* wt = a.ws + static_cast<size_t>(g) * a.M * a.N + n;
  float4 sum[NT][2];
#pragma unroll 1
  for (int p0 = 0; p0 < a.splits; p0 += U) {
    float4 v[U][NT][2];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + t * 8 + 2 * tig + h;
          if (p0 + u < a.splits && m < a.M)
            v[u][t][h] = __ldcg(reinterpret_cast<const float4*>(
                wt + (p0 + u) * plane + static_cast<size_t>(m) * a.N));
        }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (p0 + u >= a.splits) continue;
          if (p0 + u == 0) {
            sum[t][h] = v[u][t][h];
          } else {
            sum[t][h].x += v[u][t][h].x; sum[t][h].y += v[u][t][h].y;
            sum[t][h].z += v[u][t][h].z; sum[t][h].w += v[u][t][h].w;
          }
        }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + t * 8 + 2 * tig + h;
      if (m < a.M)
        store_bf16x4(a.out + (static_cast<size_t>(g) * a.M + m) * a.N + n,
                     sum[t][h]);
    }
}

template <int BITS, int NT, bool FOLD>
int launch(const Args& a, cudaStream_t s) {
  using T = Tile<BITS, NT>;
  // raise the dynamic-smem cap once per card: the attribute belongs to
  // the current device, and an expert-parallel mesh launches on several
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static unsigned long long smem_set = 0;   // bit d: set on device d
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(smem_set & bit)) {
    e = cudaFuncSetAttribute(
        tc_matmul_kernel<BITS, NT, FOLD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set |= bit;
  }
  const dim3 grid((a.N + BN - 1) / BN,
                  ((a.M + T::BC - 1) / T::BC) * a.splits, a.G);
  tc_matmul_kernel<BITS, NT, FOLD><<<grid, T::THREADS, T::SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#include "wgmma_body.cuh"

// Folded mma.sync launches exist for the token tiles of 8 and 16 (decode,
// the speculative verify): at 32 and 64 the running sum's registers would
// spill under __launch_bounds__, so those tiles always spread.
template <int BITS, int NT>
int launch_mma(const Args& a, cudaStream_t s) {
  if constexpr (NT <= MAX_FOLD_NT)
    if (a.seg) return launch<BITS, NT, true>(a, s);
  if (a.seg) return static_cast<int>(cudaErrorInvalidValue);
  return launch<BITS, NT, false>(a, s);
}

template <int BITS>
int launch_bits(const Args& a, int block_c, cudaStream_t s) {
  switch (block_c) {
    case 8: return launch_mma<BITS, 1>(a, s);
    case 16: return launch_mma<BITS, 2>(a, s);
    case 32: return launch_mma<BITS, 4>(a, s);
    case 64: return launch_mma<BITS, 8>(a, s);
    case 128: return wg::launch<BITS, 128>(a, s);
    case 160: return wg::launch<BITS, 160>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan must be one launch_plan gives: 128-column tiles, a supported
// token tile (8, 16, 32 or 64: mma.sync; 128: wgmma; 160: the wide wgmma
// body), 64-aligned K splits that cover K exactly (at most MAX_SPLITS), and
// a workspace and the tiles' counters when there is more than one and the
// launch is spread; a folded launch has more than one and needs neither.
bool plan_ok(const Args& a, int block_n, int fold) {
  if (block_n != BN || a.k_chunk <= 0 || a.k_chunk % BK) return false;
  if (a.splits < 1 || a.splits > MAX_SPLITS) return false;
  if (a.splits != (a.K + a.k_chunk - 1) / a.k_chunk) return false;
  if (fold) return a.splits > 1 && a.K % 16 == 0 && a.N % 16 == 0;
  if (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr))
    return false;
  return a.K % 16 == 0 && a.N % 16 == 0;
}

// A folded launch as the kernels take it: one split over the whole K, its
// plan's splits as segments of ``seg`` K.
Args folded(Args a) {
  a.seg = a.k_chunk;
  a.k_chunk *= a.splits;
  a.splits = 1;
  a.ws = nullptr;
  a.counters = nullptr;
  return a;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on ``stream`` and
// returns the launch's CUDA error code so a refused launch is reported to
// the caller. Shape contract (checked by the Python wrappers): N % 16 == 0,
// K % 16 == 0, the quantization group a multiple of 16 that divides 64 or
// that 64 divides, group | K, all tensors contiguous and 16-byte aligned.
// The tile and split arguments come from launch_plan. ``fold`` 0 spreads
// the splits over blocks: with more than one split the kernel writes the
// f32 workspace ``ws`` (splits, G, M, N), and ``counters`` holds one zeroed
// int per tile, G * ceil(M / block_c) * ceil(N / block_n) of them, which
// the launch leaves zeroed. ``fold`` 1 (a plan of more than one split)
// runs a tile's splits in one block and takes neither.
extern "C" int repro_dequant_matmul(
    int bits, const void* x, const void* w, const void* scales, void* out,
    void* ws, void* counters, int G, int M, int K, int N, int group_size,
    int block_n, int block_c, int k_chunk, int splits, int fold,
    void* stream) {
  const Args a{static_cast<const uint16_t*>(x),
               static_cast<const uint8_t*>(w),
               static_cast<const uint16_t*>(scales),
               static_cast<uint16_t*>(out), static_cast<float*>(ws),
               static_cast<unsigned*>(counters), G, M, K, N, group_size,
               k_chunk, splits, 0};
  const bool gs_ok = group_size >= 16 && group_size % 16 == 0
      && (BK % group_size == 0 || group_size % BK == 0)
      && K % group_size == 0;
  if (!plan_ok(a, block_n, fold) || !gs_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args run = fold ? folded(a) : a;
  if (bits == 4) return launch_bits<4>(run, block_c, s);
  if (bits == 8) return launch_bits<8>(run, block_c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int repro_bf16_matmul(const void* x, const void* w, void* out,
                                 void* ws, void* counters, int G, int M,
                                 int K, int N, int block_n, int block_c,
                                 int k_chunk, int splits, int fold,
                                 void* stream) {
  const Args a{static_cast<const uint16_t*>(x),
               static_cast<const uint8_t*>(w), nullptr,
               static_cast<uint16_t*>(out), static_cast<float*>(ws),
               static_cast<unsigned*>(counters), G, M, K, N, BK, k_chunk,
               splits, 0};
  if (!plan_ok(a, block_n, fold))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bits<16>(fold ? folded(a) : a, block_c,
                         static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef REPRO_STAMPS
// The stage stamps of the stamped build (wgmma_body.cuh), for
// tools/consumer_timeline.py: their layout (blocks, warpgroups, stages,
// points), a copy into ``host`` and a reset to zero.
extern "C" void repro_stamps_layout(int* dims) {
  dims[0] = wg::STAMP_BLOCKS;
  dims[1] = wg::STAMP_ROLES;
  dims[2] = wg::STAMP_STAGES;
  dims[3] = wg::ST_POINTS;
}

extern "C" int repro_stamps_read(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, wg::g_stamps, sizeof(wg::g_stamps)));
}

extern "C" int repro_stamps_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, wg::g_stamps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemset(p, 0, sizeof(wg::g_stamps)));
}
#endif
