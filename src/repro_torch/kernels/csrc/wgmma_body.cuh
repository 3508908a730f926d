// The Hopper body of dequant_matmul<4|8> and bf16_matmul: every launch whose
// plan has a 128-token tile (64 < C <= 128) or, with the consumers of
// wgmma_wide.cuh, a 160-token tile (C > 128). dequant_matmul.cu includes
// this file; its head note describes the bodies and what each replaces.
//
// A block is three warpgroups over 128 weight columns and BC tokens (128 or
// 160) of one expert and one K split; what follows describes BC = 128.
// Warpgroup 2 is the producer: one thread keeps TMA loads in flight into a
// ring of 64-K stages (the x rows, the weight rows and the scale rows of a
// stage complete on one mbarrier) and gives its registers to the consumers
// (setmaxnreg). Warpgroups 0 and 1 are the consumers, 64 columns each, and
// issue wgmma.m64n128k16 (bf16 x bf16 -> f32) swap-AB: weight columns are
// the M side, tokens the N side. x is the
// B operand, read by the tensor core from the stage (K-major, 128-byte
// swizzle). bf16 weights are the A operand from the stage as well (MN-major,
// the transpose bit of 16-bit types). Int4 and int8 codes are the A operand
// from registers: ldmatrix.trans hands a consumer thread its two columns'
// codes, which dequant_matmul.cu's exact conversions turn into the m16n8k16
// A fragment layout that wgmma takes per warp (row gid is the thread's
// column 2 * gid, row gid + 8 its column 2 * gid + 1 of the warp's 16).
// Each group of min(group, 64) K runs its k16 steps into a fresh f32
// partial (scale-d 0 on its first step) that is then added as acc =
// fmaf(part, scale[n], acc): the arithmetic of the mma.sync body. Two
// partials take turns, so a group's flush runs while the next group's
// wgmmas do; the next stage's codes are converted once a stage's wgmmas
// are done (their fragments are registers the wgmmas read). The tensor
// maps are 3-D over (G, rows, cols), so a ragged token, column or K edge is
// zero-filled by the TMA unit and never reads the next expert.
//
// Where the int time goes (per-stage clock stamps, tools/consumer_timeline.py,
// PERF.md): each consumer warpgroup runs one serial chain a stage,
// ~1,230-1,250 (int4) to ~1,360-1,390 (int8) cycles at 128 tokens against
// the tensor core's 512 for the block's eight wgmmas: issue (~120-250),
// wgmma_wait<1>, the flush (~170-340), the release, wgmma_wait<0>, the
// next stage's full wait (~115-170) and its conversion (~220-320 int4,
// ~390-410 int8). The chain is the warpgroup's own CUDA-core and
// shared-memory work, ~1,000 cycles of it against 256 of its own wgmmas, so
// no order of the two warpgroups' issues shortens it: taking turns to
// issue (wgmma_wide.cuh's turn_take; the warpgroups then issue 460-490
// cycles apart) left the period as it was and, with a copy of the K loop a
// warpgroup, ran these rows 2-5% slower, so this body issues at will. The
// loop's SASS is near its floor (64 FFMA and 74 or 101 conversion
// instructions a stage against 48 or 64), and the producer runs ~7 stages
// ahead. Schedules that take work off the chain or move it ran slower and
// are not kept: a second fragment set, converted and flushed while the
// stage's own wgmmas run (0.95-1.02x); converter warps in the producer's
// warpgroup writing a bf16 A tile for shared-memory wgmmas (0.53-0.68x);
// the next stage's full wait and ldmatrix, or the flush's scale, read
// ahead under the flush (0.92-0.97x: registers the loop cannot spare).
// ptxas serialises every wgmma of the kernel (C7514) where a barrier wait
// or a loop's back edge lies between a group's issue and the flush of its
// partial, so no group stays in flight across one. A variant that
// multicast the x tile over a cluster of two or four blocks ran no faster.
//
// Past one token tile the grid runs the token tiles of a column tile side
// by side (block_place), so the weights cross HBM once per column tile and
// reach the later tiles from L2. The bf16 bank, bound by those bytes, also
// pairs the token tiles in a cluster of two whose producers multicast one
// 64-column weight box each into both blocks (produce); the int banks run
// no cluster: a pair gained them nothing on the card, its split of their
// weight rows into two boxes cost them time (PERF.md), and the flushes,
// not the L2 reads, set their time.
//
// A folded launch (dequant_matmul.cu's head note: a tile's K splits run
// in turn in one block) streams the segments' stages through the ring as
// one K range; the consumers end each segment with no wgmma in flight and
// keep the segments' running sum in shared memory, a plane of their
// accumulators carved from the ring (FOLD; the ring keeps the stages that
// fit beside it: 6 of 8 for int8 at 128 tokens, 5 of 6 at 160). A segment
// boundary is a countdown in the stage loop, not a loop of its own: the
// int consumers run at their register limit, and an outer segment loop
// (its bounds live across the stages) or a running sum in a global plane
// (its pointer live) each cost them 15-20% a stage on the card (PERF.md).

#pragma once

// (included inside dequant_matmul.cu's anonymous namespace, after <cuda.h>,
// Args, Place, split_last, store_bf16x4, int4_pair, int8_bf16x2, bf16_lo
// and bf16_hi)
namespace wg {

constexpr int BN = 128;                // weight columns per block
constexpr int BK = 64;                 // K per stage
constexpr int CONSUMERS = 2;           // warpgroups of 64 columns
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_BUDGET = 200 * 1024;
constexpr int SMEM_MAX = 227 * 1024;   // dynamic shared memory of a block
constexpr int MAX_STAGES = 8;
constexpr int PRODUCER_REGS = 40;      // setmaxnreg: 2 x 128 x 232 + 128 x 40
constexpr int CONSUMER_REGS = 232;     // fit the SM's 65,536 registers

// One stage: x (BC tokens x 64 K bf16, 128-byte rows, swizzled), the
// weight rows of 128 columns (int4: 32 K pairs of 128 bytes; int8: 64 rows
// of 128 bytes; bf16: two 64-column boxes of 64 rows of 128 bytes, all
// swizzled), then up to four scale rows of 128 bf16. Every offset is a
// multiple of 1024, the period of the 128-byte swizzle. FOLD: the ring is
// followed by the running sum of a folded launch's segments, BC / 2 f32 a
// consumer thread, and holds the stages that fit beside it.
template <int BITS, int BC = 128, bool FOLD = false>
struct Tile {
  static constexpr int X_BYTES = BC * BK * 2;
  static constexpr int W_BYTES = BITS == 4 ? BK / 2 * BN
                                           : BK * BN * (BITS == 16 ? 2 : 1);
  static constexpr int S_BYTES = BITS == 16 ? 0 : 4 * BN * 2;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES + S_BYTES;
  static constexpr int TOTAL_BYTES = FOLD ? CONSUMERS * 128 * BC / 2 * 4 : 0;
  static constexpr int STAGES_FIT =
      (FOLD ? SMEM_MAX - TOTAL_BYTES - 2048 : SMEM_BUDGET) / STAGE_BYTES;
  static constexpr int STAGES =
      STAGES_FIT > MAX_STAGES ? MAX_STAGES : STAGES_FIT;
  // the ring, the running sum, the full and empty barriers, the split-K
  // epilogue's two plane barriers and its arrival word, and slack to align
  // it to 1024
  static constexpr int SMEM = STAGES * STAGE_BYTES + TOTAL_BYTES
      + (2 * STAGES + 3) * 8 + 1024;
  // f32 bytes of one split plane of the tile (the epilogue's TMA box)
  static constexpr int PLANE_BYTES = BC * BN * 4;
  static_assert(STAGE_BYTES % 1024 == 0 && X_BYTES % 1024 == 0,
                "stages and their weight rows start on the swizzle period");
  static_assert(FOLD || 2 * PLANE_BYTES <= STAGES * STAGE_BYTES,
                "the idle ring holds two split planes");
  static_assert(STAGES >= 4 && SMEM <= SMEM_MAX, "the ring fits");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One box of a 3-D tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// The same box into the same offset of every block of the cluster in
// ``mask``, each completing on its own barrier at ``bar``'s offset.
__device__ __forceinline__ void tma_load_mc(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// An arrival on the barrier at ``bar``'s offset in block ``cta`` of the
// cluster.
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, int cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(smem_u32(bar)), "r"(cta) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: the barriers initialized
// before any block reaches into another's shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>(lbo) << 16
       | static_cast<uint64_t>(sbo) << 32
       | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Stage stamps, for tools/consumer_timeline.py only: with -DREPRO_STAMPS
// (which the wrappers' build never defines) the first thread of each
// warpgroup of the grid's first STAMP_BLOCKS blocks writes clock64() into
// g_stamps at the points of each pipeline stage ``it`` it passes; without
// it WG_STAMP is nothing.
enum StampPoint {
  ST_FULL,        // a stage's full wait returned (the next stage's)
  ST_ISSUED,      // the stage's (first group's) wgmmas issued
  ST_WAITED,      // the wgmma wait before the flush returned
  ST_FLUSHED,     // the flush done
  ST_CONVERTED,   // the next stage's codes converted
  ST_RELEASED,    // a stage released
  ST_DRAINED,     // wgmma_wait<0> returned (the 128-token body's stage end)
  ST_EMPTY,       // producer: the stage's empty wait returned
  ST_TURN,        // the stage's issue begins (its turn taken, if any)
  ST_POINTS
};
#ifdef REPRO_STAMPS
constexpr int STAMP_BLOCKS = 8;
constexpr int STAMP_ROLES = 3;    // consumer warpgroups 0 and 1, producer
constexpr int STAMP_STAGES = 256;
__device__ unsigned long long g_stamps[STAMP_BLOCKS * STAMP_ROLES
                                       * STAMP_STAGES * ST_POINTS];
__device__ __forceinline__ void stamp(int it, int point) {
  const unsigned blk =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x % 128 == 0 && blk < STAMP_BLOCKS && it < STAMP_STAGES)
    g_stamps[((blk * STAMP_ROLES + threadIdx.x / 128) * STAMP_STAGES + it)
             * ST_POINTS + point] = clock64();
}
#define WG_STAMP(it, point) stamp(it, point)
#else
#define WG_STAMP(it, point) ((void)0)
#endif

// Keep the compiler from moving an accumulator while a wgmma owns it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_D64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "           \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "           \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "           \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "           \
  "%62, %63}"
#define WG_D64_OPS(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),              \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),              \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),         \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),         \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),         \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),         \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),         \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),         \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A (64 x 16, registers) . B (16 x 128, shared memory); ``accumulate``
// 0 ignores d's old value (a group's first k16 step).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_D64_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// d += A (64 x 16, shared memory, MN-major) . B (16 x 128, shared memory).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a_desc,
                                         uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 1, 0;\n}\n"
      : WG_D64_OPS(d)
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

#undef WG_D64
#undef WG_D64_OPS

// Byte ``b`` of row ``r`` of a 128-byte-swizzled tile (16-byte chunks XOR
// the row's index mod 8).
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const char* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Int8 bytes j and j + 2 of ``r`` -> bf16x2 (code_j, code_j+2), exactly.
__device__ __forceinline__ uint32_t int8_pair2(uint32_t r, int j) {
  const uint32_t sel = j | (j << 4) | ((2 + j) << 8) | ((2 + j) << 12);
  return int8_bf16x2(__byte_perm(r, 0, sel));
}

// The A fragments of a stage's four k16 steps for this thread's columns
// ``col`` and ``col + 1`` (wgmma rows gid and gid + 8 of its warp): a[s][0]
// and a[s][2] are column col at K (2 tig, +1) and (2 tig + 8, +9) of step
// s, a[s][1] and a[s][3] column col + 1. ldmatrix.trans reads them: each
// 8 x 8 matrix of 16-bit elements is 8 weight rows of the warp's 16
// columns (two codes an element), and hands thread (gid, tig) element gid
// of its rows 2 tig and 2 tig + 1, i.e. both its columns at two rows.
template <int BITS>
__device__ __forceinline__ void load_a(uint32_t (&a)[BK / 16][4],
                                       const char* wsm, int warp_col,
                                       int lane) {
  const int m = lane >> 3, i = lane & 7;       // the row this lane names
  if constexpr (BITS == 4) {
    // matrix m = step m; its row i is K pair 8 m + i / 2 + 4 (i % 2), so
    // rows 2 tig, 2 tig + 1 are K pairs tig, tig + 4 (K 2 tig.. and +8..)
    uint32_t r[4];
    ldsm_x4_trans(r, wsm + swz(8 * m + (i >> 1) + 4 * (i & 1), warp_col));
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      const uint32_t u = r[s] >> 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) a[s][j] = int4_pair(r[s], u, j);
    }
  } else {
    // matrices 2 h + (0, 1) = K rows 16 s + (0..7, 8..15) of step s = 2 q +
    // h, for the q-th load
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t r[4];
      ldsm_x4_trans(r, wsm + swz(32 * q + 16 * (m >> 1) + 8 * (m & 1) + i,
                                 warp_col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[2 * q + h][0] = int8_pair2(r[2 * h], 0);
        a[2 * q + h][1] = int8_pair2(r[2 * h], 1);
        a[2 * q + h][2] = int8_pair2(r[2 * h + 1], 0);
        a[2 * q + h][3] = int8_pair2(r[2 * h + 1], 1);
      }
    }
  }
}

// The flush of one group's partial into the accumulator: acc[i] holds
// column col + ((i >> 1) & 1), whose scale is at ``srow`` of the stage.
template <int BITS, int R>
__device__ __forceinline__ void flush(float (&acc)[R], float (&part)[R],
                                      const char* wsm, int srow, int col) {
  using T = Tile<BITS>;
  const uint32_t sv = *reinterpret_cast<const uint32_t*>(
      wsm + T::W_BYTES + srow * BN * 2 + col * 2);
  const float s0 = bf16_lo(sv), s1 = bf16_hi(sv);
#pragma unroll
  for (int i = 0; i < R; ++i)
    acc[i] = fmaf(part[i], (i & 2) ? s1 : s0, acc[i]);
}

// This warp is done with the stage: its arrival on the stage's empty
// barrier, and on the partner block's (``peer``, its rank in the cluster;
// -1 alone), whose producer also loads into this block's stages.
__device__ __forceinline__ void release(uint64_t* empty, int lane, int peer) {
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(empty);
    if (peer >= 0) mbar_arrive_peer(empty, peer);
  }
}

// One group of a stage: its wgmmas into ``cur``, and meanwhile the
// previous group's partial ``prev`` flushed into acc (none before the
// first group of a K segment: ``start``, the block's first stage, or a
// folded launch's segment's, whose previous segment flushed its own).
template <int BITS, int SPF, int S, int NG>
__device__ __forceinline__ void int_group(
    float (&acc)[64], float (&cur)[64], float (&prev)[64],
    const uint32_t (&f)[BK / 16][4], char* smem, uint64_t* empty,
    const char* st, uint32_t xs, int grp, int it, bool start, int lane,
    int col, int peer) {
  using T = Tile<BITS>;
  if (grp == 0) WG_STAMP(it, ST_TURN);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < SPF; ++j) {
    const int step = grp * SPF + j;
    wgmma_rs(cur, f[step], desc_sw128(xs + step * 32, 1, 64), j != 0);
  }
  wgmma_commit();
  if (grp == 0) WG_STAMP(it, ST_ISSUED);
  wgmma_wait<1>();                 // the previous group's wgmmas are done
  if (grp == 0) WG_STAMP(it, ST_WAITED);
  if (grp > 0) {
    fence_regs(prev);
    flush<BITS>(acc, prev, st + T::X_BYTES, grp - 1, col);
  } else if (!start) {
    const int pv = it - 1;
    fence_regs(prev);
    flush<BITS>(acc, prev, smem + (pv % S) * T::STAGE_BYTES + T::X_BYTES,
                NG - 1, col);
    WG_STAMP(it, ST_FLUSHED);
    release(empty + pv % S, lane, peer);
    WG_STAMP(it, ST_RELEASED);
  }
}

// A folded launch's K segment done (no wgmma in flight): its partial acc
// joins the running sum ``tot`` in segment order, the first as it is
// (split_last's and reduce_tile's adds), and acc starts the next segment
// from zero; after the last segment acc = the running sum plus its
// partial (``last``), the value the spread epilogue rounds. ``tot`` holds
// R f32 a consumer thread, thread-major, so a warp's accesses take 32
// banks; each thread reads and writes its own words only.
template <int R>
__device__ __forceinline__ void fold_segment(float (&acc)[R], float* tot,
                                             bool first, bool last) {
  float* t = tot + threadIdx.x;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (last) {
      acc[i] = t[i * CONSUMERS * 128] + acc[i];
    } else {
      t[i * CONSUMERS * 128] = first ? acc[i]
                                     : t[i * CONSUMERS * 128] + acc[i];
      acc[i] = 0.0f;
    }
  }
}

// After stage ``it`` of a folded launch, with no wgmma in flight and the
// stage's partials flushed: at a segment's last stage (``left`` counts
// the segment's stages down; segments are a.seg / BK stages) the running
// sum takes the segment, but for the block's last stage, whose segment
// the caller adds after the loop.
template <int R>
__device__ __forceinline__ void fold_step(float (&acc)[R], float* tot,
                                          int& left, const Args& a, int it,
                                          int nst) {
  if (--left == 0 && it + 1 < nst) {
    fold_segment(acc, tot, it + 1 == a.seg / BK, false);
    left = a.seg / BK;
  }
}

// One stage of the int4/int8 consumer, PAR its parity: each group's
// wgmmas run into one of two partials in turn while the previous group's
// partial is flushed into acc (the previous stage's last one releases that
// stage); once the stage's wgmmas are done, the next stage's fragments are
// converted into ``f``. FOLD: at a K segment's last stage the stage's last
// partial is flushed and the stage released here, and the running sum
// takes the segment (fold_step); the next segment's first stage then
// flushes nothing before its first group.
template <int BITS, int SPF, int S, int PAR, bool FOLD>
__device__ __forceinline__ void int_stage(
    float (&acc)[64], float (&p0)[64], float (&p1)[64],
    uint32_t (&f)[BK / 16][4], char* smem, uint64_t* full, uint64_t* empty,
    float* tot, int& left, const Args& a, int it, int nst, int warp_col,
    int lane, int col, int peer) {
  using T = Tile<BITS>;
  constexpr int NG = BK / 16 / SPF;          // groups per stage
  const char* st = smem + (it % S) * T::STAGE_BYTES;
  const uint32_t xs = smem_u32(st);
  const bool start = FOLD ? left == a.seg / BK : it <= 0;
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    // this group's partial and the previous group's: p0 and p1 in turn
    if ((PAR * NG + grp) % 2)
      int_group<BITS, SPF, S, NG>(acc, p1, p0, f, smem, empty, st, xs, grp,
                                  it, start, lane, col, peer);
    else
      int_group<BITS, SPF, S, NG>(acc, p0, p1, f, smem, empty, st, xs, grp,
                                  it, start, lane, col, peer);
  }
  wgmma_wait<0>();                 // f is free again
  WG_STAMP(it, ST_DRAINED);
  if (it + 1 < nst) {
    const int nx = it + 1;
    mbar_wait(full + nx % S, (nx / S) & 1);
    WG_STAMP(it, ST_FULL);
    load_a<BITS>(f, smem + (nx % S) * T::STAGE_BYTES + T::X_BYTES, warp_col,
                 lane);
    WG_STAMP(it, ST_CONVERTED);
  }
  if constexpr (FOLD) {
    if (left == 1 && it + 1 < nst) {     // the segment's last group
      if ((PAR * NG + NG - 1) % 2) {
        fence_regs(p1);
        flush<BITS>(acc, p1, st + T::X_BYTES, NG - 1, col);
      } else {
        fence_regs(p0);
        flush<BITS>(acc, p0, st + T::X_BYTES, NG - 1, col);
      }
      release(empty + it % S, lane, peer);
    }
    fold_step(acc, tot, left, a, it, nst);
  }
}

// The producer thread: keeps the ring of stages full with TMA loads of x
// (a box of BC tokens), the weight rows and the scale rows. bf16 weights
// come in two 64-column boxes; with a partner block (``peer``, the other
// token tile of the column tile, bf16 only) each block loads box ``rank``
// into both blocks' stages, so the pair's weights cross from L2 once. Each
// stage's empty barrier then counts both blocks' consumer warps, and the
// producer stays until the last of them has arrived (the partner reaches
// into this block's barriers until then).
template <int BITS, int BC, bool FOLD>
__device__ __forceinline__ void produce(
    const CUtensorMap* tm_x, const CUtensorMap* tm_w, const CUtensorMap* tm_s,
    const Args& a, char* smem, uint64_t* full, uint64_t* empty, int g,
    int m0, int n0, int kbeg, int nst, int srows, int rank, int peer) {
  using T = Tile<BITS, BC, FOLD>;
  constexpr int S = T::STAGES;
  const uint32_t tx = T::X_BYTES + T::W_BYTES
      + (BITS == 16 ? 0 : srows * BN * 2);
  for (int it = 0; it < nst; ++it) {
    const int s = it % S;
    mbar_wait(empty + s, ((it / S) & 1) ^ 1);
    WG_STAMP(it, ST_EMPTY);
    char* st = smem + s * T::STAGE_BYTES;
    const int k0 = kbeg + it * BK;
    mbar_expect_tx(full + s, tx);
    tma_load(st, tm_x, k0, m0, g, full + s);
    char* wst = st + T::X_BYTES;
    if constexpr (BITS == 4) {
      tma_load(wst, tm_w, n0, k0 / 2, g, full + s);
    } else if constexpr (BITS == 8) {
      tma_load(wst, tm_w, n0, k0, g, full + s);
    } else if (peer >= 0) {
      tma_load_mc(wst + rank * T::W_BYTES / 2, tm_w, n0 + rank * BN / 2, k0,
                  g, full + s, 3);
    } else {
      tma_load(wst, tm_w, n0, k0, g, full + s);
      tma_load(wst + T::W_BYTES / 2, tm_w, n0 + BN / 2, k0, g, full + s);
    }
    if constexpr (BITS != 16)
      tma_load(wst + T::W_BYTES, tm_s, n0, k0 / a.gs, g, full + s);
  }
  if (peer >= 0)
    for (int it = nst > S ? nst - S : 0; it < nst; ++it)
      mbar_wait(empty + it % S, (it / S) & 1);
}

// A consumer thread's tokens into ``out`` (one split) or the f32 workspace:
// acc[4 j + 2 r + h] is token m0 + 8 j + 2 tig + h of wgmma row gid + 8 r
// of its warp: column col + r for codes (the fragments' permutation),
// column 16 warp + gid + 8 r of the warpgroup's 64 for bf16 weights (the
// stage's own order). With K split the kernel then counts the block in and
// the tile's last block reduces it (reduce_tile).
template <int BITS, int R>
__device__ __forceinline__ void store(const float (&acc)[R], const Args& a,
                                      int g, int m0, int n0, int split,
                                      int role) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int col = role * 64 + warp * 16 + 2 * gid;  // codes: columns col, +1
  const int base = n0 + role * 64 + warp * 16;
  const bool cols = base < a.N;         // N % 16 == 0: a warp's 16 or none
  const int c0 = BITS == 16 ? base + gid : n0 + col;
  const int c1 = BITS == 16 ? c0 + 8 : c0 + 1;
  const size_t plane = static_cast<size_t>(a.G) * a.M * a.N;
  if (a.splits == 1 && !cols) return;
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * tig + h;
      if (!cols || m >= a.M) continue;
      const size_t row = (static_cast<size_t>(g) * a.M + m) * a.N;
      const float v0 = acc[4 * j + h], v1 = acc[4 * j + 2 + h];
      if (a.splits == 1) {
        if constexpr (BITS == 16) {
          a.out[row + c0] = __bfloat16_as_ushort(__float2bfloat16_rn(v0));
          a.out[row + c1] = __bfloat16_as_ushort(__float2bfloat16_rn(v1));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(a.out + row + c0) =
              __floats2bfloat162_rn(v0, v1);
        }
      } else {
        float* w = a.ws + split * plane + row;
        if constexpr (BITS == 16) {
          w[c0] = v0;
          w[c1] = v1;
        } else {
          *reinterpret_cast<float2*>(w + c0) = make_float2(v0, v1);
        }
      }
    }
}

// A consumer warpgroup's whole K range at the 128-token tile, then its
// store. FOLD: the range in K segments of a.seg / BK stages, their
// running sum in ``tot`` (fold_segment).
template <int BITS, int SPF, bool FOLD>
__device__ __forceinline__ void consume(const Args& a, char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        float* tot, int nst, int g, int m0,
                                        int n0, int split, int role,
                                        int peer) {
  using T = Tile<BITS, 128, FOLD>;
  constexpr int S = T::STAGES;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int warp_col = role * 64 + warp * 16;        // the warp's 16 columns
  const int col = warp_col + 2 * (lane >> 2);        // codes: columns col, +1
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  if constexpr (BITS == 16) {
    int left = FOLD ? a.seg / BK : 0;        // stages left in the segment
    for (int it = 0; it < nst; ++it) {
      const int s = it % S;
      mbar_wait(full + s, (it / S) & 1);
      const char* st = smem + s * T::STAGE_BYTES;
      const uint32_t xs = smem_u32(st);
      const uint32_t ws = smem_u32(st + T::X_BYTES + role * (T::W_BYTES / 2));
      // both operands in the stage: four k16 steps in flight at once
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int step = 0; step < BK / 16; ++step)
        wgmma_ss(acc, desc_sw128(ws + step * 2048, 64, 64),
                 desc_sw128(xs + step * 32, 1, 64));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty + s, lane, peer);
      if constexpr (FOLD) fold_step(acc, tot, left, a, it, nst);
    }
    if constexpr (FOLD)
      if (nst > a.seg / BK) fold_segment(acc, tot, false, true);
  } else {
    // codes -> registers -> wgmma; two partials in turn (register arrays
    // are indexed at compile time only, so stages go in pairs)
    float p0[64], p1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) p0[i] = p1[i] = 0.0f;
    uint32_t f[BK / 16][4];
    mbar_wait(full, 0);
    load_a<BITS>(f, smem + T::X_BYTES, warp_col, lane);
    int left = FOLD ? a.seg / BK : 0;        // stages left in the segment
    for (int it = 0; it < nst; it += 2) {
      int_stage<BITS, SPF, S, 0, FOLD>(acc, p0, p1, f, smem, full, empty,
                                       tot, left, a, it, nst, warp_col, lane,
                                       col, peer);
      if (it + 1 < nst)
        int_stage<BITS, SPF, S, 1, FOLD>(acc, p0, p1, f, smem, full, empty,
                                         tot, left, a, it + 1, nst, warp_col,
                                         lane, col, peer);
    }
    // the last group's partial: stage nst - 1's last group
    constexpr int NG = BK / 16 / SPF;
    const int last = nst - 1;
    const char* ws_last = smem + (last % S) * T::STAGE_BYTES + T::X_BYTES;
    if (((last % 2) * NG + NG - 1) % 2) {
      fence_regs(p1);
      flush<BITS>(acc, p1, ws_last, NG - 1, col);
    } else {
      fence_regs(p0);
      flush<BITS>(acc, p0, ws_last, NG - 1, col);
    }
    release(empty + last % S, lane, peer);
    if constexpr (FOLD)
      if (nst > a.seg / BK) fold_segment(acc, tot, false, true);
  }

  store<BITS>(acc, a, g, m0, n0, split, role);
}

#include "wgmma_wide.cuh"

// The split-K epilogue of the tile's last block (the two consumer
// warpgroups; the producer may be gone): the tile's split planes (BC tokens
// by 128 columns of f32 each) added in order 0, 1, ... and rounded once
// into ``out``. Thread 0 brings the planes into the idle stage ring with
// TMA, two buffers in turn, and the 256 threads read them in a layout of
// their own: lane l takes columns 4 l .. 4 l + 3, warp w the tokens w, w +
// 8, .... A TMA box keeps a whole plane in flight: the threads' own
// coalesced loads of the same bytes, in the one block per tile that reads
// them, made the split rows several times slower on the card (PERF.md).
template <int BC>
__device__ __forceinline__ void reduce_tile(const CUtensorMap* tm_ws,
                                            const Args& a, char* smem,
                                            uint64_t* rbar, int g, int m0,
                                            int n0) {
  constexpr int ROWS = BC / 8;
  constexpr int PLANE = Tile<16, BC>::PLANE_BYTES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = g * a.M + m0;        // the tile's first row of a plane
  if (threadIdx.x == 0) {
    // the partials were written through the generic proxy, TMA reads
    // through the async proxy
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int p = 0; p < 2 && p < a.splits; ++p) {
      mbar_expect_tx(rbar + p, PLANE);
      tma_load(smem + p * PLANE, tm_ws, n0, row0, p, rbar + p);
    }
  }
  const int rows = min(ROWS, (a.M - m0 - warp + 7) / 8);
  float4 sum[ROWS];
  for (int p = 0; p < a.splits; ++p) {
    const int b = p & 1;
    mbar_wait(rbar + b, (p >> 1) & 1);
    const char* buf = smem + b * PLANE + (warp * BN + 4 * lane) * 4;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      const float4 v =
          *reinterpret_cast<const float4*>(buf + r * 8 * BN * 4);
      if (p == 0) {
        sum[r] = v;
      } else {
        sum[r].x += v.x; sum[r].y += v.y; sum[r].z += v.z; sum[r].w += v.w;
      }
    }
    split_sync<CONSUMERS * 128>();      // every thread is done with b
    if (threadIdx.x == 0 && p + 2 < a.splits) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(rbar + b, PLANE);
      tma_load(smem + b * PLANE, tm_ws, n0, row0, p + 2, rbar + b);
    }
  }
  const int n = n0 + 4 * lane;
  if (n >= a.N) return;                 // N % 16 == 0: all four or none
  uint16_t* out = a.out + (static_cast<size_t>(row0) + warp) * a.N + n;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows) break;
    store_bf16x4(out + static_cast<size_t>(r) * 8 * a.N, sum[r]);
  }
}

// The block's place in the grid (token tiles, column tiles, G x splits):
// the token tile varies fastest, then the column tile, the K split and the
// expert. So the ceil(C / BC) token tiles of one (expert, split, column
// tile) are consecutive blocks, dispatched in one wave: of the TMA loads
// of a stage's weight and scale boxes, the first brings them from HBM and
// the others find them in L2. (A grid with the token tiles behind every
// column tile ran a wave of column tiles through the bank, larger than the
// L2, before the next token tile read it again.)
template <int BC>
__device__ __forceinline__ Place block_place(const Args& a) {
  const int mtiles = (a.M + BC - 1) / BC;
  const int ntiles = gridDim.y;
  const int mt = blockIdx.x;
  const int nt = blockIdx.y;
  const int split = blockIdx.z % a.splits;
  const int g = blockIdx.z / a.splits;
  return Place{g, split, mt, nt, mtiles, ntiles};
}

// SPF: k16 steps per group flush, min(group, 64) / 16 (bf16: 4, unused).
// BC: the token tile, 128 (this file's consumers) or 160 (wgmma_wide.cuh's).
// tm_ws: the f32 workspace (splits, G * M, N) when K is split.
// PAIR: the launch is a grid of clusters of two token tiles (launch_pair).
// FOLD: a folded launch (a.seg > 0; one split over K, segments of a.seg).
template <int BITS, int SPF, int BC, bool PAIR, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
wg_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_s,
                 const __grid_constant__ CUtensorMap tm_ws, Args a) {
  using T = Tile<BITS, BC, FOLD>;
  constexpr int S = T::STAGES;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* tot = reinterpret_cast<float*>(smem + S * T::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * T::STAGE_BYTES
                                               + T::TOTAL_BYTES);
  uint64_t* empty = full + S;
  uint64_t* rbar = empty + S;              // the split-K epilogue's planes
  int* arrival = reinterpret_cast<int*>(rbar + 2);

  const Place place = block_place<BC>(a);
  const int g = place.g, split = place.split;
  const int m0 = place.mt * BC;
  const int n0 = place.nt * BN;
  const int kbeg = split * a.k_chunk;
  const int kend = min(a.K, kbeg + a.k_chunk);
  const int nst = (kend - kbeg + BK - 1) / BK;
  const int srows = a.gs >= BK ? 1 : BK / a.gs;   // scale rows per stage
  // a cluster holds token tiles mt and mt ^ 1 of one column tile; past an
  // odd last tile its partner is the grid's pad, which exits at once
  const int rank = PAIR ? static_cast<int>(cluster_rank()) : 0;
  const int peer = PAIR && (place.mt ^ 1) < place.mtiles ? rank ^ 1 : -1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      // one arrival per consumer warp of this block and of its partner
      mbar_init(empty + s, CONSUMERS * 4 * (peer >= 0 ? 2 : 1));
    }
    mbar_init(rbar, 1);
    mbar_init(rbar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (PAIR)
    cluster_sync();
  else
    __syncthreads();
  if (PAIR && place.mt >= place.mtiles) return;

  const int role = threadIdx.x / 128;
  if (role == CONSUMERS) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128)
      produce<BITS, BC, FOLD>(&tm_x, &tm_w, &tm_s, a, smem, full, empty, g,
                              m0, n0, kbeg, nst, srows, rank, peer);
    return;
  }

  // consumers: warpgroup ``role`` owns the block's columns 64 role ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  if constexpr (BC == 128)
    consume<BITS, SPF, FOLD>(a, smem, full, empty, tot, nst, g, m0, n0,
                             split, role, peer);
  else if (a.M - m0 <= WIDE_TAIL)     // a short last tile runs wgmma's n96
    consume_wide<BITS, SPF, BC, WIDE_TAIL / 2, FOLD>(
        a, smem, full, empty, tot, nst, g, m0, n0, split, role, peer);
  else
    consume_wide<BITS, SPF, BC, BC / 2, FOLD>(
        a, smem, full, empty, tot, nst, g, m0, n0, split, role, peer);
  // the place decoded again, not kept live through the K loop (kept, it
  // cost the int8 128-token rows 2-3% on the card)
  if constexpr (!FOLD)
    if (a.splits > 1 && split_last<CONSUMERS * 128>(
                            a, tile_index(block_place<BC>(a)), arrival))
      reduce_tile<BC>(&tm_ws, a, smem, rbar, g, m0, n0);
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over (G, rows, cols) of a contiguous tensor, box (1, box_rows,
// box_cols); elements outside the tensor read as zero.
inline bool make_map(CUtensorMap* map, const void* base,
                     CUtensorMapDataType type, int elem_bytes, int cols,
                     int rows, int experts, int box_cols, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(experts)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * elem_bytes,
      static_cast<cuuint64_t>(cols) * rows * elem_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BITS, int SPF, int BC, bool PAIR, bool FOLD>
int launch_spf(const Args& a, const CUtensorMap& tx, const CUtensorMap& tw,
               const CUtensorMap& ts, const CUtensorMap& tws,
               cudaStream_t s) {
  using T = Tile<BITS, BC, FOLD>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static unsigned long long smem_set = 0;   // bit d: set on device d
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(smem_set & bit)) {
    e = cudaFuncSetAttribute(wg_matmul_kernel<BITS, SPF, BC, PAIR, FOLD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set |= bit;
  }
  // block_place's order, token tiles fastest; a PAIR launch runs two
  // blocks a cluster (the grid padded to an even count of token tiles)
  const int mtiles = (a.M + BC - 1) / BC;
  const dim3 grid(mtiles + PAIR * (mtiles % 2), (a.N + BN - 1) / BN,
                  a.G * a.splits);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 2;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = PAIR;
  void* args[] = {const_cast<CUtensorMap*>(&tx), const_cast<CUtensorMap*>(&tw),
                  const_cast<CUtensorMap*>(&ts),
                  const_cast<CUtensorMap*>(&tws), const_cast<Args*>(&a)};
  e = cudaLaunchKernelExC(
      &cfg,
      reinterpret_cast<const void*>(
          wg_matmul_kernel<BITS, SPF, BC, PAIR, FOLD>),
      args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Past one token tile the bf16 bank pairs its token tiles in clusters (a
// pair's two blocks fold alike); the int banks and every single-tile
// launch run blocks alone, with no cluster code in their kernel.
template <int BITS, int SPF, int BC, bool FOLD>
int launch_pair(const Args& a, const CUtensorMap& tx, const CUtensorMap& tw,
                const CUtensorMap& ts, const CUtensorMap& tws,
                cudaStream_t s) {
  if constexpr (BITS == 16)
    if (a.M > BC)
      return launch_spf<BITS, SPF, BC, true, FOLD>(a, tx, tw, ts, tws, s);
  return launch_spf<BITS, SPF, BC, false, FOLD>(a, tx, tw, ts, tws, s);
}

template <int BITS, int SPF, int BC>
int launch_fold(const Args& a, const CUtensorMap& tx, const CUtensorMap& tw,
                const CUtensorMap& ts, const CUtensorMap& tws,
                cudaStream_t s) {
  return a.seg ? launch_pair<BITS, SPF, BC, true>(a, tx, tw, ts, tws, s)
               : launch_pair<BITS, SPF, BC, false>(a, tx, tw, ts, tws, s);
}

template <int BITS, int BC>
int launch(const Args& a, cudaStream_t s) {
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tx, tw, ts, tws;
  bool ok = make_map(&tx, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.K, a.M,
                     a.G, BK, BC, sw);
  if constexpr (BITS == 4)
    ok = ok && make_map(&tw, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.N,
                        a.K / 2, a.G, BN, BK / 2, sw);
  else if constexpr (BITS == 8)
    ok = ok && make_map(&tw, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.N, a.K,
                        a.G, BN, BK, sw);
  else
    ok = ok && make_map(&tw, a.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.N,
                        a.K, a.G, BN / 2, BK, sw);
  if constexpr (BITS != 16)
    ok = ok && make_map(&ts, a.scales, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        a.N, a.K / a.gs, a.G, BN, a.gs >= BK ? 1 : BK / a.gs,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    ts = tx;                            // unused by the bf16 body
  if (a.splits > 1)                     // the split planes, box: one tile
    ok = ok && make_map(&tws, a.ws, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.N,
                        a.G * a.M, a.splits, BN, BC,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    tws = tx;                           // unused without a split
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (BITS == 16) {
    return launch_fold<16, BK / 16, BC>(a, tx, tw, ts, tws, s);
  } else {
    switch (a.gs >= BK ? BK / 16 : a.gs / 16) {
      case 1: return launch_fold<BITS, 1, BC>(a, tx, tw, ts, tws, s);
      case 2: return launch_fold<BITS, 2, BC>(a, tx, tw, ts, tws, s);
      case 4: return launch_fold<BITS, 4, BC>(a, tx, tw, ts, tws, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace wg
