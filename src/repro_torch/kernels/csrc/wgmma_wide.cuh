// The wide-token consumers of the wgmma body: every launch whose plan has
// the 160-token tile (C > 128; a prompt of 257-512 tokens gives each of
// Mixtral's experts C = 160 at top-2 of 8 and capacity factor 1.25, 1024
// gives 320, 2048 gives 640). The block, its producer, its stages and its
// epilogue are wgmma_body.cuh's with a 160-token x box; only the consumer
// loops here differ.
//
// Why they differ. The 128-token consumer holds, per thread, 64 f32 of
// accumulator and two 64-f32 group partials, so m64n128 is as far as it
// goes: past 128 tokens that tile was only repeated, and a C = 160 launch
// ran two tiles of 128 rows, converted every code twice and loaded every
// weight byte twice. Here each consumer warpgroup runs wgmma.m64n160k16
// over all 160 tokens with one f32 group partial beside the accumulator
// (80 + 80 a thread): a warpgroup flushes its partial once its group's
// wgmmas are done, and converts the next stage's codes into a second set of
// fragments while they run. Each code is converted once and each weight
// byte loaded once per 160 tokens.
//
// The last token tile of a launch that holds at most WIDE_TAIL tokens (C =
// 321-416, and any C past 256 whose last tile is that short) runs the same
// loops with wgmma.m64n96k16. C = 161-256 takes two tiles either way and
// runs them on wgmma_body.cuh's 128-token tile, which the card ran faster
// than a 160-token tile and this n96 tail on every bank (PERF.md).
//
// What the card showed on the way (the numbers are in PERF.md): a block of
// 64 columns by up to 256 tokens, its two warpgroups splitting the tokens
// and sharing one A operand converted into shared memory, ran no faster
// than two 128-token tiles. Its TMA loads alone took half that time, each x
// row feeding only 64 columns, and multicasting x over a 2- or 4-block
// cluster changed nothing. 128 columns halve the x bytes each product
// needs. A consumer warpgroup's stage is one serial chain, ~1,360-1,380
// (int4) and ~1,440-1,480 (int8) cycles against the tensor core's 640 for
// the block's eight wgmmas (per-stage clock stamps, PERF.md): issue
// (~140-300), the next stage's full wait (~210-290) and conversion
// (~270-440 int4, ~570-580 int8), wgmma_wait<0> (one partial: the flush
// waits for its group), the flush (~140-220), the release. The int4
// consumers of a spread or one-split grid take turns to issue (turn_take
// below): warpgroup 1 issues ~250 cycles after warpgroup 0, whose flush
// then runs under warpgroup 1's wgmmas, and their stage falls to
// ~1,310-1,330 cycles: the chain is still the warpgroup's own work, but
// those rows ran 1-4% faster. Doing the conversion after wgmma_wait<0>,
// in one block with the flush, lengthened the flush to 335-725 cycles
// (0.85-1.0x); an x cluster shortened nothing.
//
// Arithmetic as in the other bodies: codes are exact bf16 integers; each
// group of min(group, 64) K runs its k16 steps into a fresh f32 partial
// (scale-d 0 on its first step), then acc = fmaf(part, scale[n], acc) in
// ascending K; bf16 weights accumulate straight into acc. wgmma computes
// each output element on its own, so a token's row depends neither on the
// row's place in the tile, nor on the token count, nor on n96 or n160.

#pragma once

// (included by wgmma_body.cuh inside namespace wg, before the kernel)

// a last token tile of at most this many tokens runs wgmma's n96
constexpr int WIDE_TAIL = 96;

#define WG_D0_47                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "           \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "      \
  "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "      \
  "%40, %41, %42, %43, %44, %45, %46, %47"
#define WG_D48_79                                                          \
  ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "    \
  "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "      \
  "%74, %75, %76, %77, %78, %79"
#define WG_OPS8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_OPS48(d)                                                        \
  WG_OPS8(d, 0), WG_OPS8(d, 8), WG_OPS8(d, 16), WG_OPS8(d, 24),            \
  WG_OPS8(d, 32), WG_OPS8(d, 40)
#define WG_OPS80(d)                                                        \
  WG_OPS48(d), WG_OPS8(d, 48), WG_OPS8(d, 56), WG_OPS8(d, 64),             \
  WG_OPS8(d, 72)

// d (+)= A (64 x 16, registers) . B (16 x 96 or 160, shared memory);
// ``accumulate`` 0 ignores d's old value (a group's first k16 step).
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4],
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" WG_D0_47
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : WG_OPS48(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[80], const uint32_t (&a)[4],
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {" WG_D0_47
      WG_D48_79 "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : WG_OPS80(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// d += A (64 x 16, shared memory, MN-major) . B (16 x 96 or 160, shared
// memory).
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t a_desc,
                                         uint64_t b_desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" WG_D0_47
      "}, %48, %49, 1, 1, 1, 1, 0;\n"
      : WG_OPS48(d)
      : "l"(a_desc), "l"(b_desc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[80], uint64_t a_desc,
                                         uint64_t b_desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {" WG_D0_47
      WG_D48_79 "}, %80, %81, 1, 1, 1, 1, 0;\n"
      : WG_OPS80(d)
      : "l"(a_desc), "l"(b_desc));
}

#undef WG_D0_47
#undef WG_D48_79
#undef WG_OPS8
#undef WG_OPS48
#undef WG_OPS80

// The int4 consumers' turns (PERF.md): consumer warpgroup r issues a
// stage's wgmmas only in its turn, taken on named barrier 2 + r over both
// consumer warpgroups (256 threads; barrier 1 is split_last's, 0
// __syncthreads). A warpgroup takes its turn at the top of a stage, where
// no wgmma of its own is in flight (bar.sync), issues and commits the
// stage's k16 steps, and passes the turn to the other (bar.arrive, which
// does not wait). Warpgroup 1 opens with one arrival on warpgroup 0's
// barrier and does not pass the turn after its last stage, where no stage
// of warpgroup 0 is left to take it: for any stage count every arrival
// meets one sync. The K loop is instantiated per warpgroup (ROLE 0 or 1),
// so the ids are immediates and no role is live across the loop; ROLE -1
// is the loop without turns, one copy for both warpgroups. The turns ran
// the int4 rows of a spread or one-split grid 1-4% faster; the int8 rows,
// the folded launches and the 128-token body ran 1-6% slower with them (a
// copy of the loop a warpgroup costs the instruction cache as much as the
// order gains) and issue at will. One copy of the loop choosing its
// barrier from a per-thread value ran 3-7% slower and spilled at the 16-
// and 32-K groups. -DREPRO_LOCKSTEP (for
// tools/consumer_timeline.py's baseline only; the wrappers' build never
// defines it) turns them off everywhere.
#ifdef REPRO_LOCKSTEP
constexpr bool TURNS = false;
#else
constexpr bool TURNS = true;
#endif

template <int BITS, bool FOLD>
constexpr bool TAKES_TURNS = TURNS && BITS == 4 && !FOLD;

template <int ROLE>
__device__ __forceinline__ void turn_open() {
  if (ROLE == 1) asm volatile("bar.arrive 2, 256;\n" ::: "memory");
}

template <int ROLE>
__device__ __forceinline__ void turn_take() {
  if (ROLE == 0) asm volatile("bar.sync 2, 256;\n" ::: "memory");
  if (ROLE == 1) asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

template <int ROLE>
__device__ __forceinline__ void turn_pass(int it, int nst) {
  if (ROLE == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
  if (ROLE == 1 && it + 1 < nst)
    asm volatile("bar.arrive 2, 256;\n" ::: "memory");
}

// One stage of the int4/int8 consumer with fragments ``f`` (converted
// before): each group's wgmmas run into the partial, which is flushed into
// acc once they are done; while the stage's first group runs, the next
// stage's codes are converted into ``fn``. The stage's first group takes
// the warpgroup's turn, its last passes it (ROLE, turn_take). BC is the
// block's token tile (the stage's x rows), R the accumulator registers
// (the wgmma's N / 2), FOLD whether the launch is folded (the ring's stage
// count). No wgmma is in flight when it returns.
template <int BITS, int SPF, int BC, bool FOLD, int ROLE, int R>
__device__ __forceinline__ void wide_stage(
    float (&acc)[R], float (&part)[R], const uint32_t (&f)[BK / 16][4],
    uint32_t (&fn)[BK / 16][4], char* smem, uint64_t* full, uint64_t* empty,
    int it, int nst, int warp_col, int lane, int col, int peer) {
  using T = Tile<BITS, BC, FOLD>;
  constexpr int S = T::STAGES;
  constexpr int NG = BK / 16 / SPF;          // groups per stage
  const char* st = smem + (it % S) * T::STAGE_BYTES;
  const uint32_t xs = smem_u32(st);
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    if (grp == 0) {
      turn_take<ROLE>();
      WG_STAMP(it, ST_TURN);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < SPF; ++j) {
      const int step = grp * SPF + j;
      wgmma_rs(part, f[step], desc_sw128(xs + step * 32, 1, 64), j != 0);
    }
    wgmma_commit();
    if (grp == NG - 1) turn_pass<ROLE>(it, nst);
    if (grp == 0) WG_STAMP(it, ST_ISSUED);
    if (grp == 0 && it + 1 < nst) {
      const int nx = it + 1;
      mbar_wait(full + nx % S, (nx / S) & 1);
      WG_STAMP(it, ST_FULL);
      load_a<BITS>(fn, smem + (nx % S) * T::STAGE_BYTES + T::X_BYTES,
                   warp_col, lane);
      WG_STAMP(it, ST_CONVERTED);
    }
    wgmma_wait<0>();
    if (grp == 0) WG_STAMP(it, ST_WAITED);
    fence_regs(part);
    flush<BITS>(acc, part, st + T::X_BYTES, grp, col);
    if (grp == 0) WG_STAMP(it, ST_FLUSHED);
  }
  release(empty + it % S, lane, peer);
  WG_STAMP(it, ST_RELEASED);
}

// Issue one bf16 stage's wgmmas into acc once the stage has landed.
template <int BC, bool FOLD, int R>
__device__ __forceinline__ void wide_bf16_stage(float (&acc)[R], char* smem,
                                                uint64_t* full, int it,
                                                int role) {
  using T = Tile<16, BC, FOLD>;
  const int s = it % T::STAGES;
  mbar_wait(full + s, (it / T::STAGES) & 1);
  const char* st = smem + s * T::STAGE_BYTES;
  const uint32_t xs = smem_u32(st);
  const uint32_t ws = smem_u32(st + T::X_BYTES + role * (T::W_BYTES / 2));
  wgmma_fence();
#pragma unroll
  for (int step = 0; step < BK / 16; ++step)
    wgmma_ss(acc, desc_sw128(ws + step * 2048, 64, 64),
             desc_sw128(xs + step * 32, 1, 64));
  wgmma_commit();
}

// The bf16 stages s0 .. s1 - 1 (the block's K segment; a spread launch
// has one, 0 .. nst - 1), both operands in the stage: a stage's wgmmas run
// while the next stage's are issued (stage s0 before the loop, so one
// group is in flight on every path into the loop's head); none is in
// flight when it returns.
template <int BC, bool FOLD, int R>
__device__ __forceinline__ void wide_bf16_segment(
    float (&acc)[R], char* smem, uint64_t* full, uint64_t* empty, int s0,
    int s1, int lane, int role, int peer) {
  constexpr int S = Tile<16, BC, FOLD>::STAGES;
  wide_bf16_stage<BC, FOLD>(acc, smem, full, s0, role);
  for (int it = s0 + 1; it < s1; ++it) {
    wide_bf16_stage<BC, FOLD>(acc, smem, full, it, role);
    wgmma_wait<1>();             // the previous stage's wgmmas are done
    release(empty + (it - 1) % S, lane, peer);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(empty + (s1 - 1) % S, lane, peer);
}

// Consumer warpgroup ``role``'s int4/int8 K range at wgmma N = 2 R into
// acc (its store is the caller's): codes -> registers -> wgmma, two
// fragment sets in turn (register arrays are indexed at compile time only,
// so stages go in pairs); ROLE 0 or 1 (= role) takes turns, -1 does not.
// FOLD: the range in K segments of a.seg / BK stages, their running sum in
// ``tot`` (fold_segment).
template <int BITS, int SPF, int BC, int R, bool FOLD, int ROLE>
__device__ __forceinline__ void consume_wide_int(
    float (&acc)[R], const Args& a, char* smem, uint64_t* full,
    uint64_t* empty, float* tot, int nst, int role, int peer) {
  using T = Tile<BITS, BC, FOLD>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  // the warp's 16 columns
  const int warp_col = (ROLE < 0 ? role : ROLE) * 64 + warp * 16;
  const int col = warp_col + 2 * (lane >> 2);        // codes: columns col, +1
  float part[R];
#pragma unroll
  for (int i = 0; i < R; ++i) part[i] = 0.0f;
  uint32_t f0[BK / 16][4], f1[BK / 16][4];
  mbar_wait(full, 0);
  load_a<BITS>(f0, smem + T::X_BYTES, warp_col, lane);
  turn_open<ROLE>();
  int left = FOLD ? a.seg / BK : 0;        // stages left in the segment
  for (int it = 0; it < nst; it += 2) {
    wide_stage<BITS, SPF, BC, FOLD, ROLE>(acc, part, f0, f1, smem, full,
                                          empty, it, nst, warp_col, lane,
                                          col, peer);
    if constexpr (FOLD) fold_step(acc, tot, left, a, it, nst);
    if (it + 1 < nst) {
      wide_stage<BITS, SPF, BC, FOLD, ROLE>(acc, part, f1, f0, smem, full,
                                            empty, it + 1, nst, warp_col,
                                            lane, col, peer);
      if constexpr (FOLD) fold_step(acc, tot, left, a, it + 1, nst);
    }
  }
  if constexpr (FOLD)
    if (nst > a.seg / BK) fold_segment(acc, tot, false, true);
}

// A consumer warpgroup's whole K range at wgmma N = 2 R, then its store.
// FOLD: the range in K segments of a.seg / BK stages, their running sum
// in ``tot`` (fold_segment).
template <int BITS, int SPF, int BC, int R, bool FOLD>
__device__ __forceinline__ void consume_wide(
    const Args& a, char* smem, uint64_t* full, uint64_t* empty, float* tot,
    int nst, int g, int m0, int n0, int split, int role, int peer) {
  const int lane = threadIdx.x & 31;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;

  if constexpr (BITS == 16) {
    if constexpr (FOLD) {
      const int sst = a.seg / BK;
      for (int s0 = 0; s0 < nst; s0 += sst) {
        const int s1 = min(nst, s0 + sst);
        wide_bf16_segment<BC, FOLD>(acc, smem, full, empty, s0, s1, lane,
                                    role, peer);
        if (s1 < nst) fold_segment(acc, tot, s0 == 0, false);
        else if (s0 > 0) fold_segment(acc, tot, false, true);
      }
    } else {
      wide_bf16_segment<BC, FOLD>(acc, smem, full, empty, 0, nst, lane, role,
                                  peer);
    }
  } else if constexpr (TAKES_TURNS<BITS, FOLD>) {
    if (role == 0)
      consume_wide_int<BITS, SPF, BC, R, FOLD, 0>(acc, a, smem, full, empty,
                                                  tot, nst, role, peer);
    else
      consume_wide_int<BITS, SPF, BC, R, FOLD, 1>(acc, a, smem, full, empty,
                                                  tot, nst, role, peer);
  } else {
    consume_wide_int<BITS, SPF, BC, R, FOLD, -1>(acc, a, smem, full, empty,
                                                 tot, nst, role, peer);
  }
  store<BITS>(acc, a, g, m0, n0, split, role);
}
