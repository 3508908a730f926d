"""Fused dequant-matmul ``x @ dequant(Wq)`` for int4/int8 group-wise
quantized weights, one expert at a time (B1/B2).

Replaces ``repro.kernels.q4_matmul`` (``_q4_kernel``/``_q8_kernel``, the
Pallas TPU kernels). On a CUDA tensor :func:`quantized_matmul` launches the
hand-written ``dequant_matmul<BITS>`` kernel (``csrc/dequant_matmul.cu``)
as a bank of one expert, which is the same code path as the grouped kernel
(:mod:`repro_torch.kernels.grouped_matmul`) and therefore bit-identical to
it per expert. On a CPU tensor it takes the plain PyTorch version beside
it, :func:`quantized_matmul_plain`, which computes the same function: f32
dequant (``code * scale``, no bf16 rounding), f32 matmul, one cast.

:func:`launch_plan` is the one place that fixes a launch's body, tiles and
K splits, from the shape alone (no expert count G), so the grouped launch
and the per-expert loop run the same arithmetic. Up to 64 tokens (decode,
the speculative verify) a plan names the ``mma_sync`` body; above 64
(prefill) the ``wgmma`` body with its 128-token tile, and above 128 the
``wgmma_wide`` body with its 160-token tile, but for C = 161-256, which
run two 128-token tiles. With more than one
split a launch is spread or folded (:func:`fold_splits`, which also sees
the bank's G): spread, each split is a block, the partials go through an
f32 workspace, and the last block of each tile to finish adds them in
split order in the kernel's own epilogue (:func:`splitk_reduce_plain` is
that arithmetic in plain PyTorch); folded, one block a tile runs the
splits in turn and adds their partials in the same order, with no
workspace, so the two give the same bytes.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.core.quantization import QTensor, dequantize_f32
from repro_torch.kernels import cuda_lib


def validate_blocks(m: int, kdim: int, n: int, block_m: int, block_n: int,
                    block_k: int, group_size: int) -> None:
    """The reference kernels' tile contract: BM|M, BN|N, BK|K, group|BK."""
    block_m = min(block_m, m)
    block_n = min(block_n, n)
    block_k = min(block_k, kdim)
    if m % block_m or n % block_n or kdim % block_k:
        raise ValueError(f"blocks must divide dims: "
                         f"{(m, n, kdim)} vs {(block_m, block_n, block_k)}")
    if block_k % group_size:
        raise ValueError(f"group_size {group_size} must divide BK {block_k}")


def check_cuda_operands(x: torch.Tensor, wq: torch.Tensor,
                        scales, *, bits: int, n: int, out_dtype) -> None:
    """What the CUDA kernels take: bf16 activations and output, packed
    uint8 / int8 codes or bf16 weights, bf16 scales, contiguous 16-byte
    aligned tensors on one card, N a multiple of 16."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    tensors = [x, wq] + ([scales] if scales is not None else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"operands on different devices: {t.device} "
                             f"vs {x.device}")
        if not t.is_contiguous():
            raise ValueError("CUDA dequant-matmul needs contiguous operands")
        if t.data_ptr() % 16:
            raise ValueError("CUDA dequant-matmul needs 16-byte aligned "
                             "operands")
    if x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise TypeError("CUDA dequant-matmul takes and returns bfloat16, got "
                        f"x {x.dtype} -> {out_dtype}")
    want = {4: torch.uint8, 8: torch.int8, 16: torch.bfloat16}[bits]
    if wq.dtype != want:
        raise TypeError(f"{bits}-bit weights must be {want}, got {wq.dtype}")
    if scales is not None and scales.dtype != torch.bfloat16:
        raise TypeError(f"scales must be bfloat16, got {scales.dtype}")
    if n % 16:
        raise ValueError(f"CUDA dequant-matmul needs N % 16 == 0, got {n}")


#: columns of W per block (mma.sync: 4 warps x 32; wgmma: 2 x m64), the
#: kernels' one tile width
BLOCK_N = 128
#: token tiles the kernels are built for: one n8 mma.sync fragment per 8
#: up to 64, the wgmma body's n128 tile and the wide body's n160 tile
BLOCK_C = (8, 16, 32, 64, 128, 160)
#: the wgmma body's token tile: it serves every launch with 64 < C <= 128,
#: and in two tiles every launch with 160 < C <= 256
WGMMA_BLOCK_C = 128
#: the wide wgmma body's token tile: it serves every other launch with C >
#: 128, in ceil(C / 160) tiles
WIDE_BLOCK_C = 160
#: K split boundaries are multiples of this (the kernels' pipeline stage)
SPLIT_GRAIN = 64
#: blocks an mma.sync launch should reach at G = 1: two per SM of an H100
#: (132 SMs)
MIN_BLOCKS = 2 * 132
#: blocks of one wave of the wgmma body at G = 1: one per SM
WAVE = 132
#: at most this many K splits (the kernels check it too)
MAX_SPLITS = 16


class LaunchPlan(NamedTuple):
    block_n: int       # weight columns per block
    block_c: int       # tokens per block
    k_chunk: int       # K per split, a multiple of SPLIT_GRAIN
    splits: int        # ceil(K / k_chunk)
    body: str          # "mma_sync" (block_c <= 64), "wgmma" (128) or
                       # "wgmma_wide" (160)


def launch_plan(c: int, k: int, n: int, bits: int) -> LaunchPlan:
    """Body, tiles and K splits of one dequant-matmul launch on (C, K) x
    (K, N).

    C <= 64 (decode, the speculative verify): the ``mma_sync`` body with
    the smallest token tile that holds C; then as many K splits (on
    64-aligned boundaries) as it takes for ceil(N / 128) x ceil(C /
    block_c) x splits to reach MIN_BLOCKS, so that even a narrow N (the
    down-projection's 4096 columns are 32 tiles) fills the card.

    64 < C <= 128 (prefill): the ``wgmma`` body with its 128-token tile,
    one block per SM. K splits only while the tiles at G = 1 are fewer than
    half a wave of WAVE blocks, only as far as one wave holds, and only as
    far as the f32 partials (written and read back: 8 bytes a token and
    column per split) stay within half the weight bytes (K * bits / 8 a
    column). The up- and gate-projections (112 column tiles) run unsplit:
    on the card their splits lost to no split at every bank size timed;
    the down-projection's 32 tiles fill a quarter of the card at G = 1
    unsplit, and Kimi-K2's int4 bank (16 tiles, G = 384) would move more
    partial bytes than code bytes split.

    C > 128 (the prompts of a 512-token bucket and longer): the
    ``wgmma_wide`` body with its 160-token tile, in ceil(C / 160) tiles
    (C = 160, 320, 640: the 512-, 1024- and 2048-token buckets at top-2 of
    8 and capacity factor 1.25 fill whole tiles). K splits by the same two
    caps, counted over the column tiles alone and the byte cap at 160
    tokens, so that every C > 128 shares one set of splits. C = 161-256
    (Kimi-K2's 8192-token bucket, C = 216, among them) takes two tiles
    either way and runs them on the ``wgmma`` body's 128-token tile with
    those splits: on the card two 128-token tiles beat a 160-token tile
    and the wide body's n96 tail on every bank (PERF.md). A last tile of at
    most 96 tokens past 256 (C = 321-416 among others) runs the wide
    body's n96 consumers inside the same launch.

    It takes no expert count: a bank of G experts runs each expert exactly
    as a launch of one would (:func:`fold_splits`, which sees G, chooses
    only which blocks run the splits). ``bits`` (4, 8 or 16) is checked; only the
    wgmma bodies' byte cap on their splits depends on it.

    Row invariance: a token's output row is bit-equal across launches
    whose plans share a body and K splits, whatever its place in the tile
    and however many other rows the launch has. For every (K, N), every C
    in 1..64 gets the ``mma_sync`` body with one set of splits (its token
    tile of 8 to 64 does not change a row's arithmetic: the verify scores
    a token as decode does), every C in 65..128 the ``wgmma`` body with
    another (one 128-token tile: a C = 80 row equals its C = 128 row), and
    every C > 128 a third, on either wgmma body: the two compute a row
    alike where their splits agree, so a C = 160 row equals its C = 256
    and its C = 320 row."""
    if bits not in (4, 8, 16):
        raise ValueError(f"bits must be 4, 8 or 16, got {bits}")
    grains = max(1, math.ceil(k / SPLIT_GRAIN))
    block_c = next((b for b in BLOCK_C if c <= b), WIDE_BLOCK_C)
    tiles = math.ceil(n / BLOCK_N)
    if block_c < WGMMA_BLOCK_C:
        body = "mma_sync"
        want = math.ceil(MIN_BLOCKS / (tiles * math.ceil(c / block_c)))
    else:
        # one token tile at C <= 128; past it the wide body's splits, which
        # count its column tiles alone and let its partials reach the
        # weight bytes
        wide = block_c == WIDE_BLOCK_C
        want = 1 if 2 * tiles >= WAVE else WAVE // tiles
        cap = 8 if wide else 16
        want = min(want, k * bits // (cap * 8 * block_c))
        if WIDE_BLOCK_C < c <= 2 * WGMMA_BLOCK_C:
            block_c = WGMMA_BLOCK_C        # two 128-token tiles
        body = "wgmma" if block_c == WGMMA_BLOCK_C else "wgmma_wide"
    want = max(1, min(grains, MAX_SPLITS, want))
    k_chunk = math.ceil(grains / want) * SPLIT_GRAIN
    return LaunchPlan(BLOCK_N, block_c, k_chunk, math.ceil(k / k_chunk),
                      body)


def check_cuda_shape(kdim: int, group_size: int) -> None:
    """K and the quantization group that the CUDA kernels take: K a
    multiple of 16, the group a multiple of 16 that divides 64 or that 64
    divides (a group's partial never straddles a pipeline stage unevenly)."""
    if kdim % 16:
        raise ValueError(f"CUDA dequant-matmul needs K % 16 == 0, got {kdim}")
    if group_size % 16 or (SPLIT_GRAIN % group_size
                           and group_size % SPLIT_GRAIN):
        raise ValueError(f"CUDA dequant-matmul needs a group of 16, 32 or a "
                         f"multiple of 64, got {group_size}")


def split_tiles(plan: LaunchPlan, g: int, m: int, n: int) -> int:
    """The tiles of a launch, (expert, token tile, column tile): one
    split-K counter each."""
    return g * math.ceil(m / plan.block_c) * math.ceil(n / plan.block_n)


#: the mma.sync token tiles that may fold (dequant_matmul.cu's
#: MAX_FOLD_NT): at 32 and 64 tokens the running sum would spill
MAX_FOLD_BLOCK_C = 16
#: a spread launch's own cost beside a folded one, as a share of its
#: waves: the f32 partials written and read back, the arrival, the
#: read-back. Calibrated on the card (PERF.md): every value in
#: [0.03, 0.33) picks the same grid at every timed row; the bound below
#: is Kimi-K2's decode bank (16 folded waves against 15.56 spread), the
#: bound above the int banks at 1.5 spread waves against 2 folded.
SPLIT_COST = 0.1
#: weight streams (wgmma blocks; a bf16 cluster pair shares one) from
#: which a folded bf16 launch keeps HBM busy: one folded bf16 block
#: streams ~50 GB/s on the card, and the sweep's folded bf16 grids won
#: from 64 streams and lost at 32 (PERF.md)
BF16_FOLD_STREAMS = 64


def wave(plan: LaunchPlan) -> int:
    """Blocks of one wave of a foldable ``plan``'s body on the card: WAVE
    for the wgmma bodies (one block an SM), three times it for the mma.sync
    tiles that fold (dequant_matmul.cu's Tile::MIN_BLOCKS at 8 and 16
    tokens)."""
    return WAVE if plan.body != "mma_sync" else 3 * WAVE


def can_fold(plan: LaunchPlan) -> bool:
    """Whether the kernels have a folded grid for ``plan``: it splits K,
    on a wgmma body or an mma.sync tile of at most MAX_FOLD_BLOCK_C."""
    return plan.splits > 1 and (plan.body != "mma_sync"
                                or plan.block_c <= MAX_FOLD_BLOCK_C)


def fold_splits(plan: LaunchPlan, g: int, m: int, n: int, bits: int) -> bool:
    """Whether a launch of ``plan`` over a bank of ``g`` experts of
    ``bits`` runs each tile's K splits in one block (folded) rather than a
    block a split (spread).

    The int banks on the wgmma bodies, bound by their operations: a wave
    model. With T = :func:`split_tiles` blocks folded and T x s spread and
    w(b) = ceil(b / :func:`wave`) waves, spread costs about w(T s) / s
    whole-K tile times and folded w(T); the launch folds where w(T) <=
    (1 + SPLIT_COST) w(T s) / s, a tie included, since spreading writes,
    counts and reads back its partials.

    The bodies bound by bytes: a bf16 bank on the wgmma bodies folds from
    BF16_FOLD_STREAMS weight streams (fewer folded blocks than that leave
    HBM idle; more stream it at its rate whatever their waves), and every
    mma.sync launch takes the wave model only once its folded grid fills
    a wave (below one, its splits keep a wave of loads in flight that the
    folded blocks cannot). Unsplit plans never fold, nor do the mma.sync
    body's 32- and 64-token tiles.

    It depends on G; no bit does. The plan's splits fix each row's
    arithmetic, and a folded block adds its segments' partials in split
    order as the spread epilogue does, so a bank of G experts gives, per
    expert, the bytes of G launches of one, whichever grid each takes."""
    if not can_fold(plan):
        return False
    tiles = split_tiles(plan, g, m, n)
    if bits == 16 and plan.body != "mma_sync":
        mtiles = math.ceil(m / plan.block_c)
        # past one token tile the bf16 bank pairs its token tiles in
        # clusters that share each weight stage (wgmma_body.cuh)
        streams = tiles if mtiles == 1 else \
            tiles // mtiles * math.ceil(mtiles / 2)
        return streams >= BF16_FOLD_STREAMS
    per_wave = wave(plan)
    if plan.body == "mma_sync" and tiles < per_wave:
        return False
    spread = math.ceil(tiles * plan.splits / per_wave) / plan.splits
    return math.ceil(tiles / per_wave) <= (1 + SPLIT_COST) * spread


#: tile counters allocated at least this many at a time (Kimi-K2's decode
#: bank, 384 experts x 56 column tiles, is 21,504)
MIN_COUNTERS = 1 << 15
#: per device index, the split-K epilogue's int32 tile counters. Every
#: launch leaves them zero (the last block of a tile resets its counter),
#: so one array serves every launch on its device, eager or replayed from a
#: CUDA graph. Hazard: two split launches running at once on one device,
#: on different streams, would share counters; the port launches its
#: matmuls on the current stream only (the expert cache's streams only
#: copy).
_COUNTERS: Dict[int, torch.Tensor] = {}
#: arrays outgrown by a larger launch: a captured graph may still hold
#: their addresses, so they are kept
_OUTGROWN: List[torch.Tensor] = []


def _counters(device: torch.device, tiles: int) -> torch.Tensor:
    """At least ``tiles`` zeroed counters on ``device``, allocated outside
    any CUDA-graph capture."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    have = _COUNTERS.get(index)
    if have is None or have.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"split-K counters: a launch of {tiles} tiles outgrows the "
                f"device's {0 if have is None else have.numel()} during a "
                "CUDA-graph capture; run it once before capturing")
        if have is not None:
            _OUTGROWN.append(have)
        have = torch.zeros(max(tiles, MIN_COUNTERS), dtype=torch.int32,
                           device=device)
        torch.cuda.synchronize(device)      # zeroed before any stream uses it
        _COUNTERS[index] = have
    return have


def _split_args(plan: LaunchPlan, out: torch.Tensor,
                ws: Optional[torch.Tensor], fold: bool = False):
    """The workspace and counter pointers of a launch: None for one
    split and for a folded launch; spread over more, the caller's f32
    workspace (splits, G, M, N) or a new one, and the device's counters."""
    if plan.splits == 1 or fold:
        if ws is not None:
            raise ValueError("a workspace was given to a launch whose plan "
                             + ("is folded" if plan.splits > 1
                                else "does not split K"))
        return None, None
    shape = (plan.splits, *out.shape)
    if ws is None:
        ws = torch.empty(shape, dtype=torch.float32, device=out.device)
    elif (tuple(ws.shape) != shape or ws.dtype != torch.float32
          or ws.device != out.device or not ws.is_contiguous()):
        raise ValueError(f"workspace must be a contiguous float32 {shape} "
                         f"tensor on {out.device}, got {ws.dtype} "
                         f"{tuple(ws.shape)} on {ws.device}")
    g, m, n = out.shape
    counters = _counters(out.device, split_tiles(plan, g, m, n))
    return ws.data_ptr(), counters.data_ptr()


def _plan_args(plan: LaunchPlan, fold: bool):
    """The C entry points' plan arguments (the body rides on block_c)."""
    return plan.block_n, plan.block_c, plan.k_chunk, plan.splits, int(fold)


def _grid(plan: LaunchPlan, g: int, m: int, n: int, bits: int,
          fold: Optional[bool]) -> bool:
    """Whether the launch runs folded: :func:`fold_splits`, or ``fold``
    where a tool forces a grid (only where :func:`can_fold`)."""
    if fold is None:
        return fold_splits(plan, g, m, n, bits)
    return fold and can_fold(plan)


def _book(name: str, plan: LaunchPlan, fold: bool) -> None:
    cuda_lib.BODY_LAUNCHES[(name, plan.body)] += 1
    if plan.splits > 1:
        cuda_lib.SPLIT_LAUNCHES[(name, plan.body)] += 1
    if fold:
        cuda_lib.FOLDED_LAUNCHES[(name, plan.body)] += 1


def launch_dequant(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor,
                   *, bits: int, group_size: int, n: int, name: str,
                   ws: Optional[torch.Tensor] = None,
                   _fold: Optional[bool] = None) -> torch.Tensor:
    """Launch ``dequant_matmul<bits>`` on (G, M, K) activations with the
    plan of :func:`launch_plan` and the grid of :func:`fold_splits` (its
    body counted under wrapper ``name``, in ``SPLIT_LAUNCHES`` when it
    splits K and in ``FOLDED_LAUNCHES`` when it runs folded; spread, its
    epilogue reduces the splits). ``ws`` is an optional caller-given f32
    workspace (splits, G, M, N) for a spread launch's split partials, left
    holding them; the caller has validated shapes and counted the matmul.
    ``_fold`` forces a grid, for the same-card A/B and the card's checks
    of the two grids only."""
    g, m, kdim = x.shape
    plan = launch_plan(m, kdim, n, bits)
    fold = _grid(plan, g, m, n, bits, _fold)
    out = torch.empty((g, m, n), dtype=torch.bfloat16, device=x.device)
    ws_ptr, counters = _split_args(plan, out, ws, fold)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _book(name, plan, fold)
    rc = cuda_lib.dequant_lib().repro_dequant_matmul(
        bits, x.data_ptr(), wq.data_ptr(), scales.data_ptr(),
        out.data_ptr(), ws_ptr, counters, g, m, kdim, n, group_size,
        *_plan_args(plan, fold), stream)
    cuda_lib.check(rc, f"dequant_matmul<{bits}>")
    return out


def launch_bf16(x: torch.Tensor, w: torch.Tensor,
                ws: Optional[torch.Tensor] = None,
                _fold: Optional[bool] = None) -> torch.Tensor:
    """Launch ``bf16_matmul`` on (G, M, K) x (G, K, N) with the plan of
    :func:`launch_plan` and the grid of :func:`fold_splits`, booked as
    :func:`launch_dequant` books its launches, ``ws`` and ``_fold`` as
    there; the caller has validated shapes and counted the matmul."""
    g, m, kdim = x.shape
    n = w.shape[2]
    plan = launch_plan(m, kdim, n, 16)
    fold = _grid(plan, g, m, n, 16, _fold)
    out = torch.empty((g, m, n), dtype=torch.bfloat16, device=x.device)
    ws_ptr, counters = _split_args(plan, out, ws, fold)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _book("grouped_bf16", plan, fold)
    rc = cuda_lib.dequant_lib().repro_bf16_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), ws_ptr, counters, g, m,
        kdim, n, *_plan_args(plan, fold), stream)
    cuda_lib.check(rc, "bf16_matmul")
    return out


def splitk_reduce_plain(ws: torch.Tensor) -> torch.Tensor:
    """The split-K epilogue's arithmetic in plain PyTorch: f32 adds in
    split order 0, 1, ..., one cast to bf16."""
    acc = ws[0].clone()
    for s in range(1, ws.shape[0]):
        acc += ws[s]
    return acc.to(torch.bfloat16)


def quantized_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                           scales: torch.Tensor, *, bits: int = 4,
                           group_size: int = 64,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 dequant, f32 matmul,
    one cast to ``out_dtype``."""
    w = dequantize_f32(QTensor(q=wq, scales=scales, bits=bits,
                               group_size=group_size))
    return (x.to(torch.float32) @ w).to(out_dtype)


def quantized_matmul(
    x: torch.Tensor,         # (M, K) bf16 (f32 also on the CPU)
    wq: torch.Tensor,        # int4: (K//2, N) uint8 | int8: (K, N) int8
    scales: torch.Tensor,    # (K//G, N) bf16
    *,
    bits: int = 4,
    group_size: int = 64,
    block_m: int = 128,
    block_n: int = 256,
    block_k: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``x @ dequant(wq, scales)``. Shape requirements are the reference
    kernel's (BM|M, BN|N, BK|K, group_size|BK); callers pad via
    :mod:`repro_torch.kernels.ops`. The CUDA kernel picks its own tiles;
    the block arguments only carry the reference's contract."""
    m, kdim = x.shape
    if bits == 4:
        n = wq.shape[1]
        k_w = wq.shape[0] * 2
    elif bits == 8:
        k_w, n = wq.shape
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if k_w != kdim:
        raise ValueError(f"K mismatch: x {kdim} vs w {k_w}")
    if tuple(scales.shape) != (kdim // group_size, n):
        raise ValueError(f"scales {tuple(scales.shape)} != "
                         f"{(kdim // group_size, n)}")
    validate_blocks(m, kdim, n, block_m, block_n, block_k, group_size)
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, wq, scales, bits=bits,
                                      group_size=group_size,
                                      out_dtype=out_dtype)
    check_cuda_operands(x, wq, scales, bits=bits, n=n, out_dtype=out_dtype)
    check_cuda_shape(kdim, group_size)
    cuda_lib.LAUNCHES[f"q{bits}_matmul"] += 1
    return launch_dequant(x[None], wq, scales, bits=bits,
                          group_size=group_size, n=n,
                          name=f"q{bits}_matmul")[0]
