"""Public wrappers around the dequant-matmul kernels.

They handle padding to tile boundaries, the QTensor container and batching
over experts, with the reference's tile choices (``repro.kernels.ops``):
``_pad_to``, ``_with_padded_m``, ``_largest_divisor`` and ``_round_up`` are
kept so both packages see identical tile contracts on the CPU; on the
card the kernels take the true token count (``_m_tile``).

A CPU tensor takes each kernel's plain PyTorch version; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts launches per kernel
wrapper (``LAUNCHES["grouped_q4"]`` and so on), ``BODY_LAUNCHES`` the
matmul launches by (wrapper, body), ``SPLIT_LAUNCHES`` those of them whose
plan splits K and ``FOLDED_LAUNCHES`` those of these that ran a tile's
splits in one block (the others reduce the splits in their epilogue).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import grouped_matmul as _gk
from repro_torch.kernels import q4_matmul as _k
from repro_torch.kernels.cuda_lib import (  # noqa: F401
    BODY_LAUNCHES, FOLDED_LAUNCHES, GROUP_LAUNCHES, LAUNCHES, SPLIT_LAUNCHES,
    reset_launches,
)


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    cfg = [0, 0] * x.ndim          # F.pad lists dims last-first
    cfg[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, cfg)


def _m_tile(m: int, block_m: int, device_type: str):
    """(rows the call is given, the M tile it is told) for M rows: the
    reference's choice, M padded to a multiple of min(block_m, M rounded
    up to 8), everywhere but on the card, whose kernels mask any M through
    their tensor maps and bounds and so take the true M as one tile of M
    (C = 160 runs 160 rows, not 256)."""
    if device_type == "cuda":
        return m, m
    block_m_eff = min(block_m, _round_up(m, 8))
    return _round_up(m, block_m_eff), block_m_eff


def _with_padded_m(call, x: torch.Tensor, *, block_m: int, m_axis: int):
    """Centralized padded-M wrapper (decode batches are small and rarely
    tile-aligned). Picks the effective M tile (:func:`_m_tile`), zero-pads
    ``x`` along ``m_axis`` to it, runs ``call(x_padded, block_m_eff)`` and
    slices the result back to the true M. Shared by the per-expert and
    grouped paths so both see identical tile choices (a parity
    requirement)."""
    m = x.shape[m_axis]
    rows, block_m_eff = _m_tile(m, block_m, x.device.type)
    xp = _pad_to(x, rows, m_axis).contiguous()
    out = call(xp, block_m_eff)
    return out.narrow(m_axis, 0, m)


def q_matmul(x: torch.Tensor, qt: QTensor, *, block_m: int = 128,
             block_n: int = 256, block_k: int = 128,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ dequant(qt)`` — (M, K) x Q(K, N) -> (M, N) (B1/B2).

    M is padded to the tile size (decode batches are small); K and N must
    already satisfy tile divisibility."""
    k, n = qt.shape[-2:]
    # shrink tiles to divisors (e.g. d_ff slices that are multiples of
    # 128 but not of 256)
    block_n = _largest_divisor(n, block_n, qt.group_size)
    block_k = _largest_divisor(k, block_k, qt.group_size)
    return _with_padded_m(
        lambda xp, bm: _k.quantized_matmul(
            xp, qt.q, qt.scales, bits=qt.bits, group_size=qt.group_size,
            block_m=bm, block_n=block_n, block_k=block_k,
            out_dtype=out_dtype),
        x, block_m=block_m, m_axis=0)


def _largest_divisor(dim: int, cap: int, step: int) -> int:
    """Largest multiple of ``step`` that divides ``dim`` and is <= cap."""
    best = step if dim % step == 0 else dim
    b = step
    while b <= min(cap, dim):
        if dim % b == 0:
            best = b
        b += step
    return min(best, dim)


def q_expert_matmul(x: torch.Tensor, qt: QTensor, *, block_m: int = 128,
                    block_n: int = 256, block_k: int = 128,
                    out_dtype=torch.bfloat16,
                    grouped: bool = True) -> torch.Tensor:
    """Batched experts: (E, C, K) x Q(E, K, N) -> (E, C, N).

    ``grouped=True`` (default) runs the whole bank in ONE kernel launch
    with the expert group as a grid axis (B3). ``grouped=False`` keeps the
    per-expert spelling (one B1/B2 launch per expert); it is bit-identical
    to the grouped path and kept as its A/B baseline."""
    if grouped:
        return grouped_q_matmul(
            x, qt, block_m=block_m, block_n=block_n, block_k=block_k,
            out_dtype=out_dtype)
    return torch.stack([
        q_matmul(x[e], qt.map(lambda t: t[e]), block_m=block_m,
                 block_n=block_n, block_k=block_k, out_dtype=out_dtype)
        for e in range(x.shape[0])])


def grouped_q_matmul(x: torch.Tensor, qt: QTensor, *, block_m: int = 128,
                     block_n: int = 256, block_k: int = 128,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """One-launch grouped ``(E, C, K) x Q(E, K, N) -> (E, C, N)`` (B3).
    Tile selection mirrors :func:`q_matmul` exactly."""
    k, n = qt.shape[-2:]
    block_n = _largest_divisor(n, block_n, qt.group_size)
    block_k = _largest_divisor(k, block_k, qt.group_size)
    return _with_padded_m(
        lambda xp, bm: _gk.grouped_quantized_matmul(
            xp, qt.q, qt.scales, bits=qt.bits, group_size=qt.group_size,
            block_m=bm, block_n=block_n, block_k=block_k,
            out_dtype=out_dtype),
        x, block_m=block_m, m_axis=1)


def grouped_bf16_matmul(x: torch.Tensor, w: torch.Tensor, *,
                        block_m: int = 128, block_n: int = 256,
                        block_k: int = 128,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """One-launch grouped bf16 ``(E, C, K) x (E, K, N) -> (E, C, N)`` —
    the f16 bank's grouped path (B4; f32 accumulation)."""
    _, k, n = w.shape
    block_n = _largest_divisor(n, block_n, 8)
    block_k = _largest_divisor(k, block_k, 8)
    return _with_padded_m(
        lambda xp, bm: _gk.grouped_bf16_matmul(
            xp, w, block_m=bm, block_n=block_n, block_k=block_k,
            out_dtype=out_dtype),
        x, block_m=block_m, m_axis=1)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m
