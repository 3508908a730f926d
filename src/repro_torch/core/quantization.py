"""Group-wise weight quantization (the paper's precision substrate).

Symmetric group-wise int4/int8: along the reduction dim K, groups of
``group_size`` share one bf16 absmax scale. int4 values live in [-8, 7]
and are packed two nibbles per byte along K (even K index = low nibble,
stored +8). Codes and scales are byte-equal to the reference
``repro.core.quantization`` (``torch.round`` and ``jnp.round`` both round
half to even). Dequantization fuses into the CUDA dequant-matmul kernels
(:mod:`repro_torch.kernels`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized weight: packed codes + per-group scales.

    For ``bits=4``: ``q`` has shape ``(..., K//2, N)`` uint8 (two nibbles
    along K). For ``bits=8``: ``q`` has shape ``(..., K, N)`` int8.
    ``scales`` has shape ``(..., K//group_size, N)`` bf16.
    """
    q: torch.Tensor
    scales: torch.Tensor
    bits: int = 4
    group_size: int = 64

    @property
    def shape(self) -> Tuple[int, ...]:
        *b, kp, n = self.q.shape
        k = kp * 2 if self.bits == 4 else kp
        return (*b, k, n)

    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + \
            self.scales.numel() * self.scales.element_size()

    def map(self, fn) -> "QTensor":
        """Apply ``fn`` to both tensors (slicing, stacking, moving)."""
        return QTensor(q=fn(self.q), scales=fn(self.scales), bits=self.bits,
                       group_size=self.group_size)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int8 in [-8,7] -> (..., K//2, N) uint8."""
    if q.shape[-2] % 2:
        raise ValueError(f"K must be even, got {tuple(q.shape)}")
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    lo, hi = u[..., 0::2, :], u[..., 1::2, :]
    return (hi << 4) | lo


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) uint8 -> (..., K, N) int8 in [-8,7]."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    *b, kp, n = packed.shape
    # interleave along K: (..., K//2, 2, N) -> (..., K, N)
    return torch.stack([lo, hi], dim=-2).reshape(*b, 2 * kp, n)


def quantize(w: torch.Tensor, bits: int = 4, group_size: int = 64) -> QTensor:
    """Symmetric absmax group-wise quantization along dim -2 (reduction K)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    *b, k, n = w.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    wf = w.to(torch.float32).reshape(*b, k // group_size, group_size, n)
    qmax = 7.0 if bits == 4 else 127.0
    absmax = wf.abs().amax(dim=-2)                              # (..., K/G, N)
    # divide by a device tensor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which can move a scale by one
    # ulp off the CPU's (and the reference's) true quotient
    scales = absmax / torch.tensor(qmax, dtype=torch.float32,
                                   device=absmax.device)
    inv = torch.where(scales > 0, 1.0 / scales, torch.zeros_like(scales))
    q = torch.clamp(torch.round(wf * inv[..., None, :]), -qmax - 1, qmax)
    q = q.to(torch.int8).reshape(*b, k, n)
    if bits == 4:
        q = pack_int4(q)
    return QTensor(q=q, scales=scales.to(torch.bfloat16),
                   bits=bits, group_size=group_size)


def dequantize_f32(qt: QTensor) -> torch.Tensor:
    """QTensor -> f32 weight (..., K, N): ``code * scale`` in f32, with no
    bf16 rounding — the arithmetic the dequant-matmul kernels use."""
    q = unpack_int4(qt.q) if qt.bits == 4 else qt.q
    *b, k, n = q.shape
    g = qt.group_size
    wf = q.to(torch.float32).reshape(*b, k // g, g, n)
    wf = wf * qt.scales.to(torch.float32)[..., None, :]
    return wf.reshape(*b, k, n)


def dequantize(qt: QTensor) -> torch.Tensor:
    """QTensor -> bf16 weight (..., K, N) (the reference's oracle)."""
    return dequantize_f32(qt).to(torch.bfloat16)
