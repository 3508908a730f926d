"""Group-wise weight quantization (the paper's precision substrate).

Symmetric group-wise int4/int8: along the reduction dim K, groups of
``group_size`` share one bf16 absmax scale. int4 values live in [-8, 7]
and are packed two nibbles per byte along K (even K index = low nibble,
stored +8). Codes and scales are byte-equal to the reference
``repro.core.quantization`` (``torch.round`` and ``jnp.round`` both round
half to even). Dequantization fuses into the CUDA dequant-matmul kernels
(:mod:`repro_torch.kernels`).

The NF4 codebook path (the paper's bitsandbytes format) is kept for
quality comparison only, as in the reference: it is gather-based and not
used in the compute path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# NF4 quantile codebook (bitsandbytes), for the quality-comparison path only.
NF4_CODE = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], dtype=np.float32)


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
    wf.mul_(qt.scales.to(torch.float32)[..., None, :])  # wf is a fresh copy
    return wf.reshape(*b, k, n)


def dequantize(qt: QTensor) -> torch.Tensor:
    """QTensor -> bf16 weight (..., K, N) (the reference's oracle)."""
    return dequantize_f32(qt).to(torch.bfloat16)


def quantize_nf4(w: torch.Tensor, group_size: int = 64
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NF4 codebook quantization (quality-comparison path, not compute path).

    Returns (codes uint8 (..., K, N), absmax f32 (..., K/G, N))."""
    *b, k, n = w.shape
    wf = w.to(torch.float32).reshape(*b, k // group_size, group_size, n)
    absmax = wf.abs().amax(dim=-2) + 1e-12
    norm = wf / absmax[..., None, :]
    code = torch.from_numpy(NF4_CODE).to(w.device)
    idx = torch.argmin(torch.abs(norm[..., None] - code), dim=-1)
    return idx.reshape(*b, k, n).to(torch.uint8), absmax


def dequantize_nf4(codes: torch.Tensor, absmax: torch.Tensor,
                   group_size: int = 64) -> torch.Tensor:
    *b, k, n = codes.shape
    code = torch.from_numpy(NF4_CODE).to(codes.device)
    wf = code[codes.to(torch.long)].reshape(*b, k // group_size, group_size,
                                             n)
    return (wf * absmax[..., None, :]).reshape(*b, k, n).to(torch.bfloat16)


def quantization_rmse(w: torch.Tensor, bits: int = 4, group_size: int = 64,
                      nf4: bool = False) -> float:
    """Relative RMSE of one quantize/dequantize round trip."""
    if nf4:
        deq = dequantize_nf4(*quantize_nf4(w, group_size), group_size)
    else:
        deq = dequantize(quantize(w, bits, group_size))
    wf = w.to(torch.float32)
    err = torch.sqrt(torch.mean((wf - deq.to(torch.float32)) ** 2))
    return float(err / (torch.sqrt(torch.mean(wf ** 2)) + 1e-12))


# ----- whole-model homogeneous quantization (paper's Table-1 baselines) -----

def _map_tree(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples (a QTensor
    is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def quantize_tree(params, bits: int, group_size: int = 64,
                  min_dims: int = 2, min_k: int = 128):
    """Quantize every eligible weight matrix in a param tree (homogeneous
    baseline: '4-bit everything' / '8-bit everything' rows of Table 1).

    Tensors with fewer than ``min_dims`` dims, a reduction dim smaller
    than ``min_k``, or K not divisible by the group are left untouched
    (norm scales, biases, small heads); so is any leaf that is not a
    tensor or a numpy array."""
    def _q(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        if x.ndim < min_dims or x.shape[-2] < min_k or \
                x.shape[-2] % group_size:
            return x
        return quantize(torch.as_tensor(x), bits, group_size)
    return _map_tree(_q, params)


def dequantize_tree(params):
    return _map_tree(
        lambda x: dequantize(x) if isinstance(x, QTensor) else x, params)


def tree_nbytes(params) -> int:
    """Model size in bytes, QTensor-aware (paper's Model Size column)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes()
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += leaf.size * leaf.dtype.itemsize
    return total
