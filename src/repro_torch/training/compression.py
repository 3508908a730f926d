"""int8 gradient compression with error feedback (1-bit-Adam-style;
``repro.training.compression``).

    g_corrected = g + ef                     (apply residual)
    q, scale    = quantize_int8(g_corrected) (what crosses the wire)
    g_hat       = q * scale                  (all ranks decode identically)
    ef'         = g_corrected - g_hat        (residual stays local)

``g_hat`` feeds the optimizer. Codes, scales and residuals are byte-equal
to the reference's: the scale is a true quotient ``absmax / 127`` with a
device-tensor divisor (a Python-scalar divisor on a CUDA tensor becomes a
multiply by the reciprocal), and ``torch.round`` rounds half to even as
``jnp.round`` does. The residual is updated in place. On a sharded tree
the residual shards like its param, and a leaf is compressed once on the
whole tensor (``sharding.whole``): the absmax scale is the tensor's.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.dist import sharding as SH
from repro_torch.training.optimizer import f32, tree_leaves, tree_map


def init_error_feedback(params) -> Any:
    return tree_map(SH.zeros, params)


def quantize_grad(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (codes, scale)."""
    absmax = torch.amax(torch.abs(g))
    scale = torch.where(absmax > 0, absmax / f32(127.0, absmax),
                        torch.ones_like(absmax)).to(torch.float32)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads, ef):
    """(decoded grads, error feedback updated in place). Apply between
    accumulation and the optimizer update."""
    @SH.whole
    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, scale = quantize_grad(corrected)
        g_hat = q.to(torch.float32) * scale
        e.copy_(corrected - g_hat)
        return g_hat.to(g.dtype)

    return tree_map(one, grads, ef), ef


def wire_bytes(params, compressed: bool) -> int:
    """Gradient all-reduce payload per step (reporting helper)."""
    total = 0
    for _, leaf in tree_leaves(params):
        total += leaf.numel() * (1 if compressed else 4) + \
            (4 if compressed else 0)
    return total
