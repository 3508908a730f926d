"""Plain-torch oracles of the reference (``repro.kernels.ref``):
dequantize to bf16, then an f32 matmul. Unlike the kernels' plain versions
these round the dequantized weight to bf16 first."""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, dequantize


def quantized_matmul_ref(x: torch.Tensor, wq: torch.Tensor,
                         scales: torch.Tensor, *, bits: int = 4,
                         group_size: int = 64,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize-then-matmul in f32 — oracle for the dequant-matmul."""
    qt = QTensor(q=wq, scales=scales, bits=bits, group_size=group_size)
    w = dequantize(qt).to(torch.float32)
    return (x.to(torch.float32) @ w).to(out_dtype)


def expert_matmul_ref(x: torch.Tensor, wq: torch.Tensor,
                      scales: torch.Tensor, *, bits: int = 4,
                      group_size: int = 64,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """(E, C, K) x (E, K, N) batched variant."""
    qt = QTensor(q=wq, scales=scales, bits=bits, group_size=group_size)
    w = dequantize(qt).to(torch.float32)              # (E, K, N)
    return torch.einsum("eck,ekn->ecn", x.to(torch.float32), w
                        ).to(out_dtype)
