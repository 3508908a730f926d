"""Grouped multi-expert matmuls: ONE launch per ladder rung (B3, B4).

Replaces ``repro.kernels.grouped_matmul`` (``_grouped_q_kernel`` and
``_grouped_bf16_kernel``, the Pallas TPU kernels). A whole rung bank
``einsum('gck,gkn->gcn', x, W)`` runs in one launch with the expert group
on ``blockIdx.z`` (``csrc/dequant_matmul.cu``): ``dequant_matmul<BITS>``
for the q4/q8 banks (the same code as the per-expert B1/B2, so the grouped
result is bit-identical to the per-expert loop) and ``bf16_matmul`` for
the f16 bank (f32 accumulation). An expert with no routed tokens has an
all-zero slice of the dispatch buffer and contributes exact zeros.

On a CPU tensor each wrapper takes its plain PyTorch version, which does
the same arithmetic expert by expert.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.q4_matmul import (
    check_cuda_operands, check_cuda_shape, launch_bf16, launch_dequant,
    quantized_matmul_plain, validate_blocks,
)


def grouped_quantized_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                                   scales: torch.Tensor, *, bits: int = 4,
                                   group_size: int = 64,
                                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-expert loop of :func:`quantized_matmul_plain` (f32 dequant,
    f32 matmul, one cast) — bit-identical to the per-expert spelling."""
    return torch.stack([
        quantized_matmul_plain(x[e], wq[e], scales[e], bits=bits,
                               group_size=group_size, out_dtype=out_dtype)
        for e in range(x.shape[0])])


def grouped_quantized_matmul(
    x: torch.Tensor,         # (G, C, K) bf16 (f32 also on the CPU)
    wq: torch.Tensor,        # int4: (G, K//2, N) uint8 | int8: (G, K, N)
    scales: torch.Tensor,    # (G, K//group_size, N)
    *,
    bits: int = 4,
    group_size: int = 64,
    block_m: int = 128,
    block_n: int = 256,
    block_k: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``einsum('gck,gkn->gcn', x, dequant(wq, scales))`` in ONE launch.

    Shape requirements match :func:`~repro_torch.kernels.q4_matmul.
    quantized_matmul` per group; callers pad via
    :mod:`repro_torch.kernels.ops`."""
    g, c, kdim = x.shape
    if bits == 4:
        n = wq.shape[2]
        k_w = wq.shape[1] * 2
    elif bits == 8:
        _, k_w, n = wq.shape
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if wq.shape[0] != g or scales.shape[0] != g:
        raise ValueError(f"group mismatch: x {g} vs w {wq.shape[0]} "
                         f"vs scales {scales.shape[0]}")
    if k_w != kdim:
        raise ValueError(f"K mismatch: x {kdim} vs w {k_w}")
    if tuple(scales.shape[1:]) != (kdim // group_size, n):
        raise ValueError(
            f"scales {tuple(scales.shape[1:])} != {(kdim // group_size, n)}")
    validate_blocks(c, kdim, n, block_m, block_n, block_k, group_size)
    if x.device.type == "cpu":
        return grouped_quantized_matmul_plain(
            x, wq, scales, bits=bits, group_size=group_size,
            out_dtype=out_dtype)
    check_cuda_operands(x, wq, scales, bits=bits, n=n, out_dtype=out_dtype)
    check_cuda_shape(kdim, group_size)
    cuda_lib.LAUNCHES[f"grouped_q{bits}"] += 1
    cuda_lib.GROUP_LAUNCHES[(f"grouped_q{bits}", g)] += 1
    return launch_dequant(x, wq, scales, bits=bits, group_size=group_size,
                          n=n, name=f"grouped_q{bits}")


def grouped_bf16_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                              out_dtype=torch.bfloat16) -> torch.Tensor:
    """f32 products and sums, one cast — per expert."""
    return torch.stack([(x[e].to(torch.float32) @ w[e].to(torch.float32))
                        .to(out_dtype) for e in range(x.shape[0])])


def grouped_bf16_matmul(
    x: torch.Tensor,         # (G, C, K)
    w: torch.Tensor,         # (G, K, N)
    *,
    block_m: int = 128,
    block_n: int = 256,
    block_k: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``einsum('gck,gkn->gcn', x, w)`` in one launch — the f16 bank's
    grouped path (f32 accumulation)."""
    g, c, kdim = x.shape
    gw, k_w, n = w.shape
    if gw != g or k_w != kdim:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    validate_blocks(c, kdim, n, block_m, block_n, block_k, 1)
    if x.device.type == "cpu":
        return grouped_bf16_matmul_plain(x, w, out_dtype=out_dtype)
    check_cuda_operands(x, w, None, bits=16, n=n, out_dtype=out_dtype)
    check_cuda_shape(kdim, 16)
    cuda_lib.LAUNCHES["grouped_bf16"] += 1
    cuda_lib.GROUP_LAUNCHES[("grouped_bf16", g)] += 1
    return launch_bf16(x, w)
