"""Fused dequant-matmul ``x @ dequant(Wq)`` for int4/int8 group-wise
quantized weights, one expert at a time (B1/B2).

Replaces ``repro.kernels.q4_matmul`` (``_q4_kernel``/``_q8_kernel``, the
Pallas TPU kernels). On a CUDA tensor :func:`quantized_matmul` launches the
hand-written ``dequant_matmul<BITS>`` kernel (``csrc/dequant_matmul.cu``)
as a bank of one expert, which is the same code path as the grouped kernel
(:mod:`repro_torch.kernels.grouped_matmul`) and therefore bit-identical to
it per expert. On a CPU tensor it takes the plain PyTorch version beside
it, :func:`quantized_matmul_plain`, which does the same arithmetic: f32
dequant (``code * scale``, no bf16 rounding), f32 matmul, one cast.
"""
from __future__ import annotations

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


def launch_dequant(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor,
                   *, bits: int, group_size: int, n: int) -> torch.Tensor:
    """Launch ``dequant_matmul<bits>`` on (G, M, K) activations; the
    caller has validated shapes and counted the launch."""
    g, m, kdim = x.shape
    out = torch.empty((g, m, n), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = cuda_lib.dequant_lib().repro_dequant_matmul(
        bits, x.data_ptr(), wq.data_ptr(), scales.data_ptr(),
        out.data_ptr(), g, m, kdim, n, group_size, stream)
    cuda_lib.check(rc, f"dequant_matmul<{bits}>")
    return out


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
    cuda_lib.LAUNCHES[f"q{bits}_matmul"] += 1
    return launch_dequant(x[None], wq, scales, bits=bits,
                          group_size=group_size, n=n)[0]
