"""PyTorch/CUDA port of the MoE x Mixture-of-Precisions serving system.

Same module layout as the JAX reference package ``repro``; this package
imports ``torch`` and numpy only. Entry points run on the CUDA card unless
the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`). The
expert FFN's dequant-matmuls run on hand-written CUDA kernels for
``sm_90a`` (:mod:`repro_torch.kernels`).
"""
