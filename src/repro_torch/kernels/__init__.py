"""Hand-written CUDA kernels for the MoP compute hot spot (the expert FFN's
dequant-matmuls) with their launchers, plain PyTorch versions and the
public wrappers in :mod:`repro_torch.kernels.ops`."""
