"""Architecture registry of the port: ``get_config("<arch-id>")``.

Mixtral-8x7B (plain and with the paper's MoP serving defaults), Kimi-K2
(384 experts, top-8), the dense Qwen3-8B (qk-norm), Granite-3-2B,
Minitron-4B and SmolLM-360M, the RWKV6-3B SSM, the Zamba2-7B hybrid, the
SeamlessM4T-medium encoder-decoder and the PaliGemma-3B VLM: every
architecture of the reference's registry."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    AttentionConfig, ModelConfig, MoEConfig, MoPConfig, SHAPES, ShapeConfig,
    SSMConfig, reduce_for_smoke, shape_applicable,
)

_MODULES = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen3-8b": "qwen3_8b",
    "minitron-4b": "minitron_4b",
    "granite-3-2b": "granite_3_2b",
    "smollm-360m": "smollm_360m",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-3b": "rwkv6_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mixtral-mop": "mixtral_mop",
    "paligemma-3b": "paligemma_3b",
}
ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_cells():
    """Every runnable (arch, shape) dry-run cell, in the reference's order
    (``repro.configs.all_cells``): ``mixtral-mop`` is Mixtral's serving
    variant, not an architecture of its own, so it has no cell."""
    for arch in ARCH_IDS:
        if arch == "mixtral-mop":
            continue
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape_applicable(cfg, shape):
                yield arch, shape.name
