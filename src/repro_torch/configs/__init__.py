"""Architecture registry of the port: ``get_config("<arch-id>")``.

Mixtral-8x7B (plain and with the paper's MoP serving defaults) and the
dense SmolLM-360M that the training examples use."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    AttentionConfig, ModelConfig, MoEConfig, MoPConfig, reduce_for_smoke,
)

_MODULES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "mixtral-mop": "mixtral_mop",
    "smollm-360m": "smollm_360m",
}
ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
