"""EP mesh engine: the serving engine over a (1, ep) mesh
(``repro.serving.ep.mesh_engine``).

The engine needs no new decode path — ``AdaptiveServingEngine`` runs every
FFN through ``mixed_moe.moe_apply``, which shards it over the mesh's
"model" axis (per-device shards of each rung bank, the grouped kernels per
local bank). What this module adds is the LAYOUT contract: expert counts
and every rung bank must divide evenly over the EP axis, and the engine's
planner must know ``ep`` so replans keep honouring that
(``EngineConfig.ep``).

Bit-identity with the single-device engine rests on the mesh being
(1, ep): the size-1 "data" axis gives every rank every token, each rank
computes exact per-expert contributions for its local experts, and the
closing sum adds exact zeros from ranks a token was not dispatched to.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.api import EngineConfig, build_engine

__all__ = ["build_ep_engine", "validate_ep_layout"]


def validate_ep_layout(cfg, ep: int) -> None:
    """Raise ``ValueError`` unless ``cfg``'s MoE layout divides over an
    EP axis of size ``ep`` (every per-rung bank is sharded contiguously
    across ranks, so total experts — and, after planner rounding, every
    bank — must be a multiple of ``ep``)."""
    ep = int(ep)
    if ep < 1:
        raise ValueError(f"ep must be >= 1, got {ep}")
    if ep == 1:
        return
    if cfg.moe is None:
        raise ValueError(
            f"--ep {ep} needs an MoE model; {cfg.arch_id} has no experts "
            "to shard")
    e = cfg.moe.num_experts
    if e % ep != 0:
        raise ValueError(
            f"num_experts={e} does not divide over ep={ep} "
            f"({e} % {ep} = {e % ep}); pick ep from the divisors of the "
            "expert count so every rung bank shards evenly")


def build_ep_engine(cfg, params, config: Optional[EngineConfig] = None, *,
                    ep: int = 1, replica: int = 0, devices=None,
                    expert_cache=None):
    """One serving engine decoding over the (1, ep) mesh of DP replica
    ``replica``: the device slice ``[replica*ep, (replica+1)*ep)`` of
    ``devices`` (default: the visible cards; a list may repeat a device).

    ``ep=1, replica=0`` builds the plain single-device engine (no mesh)
    on ``devices[0]`` (default: the card) — the single-device path bit
    for bit. Raises the actionable devices error when there are too few,
    and ``ValueError`` on layouts that do not divide over the EP axis.
    """
    validate_ep_layout(cfg, ep)
    config = config or EngineConfig()
    if config.ep not in (1, ep):
        raise ValueError(
            f"EngineConfig.ep={config.ep} conflicts with ep={ep}")
    config = dataclasses.replace(config, ep=int(ep))
    if ep > 1 or replica > 0:
        from repro_torch.launch.mesh import make_ep_mesh
        return build_engine(cfg, params, config,
                            mesh=make_ep_mesh(ep, replica=replica,
                                              devices=devices),
                            expert_cache=expert_cache)
    return build_engine(cfg, params, config,
                        device=None if devices is None else devices[0],
                        expert_cache=expert_cache)
