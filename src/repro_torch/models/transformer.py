"""Dense / MoE decoder stack (``repro.models.transformer``'s
``decoder_forward``). PyTorch runs eagerly, so the reference's scan over
stacked layer params is a Python loop over the leading layer axis.

    forward(params, cfg, x, positions, caches) -> (y, new_caches, aux)

through the slot KV cache: prefill (S > 1) writes fresh ring buffers,
decode (S == 1) updates ``caches`` in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mixed_moe
from repro_torch.core.quantization import QTensor
from repro_torch.models import layers as L


def layer_slice(tree, li: int):
    """Index every tensor (and QTensor) of a stacked param tree at layer
    ``li``; ``None`` leaves stay ``None``."""
    if isinstance(tree, QTensor):
        return tree.map(lambda t: t[li])
    if isinstance(tree, dict):
        return {k: layer_slice(v, li) for k, v in tree.items()}
    if tree is None:
        return None
    return tree[li]


def _ffn_or_moe(p, xn, cfg: ModelConfig, use_kernel, token_valid=None):
    """Returns (y, route_ids|None) — ids are the (T, k) routed expert slots
    in BANK order (the serve layout permutes experts q4-first).

    ``token_valid`` (B, S) bool masks idle decode slots / prefill pads out
    of the dispatch: their ids become the out-of-range sentinel
    ``num_experts`` (dropped by ``_local_slot``), so they never occupy
    expert capacity and displace real tokens."""
    if cfg.moe is None:
        return L.mlp(p["mlp"], xn, cfg.act), None
    b, s, d = xn.shape
    x2 = xn.reshape(b * s, d)
    weights, ids = mixed_moe.route(p["moe"]["router"], x2, cfg.moe)
    if token_valid is not None:
        v = token_valid.reshape(b * s)[:, None]
        ids = torch.where(v, ids, torch.full_like(ids, cfg.moe.num_experts))
        weights = torch.where(v, weights, torch.zeros_like(weights))
    banks = p["moe"].get("banks")
    if banks is None:
        banks = mixed_moe.train_banks(p["moe"])
    y = mixed_moe.moe_apply(banks, x2, weights, ids, cfg.moe, act=cfg.act,
                            use_kernel=use_kernel)
    return y.reshape(b, s, d), ids


def decoder_forward(params, cfg: ModelConfig, x, positions, *,
                    caches, use_kernel=False, collect_routes=False):
    """x: (B,S,d) embedded input. Returns (y, new_caches, aux).

    ``collect_routes=True`` stacks the per-layer routed expert ids into
    ``aux["route_ids"]`` (L, T, k) so the engine can drive the runtime
    expert cache. A decode step (S == 1) updates ``caches`` in place and
    returns it; a prefill returns freshly written ring buffers."""
    if collect_routes and cfg.moe is None:
        raise ValueError("collect_routes needs routed experts")
    token_valid = (positions >= 0) if cfg.moe is not None else None
    new_kvs, route_ids = [], []
    for li in range(cfg.num_layers):
        p = layer_slice(params["layers"], li)
        cache = {k: caches[k][li] for k in ("k", "v", "pos")}
        h, new_kv = L.attention(
            p["attn"], L.rms_norm(x, p["attn_norm"]["scale"]),
            cfg.attention, positions=positions, cache=cache)
        x = x + h
        xn = L.rms_norm(x, p["ffn_norm"]["scale"])
        h, ids = _ffn_or_moe(p, xn, cfg, use_kernel,
                             token_valid=token_valid)
        x = x + h
        new_kvs.append(new_kv)
        route_ids.append(ids)
    if x.shape[1] == 1:
        new_caches = caches              # written in place layer by layer
    else:
        new_caches = {k: torch.stack([kv[k] for kv in new_kvs])
                      for k in ("k", "v", "pos")}
    aux: Dict[str, Any] = {}
    if collect_routes:
        aux["route_ids"] = torch.stack(route_ids)
    return x, new_caches, aux
