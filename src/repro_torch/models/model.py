"""Parameters, caches and the serving model functions of the dense/MoE
decoder (``repro.models.model``'s slot-cache serving surface).

``build_model(cfg)`` returns a :class:`Model` bundle with
``prefill_into_slot``, ``decode_step_routed`` and ``reset_slot``;
``apply_precision_plan`` converts train-layout MoE params into the N-bank
serve layout. Parameters are nested dicts of tensors with a leading layer
axis on every ``layers/...`` leaf, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mixed_moe
from repro_torch.core.precision_plan import PrecisionPlan
from repro_torch.core.quantization import QTensor
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import decoder_forward

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


# ---------------------------------------------------------------------------
# Parameter init (name-rule based; shapes from cfg.param_shapes())
# ---------------------------------------------------------------------------

def _init_one(gen: torch.Generator, name: str, shape, dtype, device):
    """The reference's rules for the dense/MoE families: norm scales are
    ones, every other weight is N(0, 1/fan_in)."""
    if name.rsplit("/", 1)[-1] == "scale":
        return torch.ones(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return (w * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        node = out
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
    """Random parameters drawn on ``device`` (default: the card) from an
    explicit ``torch.Generator`` (seeded with ``seed`` unless one is
    given). Same name rules and shapes as the reference; the numbers
    differ (another generator)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    dtype = _DTYPES[cfg.dtype]
    return nest({name: _init_one(gen, name, shape, dtype, dev)
                 for name, shape in cfg.param_shapes()})


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array as a tensor (a copy; bf16 is read through a uint16
    view)."""
    a = np.array(a)                      # writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes array: reinterpret bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None):
    """The reference's params (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors on
    ``device`` (default: the card). bf16 arrays are read through a uint16
    view, so no ml_dtypes is needed."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tensor_from_numpy(np.asarray(node), dev)

    return walk(tree)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    """Slot KV cache of the dense/MoE family: (L, B, W, Hkv, hd) k/v and
    (L, B, W) int32 position tags (-1 = empty)."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"family {cfg.family} is not in this slice")
    dev = resolve_device(device)
    dt = _DTYPES[cfg.dtype]
    a = cfg.attention
    window = min(max_len, a.sliding_window or max_len)
    shape = (cfg.num_layers, batch, window, a.num_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": torch.full(shape[:3], -1, dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# The Model bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_cache: Callable
    prefill_into_slot: Callable
    # (params, cache, tokens (1,S), positions (1,S), slot, last_idx)
    #   -> (last-token logits (1,V), cache with slot row replaced)
    decode_step_routed: Callable
    # (params, cache, tokens (B,1), positions (B,)) -> (logits, cache, ids)
    reset_slot: Callable
    # (cache, slot) -> cache with the slot's position tags invalidated


def _embed_scaled(params, cfg: ModelConfig, tokens: torch.Tensor):
    table = params["embed"]["table"]
    return L.embed(table, tokens) * torch.tensor(
        math.sqrt(cfg.d_model), dtype=table.dtype, device=table.device)


def build_model(cfg: ModelConfig, *, use_kernel: bool = False) -> Model:
    """The slot-cache serving functions for a dense/MoE config. Caches are
    updated in place (the engine holds the only reference)."""
    if cfg.family not in ("dense", "moe") or cfg.frontend != "none":
        raise ValueError(f"{cfg.arch_id}: family {cfg.family} is not in "
                         "this slice")

    @torch.no_grad()
    def decode_step_routed(params, cache, tokens, positions):
        """tokens (B,1); positions (B,) absolute position of the token.
        Idle slots pass position=-1: their ring-buffer write lands with an
        invalid (-1) tag. Returns (logits (B,V) f32, cache, route ids
        (L, B, top_k) in bank order)."""
        x = _embed_scaled(params, cfg, tokens)
        y, new_cache, aux = decoder_forward(
            params, cfg, x, positions[:, None], caches=cache,
            use_kernel=use_kernel, collect_routes=cfg.moe is not None)
        y = L.rms_norm(y, params["final_norm"]["scale"])
        logits = L.unembed(params["lm_head"]["table"], y)
        return logits[:, 0], new_cache, aux.get("route_ids")

    @torch.no_grad()
    def prefill_into_slot(params, cache, tokens, positions, slot: int,
                          last_idx: int):
        """Prefill ONE request into decode slot ``slot`` of a live batch
        cache without touching the other slots.

        tokens/positions: (1, S) RIGHT-padded; pad positions are -1 (the
        attention mask and the ring-buffer tags treat them as invalid).
        Returns (next-token logits (1, V), cache with the slot row
        replaced in place)."""
        n, _, window, hkv, hd = cache["k"].shape
        x = _embed_scaled(params, cfg, tokens)
        sub = {"k": cache["k"].new_zeros((n, 1, window, hkv, hd)),
               "v": cache["v"].new_zeros((n, 1, window, hkv, hd)),
               "pos": cache["pos"].new_full((n, 1, window), -1)}
        y, new_sub, _ = decoder_forward(params, cfg, x, positions,
                                        caches=sub, use_kernel=use_kernel)
        y_last = y[:, min(max(int(last_idx), 0), y.shape[1] - 1)][:, None]
        y_last = L.rms_norm(y_last, params["final_norm"]["scale"])
        logits = L.unembed(params["lm_head"]["table"], y_last)
        for key in ("k", "v", "pos"):
            cache[key][:, slot] = new_sub[key][:, 0]
        return logits[:, 0], cache

    def reset_slot(cache, slot: int):
        """Invalidate a retired slot's ring buffer (tags only — k/v bytes
        are dead once every tag is -1)."""
        cache["pos"][:, slot] = -1
        return cache

    def _init_cache(batch, max_len, *, device=None):
        return init_cache(cfg, batch, max_len, device=device)

    return Model(cfg=cfg, init_cache=_init_cache,
                 prefill_into_slot=prefill_into_slot,
                 decode_step_routed=decode_step_routed,
                 reset_slot=reset_slot)


# ---------------------------------------------------------------------------
# Applying a MoP PrecisionPlan to trained params (serve layout)
# ---------------------------------------------------------------------------

def _stack(items):
    if isinstance(items[0], QTensor):
        return QTensor(q=torch.stack([i.q for i in items]),
                       scales=torch.stack([i.scales for i in items]),
                       bits=items[0].bits, group_size=items[0].group_size)
    if isinstance(items[0], dict):
        return {k: _stack([i[k] for i in items]) for k in items[0]}
    return torch.stack(items)


@torch.no_grad()
def apply_precision_plan(params, cfg: ModelConfig, plan: PrecisionPlan):
    """Convert train-layout MoE params into N-bank serve layout: one bank
    per ladder rung (ascending-bits order, e.g. [q4 | q8 | f16]) + router
    column permutation. Per-layer rung counts are equal by construction
    (balanced plan), so the banks stack over layers. Quantization runs on
    the params' device."""
    assert cfg.moe is not None
    moe_p = params["layers"]["moe"]
    banks_per_layer = []
    routers = []
    for li in range(cfg.num_layers):
        layer_p = {k: moe_p[k][li] for k in ("w_gate", "w_up", "w_down")}
        banks, order = mixed_moe.build_ladder_banks(
            layer_p, plan.bits[li], ladder=plan.ladder,
            group_size=plan.group_size)
        banks_per_layer.append(banks)
        idx = torch.as_tensor(order, dtype=torch.long,
                              device=moe_p["router"].device)
        routers.append(moe_p["router"][li].index_select(1, idx))
    stacked = {}
    for bank in banks_per_layer[0]:
        if banks_per_layer[0][bank] is None:
            stacked[bank] = None
        else:
            stacked[bank] = _stack([b[bank] for b in banks_per_layer])
    new_params = dict(params)
    new_params["layers"] = dict(params["layers"])
    new_params["layers"]["moe"] = {
        "router": torch.stack(routers),
        "banks": stacked,
    }
    return new_params
