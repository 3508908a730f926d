"""Parameters, caches and the model functions of every family
(``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` bundle: the whole-batch
entry points of every family (``init``, ``loss_fn``, ``prefill``,
``decode_step``, ``init_cache``) and, for the dense/MoE decoder (and a
VLM without a frontend), the slot-cache hooks (``prefill_into_slot``,
``decode_step_routed``, ``reset_slot``), the per-layer decode hooks of
the overlap pipeline, the paged-KV hooks and the speculative-decode
hooks; those are ``None`` for the SSM, hybrid and enc-dec families and a
VLM with a vision frontend, as in the reference. ``apply_precision_plan``
converts train-layout MoE params into the N-bank serve layout.
``build_model(cfg, mesh)`` runs over any (data, model) mesh
(``repro_torch.launch.mesh``): every MoE layer through the mesh regimes
of ``mixed_moe.moe_apply``, on params placed by ``dist.sharding.
shard_tree`` (each position holds its ``param_specs`` shard) or by
``apply_precision_plan(..., mesh=)`` (the serve banks' per-position
shards, the other leaves by ``place_params``); a decoder's dense compute
splits over the mesh by the reference's rules (see ``build_model``).
Parameters are nested dicts of tensors with a leading layer axis on every
``layers/...`` leaf, as in the reference. Caches and page pools are
updated in place (the engine holds the only reference); the reference
returns new ones.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mixed_moe
from repro_torch.core.precision_plan import PrecisionPlan
from repro_torch.core.quantization import QTensor
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models.encdec import encdec_forward
from repro_torch.models.transformer import (FORWARDS, _hybrid_layout,
                                            by_column, decoder_block,
                                            decoder_forward,
                                            decoder_forward_split,
                                            layer_slice)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


# ---------------------------------------------------------------------------
# Parameter init (name-rule based; shapes from cfg.param_shapes())
# ---------------------------------------------------------------------------

def _init_one(gen: torch.Generator, name: str, shape, dtype, device):
    """The reference's rules: norm scales, ``norm``, ``ln_x`` and ``D``
    are ones; Mamba2's ``A_log`` is log(linspace(1, 16, H)) (made on the
    host, so every device gets the same bits) and ``dt_bias`` the inverse
    softplus of a log-uniform dt in [1e-3, 0.1]; RWKV's token-shift
    ``mix``/``ffn_mix`` are 0.5, ``decay_base`` 0 and ``bonus``
    N(0, 0.01); every other weight is N(0, 1/fan_in). The deterministic
    leaves draw nothing from ``gen``."""
    last = name.rsplit("/", 1)[-1]
    if last in ("scale", "norm", "ln_x", "D"):
        return torch.ones(shape, dtype=dtype, device=device)
    if last == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[0])).to(
            dtype).to(device)
    if last in ("mix", "ffn_mix"):
        return torch.full(shape, 0.5, dtype=dtype, device=device)
    if last == "decay_base":
        return torch.zeros(shape, dtype=dtype, device=device)
    if last == "dt_bias":
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # inv softplus
    if last == "bonus":
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * 0.1).to(dtype)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    # scaled in place: one f32 copy of the leaf at a time (Kimi-K2's
    # 384 experts are 22.5 GB per matrix in f32)
    return w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dtype)


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


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The param tree as ``meta`` tensors: shapes and dtypes, no storage
    (the reference's ShapeDtypeStruct tree)."""
    dtype = _DTYPES[cfg.dtype]
    return nest({name: torch.empty(shape, dtype=dtype, device="meta")
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

def init_kv_cache(batch: int, window: int, num_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, *,
                  device=None) -> Dict[str, torch.Tensor]:
    """One layer's ring KV cache (``repro.models.layers.init_kv_cache``):
    k/v (B, W, Hkv, hd) zeros and (B, W) int32 position tags, -1 =
    empty."""
    dev = resolve_device(device)
    shape = (batch, window, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.full((batch, window), -1, dtype=torch.int32,
                              device=dev)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict[str, Any]:
    """Decode caches of every family. Ring KV: (L, B, W, Hkv, hd) k/v and
    (L, B, W) int32 position tags (-1 = empty). RWKV: per layer an f32
    state (B, H, K, V) and the model-dtype token-shift rows ``x_att``,
    ``x_ffn`` (B, d). Hybrid: per Mamba2 layer an f32 state (B, H, P, N)
    and the conv rows (B, 3, C), and ``full + 1`` ring KV rows for the
    shared attention. Enc-dec: the decoder's ring KV and ``enc_out``."""
    dev = resolve_device(device)
    dt = _DTYPES[cfg.dtype]

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(n, window):
        a = cfg.attention
        shape = (n, batch, window, a.num_kv_heads, a.head_dim)
        return {"k": zeros(shape), "v": zeros(shape),
                "pos": torch.full(shape[:3], -1, dtype=torch.int32,
                                  device=dev)}

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return kv(cfg.num_layers,
                  min(max_len, cfg.attention.sliding_window or max_len))
    if fam == "encdec":
        return {"self": kv(cfg.num_layers, max_len),
                "enc_out": zeros((batch, cfg.frontend_len, cfg.d_model))}
    if fam == "ssm":   # rwkv6
        h = cfg.d_model // cfg.ssm.head_dim
        n = cfg.num_layers
        return {"state": zeros((n, batch, h, cfg.ssm.head_dim,
                                cfg.ssm.head_dim), torch.float32),
                "x_att": zeros((n, batch, cfg.d_model)),
                "x_ffn": zeros((n, batch, cfg.d_model))}
    if fam == "hybrid":
        di = cfg.ssm.expand * cfg.d_model
        h = di // cfg.ssm.head_dim
        n = cfg.num_layers
        full, _, _ = _hybrid_layout(cfg)
        window = min(max_len, cfg.attention.sliding_window or max_len)
        conv_ch = di + 2 * cfg.ssm.state_dim
        return {
            "mamba": {"state": zeros((n, batch, h, cfg.ssm.head_dim,
                                      cfg.ssm.state_dim), torch.float32),
                      "conv": zeros((n, batch, 3, conv_ch))},
            "attn": kv(full + 1, window),
        }
    raise ValueError(fam)


# ---------------------------------------------------------------------------
# Paged KV cache (DESIGN.md §13)
# ---------------------------------------------------------------------------
#
# The pool holds fixed-size pages {k, v: (L, P, page, Hkv, hd), pos: (L, P,
# page)}; each slot's page table maps its ring chunks to pages. Page 0 is
# the reserved NULL page: all tags -1, never allocated, never written. An
# unmapped chunk therefore gathers as an all-invalid ring segment, masked
# to an exact 0 contribution, so decode through the pages is BIT-IDENTICAL
# to the slot cache: the gathered ring is cut to exactly the window and
# made contiguous, so attention sees operands of the slot cache's shape,
# dtype and strides.
#
# The reference drops writes to the null page with a scatter
# ``mode="drop"``; torch has none. The page table lives on the host (the
# engine's PageAllocator), so the mapped chunks are listed there and only
# those rows are written (``index_copy_``): no scratch page, no device-side
# ``nonzero`` (a host sync per layer).

@dataclasses.dataclass(frozen=True)
class PagedKVMeta:
    """Static layout of a paged KV pool."""
    window: int           # logical ring width per slot (== slot-cache W)
    page_size: int        # tokens per page
    chunks_per_slot: int  # ceil(window / page_size)
    num_pages: int        # physical pages incl. the reserved null page 0


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     page_size: int = 16, num_pages: Optional[int] = None,
                     device=None) -> Tuple[Dict[str, torch.Tensor],
                                           PagedKVMeta]:
    """Paged decode cache: (pool, meta). ``num_pages=None`` sizes the pool
    at worst case (every slot fully windowed) + the null page; a smaller
    pool reclaims HBM for the frontier's residency axis (the engine caps
    admission so allocation can never dead-end mid-flight)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"family {cfg.family} has no paged KV path")
    dev = resolve_device(device)
    window = min(max_len, cfg.attention.sliding_window or max_len)
    chunks = -(-window // page_size)
    if num_pages is None:
        num_pages = batch * chunks + 1
    if num_pages < chunks + 1:
        raise ValueError(f"pool of {num_pages} pages cannot hold even one "
                         f"full window ({chunks} pages)")
    dt = _DTYPES[cfg.dtype]
    shape = (cfg.num_layers, num_pages, page_size,
             cfg.attention.num_kv_heads, cfg.attention.head_dim)
    pool = {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": torch.full(shape[:3], -1, dtype=torch.int32, device=dev)}
    return pool, PagedKVMeta(window=window, page_size=page_size,
                             chunks_per_slot=chunks, num_pages=num_pages)


@dataclasses.dataclass(frozen=True)
class PageTable:
    """A host page table as the index tensors of the paged gathers and
    scatters (built once per engine iteration by :func:`page_table`)."""
    gather: torch.Tensor    # (B, nc) int64: each chunk's page, 0 = null
    chunk: torch.Tensor     # (M,) int64: b * nc + c of each MAPPED chunk
    page: torch.Tensor      # (M,) int64: that chunk's page (never 0)


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host int64 index as a device tensor, copied without blocking
    from pinned memory on a card."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def page_table(table: np.ndarray, device) -> PageTable:
    """The allocator's table (B, nc) — or one slot's row (nc,) — as a
    :class:`PageTable` on ``device``."""
    dev = torch.device(device)
    table = np.atleast_2d(np.asarray(table))
    flat = table.reshape(-1)
    mapped = np.flatnonzero(flat)
    return PageTable(gather=_index(table, dev), chunk=_index(mapped, dev),
                     page=_index(flat[mapped], dev))


def _pad_ring(r: torch.Tensor, pad: int, dim: int, is_pos: bool):
    """Pad the ring axis ``dim`` to whole pages (tags -1, k/v zeros)."""
    if not pad:
        return r
    shape = list(r.shape)
    shape[dim] = pad
    fill = r.new_full(shape, -1) if is_pos else r.new_zeros(shape)
    return torch.cat([r, fill], dim=dim)


def _gather_paged(pool, pt: PageTable, window: int):
    """pool + page table -> the ring cache (L, B, W, ...) the attention
    layers consume, cut to exactly ``window`` and contiguous."""
    def g(a):
        x = a[:, pt.gather]                        # (L, B, nc, ps, ...)
        l, b, nc, ps = x.shape[:4]
        return x.reshape((l, b, nc * ps) + x.shape[4:])[:, :, :window] \
            .contiguous()

    return {key: g(pool[key]) for key in ("k", "v", "pos")}


def _scatter_paged(pool, pt: PageTable, ring, window: int):
    """Write a (possibly updated) ring cache (L, B, W, ...) back into its
    mapped pages; unmapped chunks are skipped, so the null page is never
    dirtied. In place; returns the pool."""
    ps = pool["pos"].shape[2]
    nc = pt.gather.shape[1]
    for key in ("k", "v", "pos"):
        r = _pad_ring(ring[key], nc * ps - window, 2, key == "pos")
        l, b = r.shape[:2]
        rows = r.reshape((l, b * nc, ps) + r.shape[3:])
        pool[key].index_copy_(1, pt.page, rows.index_select(1, pt.chunk))
    return pool


def _gather_paged_layer(pool, pt: PageTable, window: int, layer: int):
    """Single-layer gather for the per-layer decode pipeline: the ring
    (B, W, ...) of layer ``layer``."""
    def g(a):
        x = a[layer][pt.gather]                    # (B, nc, ps, ...)
        b, nc, ps = x.shape[:3]
        return x.reshape((b, nc * ps) + x.shape[3:])[:, :window] \
            .contiguous()

    return {key: g(pool[key]) for key in ("k", "v", "pos")}


def _scatter_paged_layer(pool, pt: PageTable, ring, window: int,
                         layer: int):
    ps = pool["pos"].shape[2]
    nc = pt.gather.shape[1]
    for key in ("k", "v", "pos"):
        r = _pad_ring(ring[key], nc * ps - window, 1, key == "pos")
        rows = r.reshape((r.shape[0] * nc, ps) + r.shape[2:])
        pool[key][layer].index_copy_(0, pt.page,
                                     rows.index_select(0, pt.chunk))
    return pool


def _scatter_prefill_paged(pool, page_row: PageTable, ring, window: int):
    """Scatter one slot's freshly prefilled ring (L, W, ...) into its
    mapped pages (``page_row`` is the slot's one-row page table)."""
    return _scatter_paged(pool, page_row,
                          {key: ring[key][:, None] for key in ring}, window)


def paged_reset_pages(pool, pages):
    """Invalidate freed pages' position tags (tags only — k/v bytes are
    dead once every tag is -1, same as ``reset_slot``). ``pages``: host
    page ids; null entries (0) are skipped."""
    pages = np.asarray(pages).reshape(-1)
    pages = pages[pages != 0]
    if pages.size:
        pool["pos"].index_fill_(1, _index(pages, pool["pos"].device), -1)
    return pool


# ---------------------------------------------------------------------------
# The Model bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    # (seed=0, *, device=None, generator=None) -> params
    loss_fn: Callable
    # (params, batch) -> (loss, metrics): the no-cache full-sequence
    # forward (MoE on the train-layout experts, router losses on);
    # differentiable (training/train_loop.py takes its gradient). batch:
    # tokens, labels (B,S), plus src (B,S_src,d) for enc-dec and frontend
    # (B,frontend_len,d) for a vision VLM (the loss is over the text tail)
    prefill: Callable
    # (params, batch, cache) -> (last-position logits (B,V) f32, cache)
    decode_step: Callable
    # (params, cache, tokens (B,1), positions (B,)) -> (logits (B,V), cache)
    init_cache: Callable
    # (batch, max_len, *, device) -> the family's decode cache
    # Slot-based serving API (continuous batching, DESIGN.md §3); None for
    # families whose decode cache is not the plain ring-buffer KV dict.
    prefill_into_slot: Optional[Callable] = None
    # (params, cache, tokens (1,S), positions (1,S), slot, last_idx)
    #   -> (last-token logits (1,V), cache with slot row replaced)
    decode_step_routed: Optional[Callable] = None
    # (params, cache, tokens (B,1), positions (B,)) -> (logits, cache, ids)
    reset_slot: Optional[Callable] = None
    # (cache, slot) -> cache with the slot's position tags invalidated
    # Per-layer decode hooks (the overlap pipeline, DESIGN.md §12): embed
    # -> layer^L -> logits is the same block sequence as
    # decode_step_routed, so the two give the same bits.
    decode_embed: Optional[Callable] = None
    # (params, tokens (B,1)) -> x (B,1,d)
    decode_layer_routed: Optional[Callable] = None
    # (params, cache, x, positions (B,), layer) -> (x', cache, ids (B,k))
    decode_logits: Optional[Callable] = None
    # (params, x (B,1,d)) -> logits (B,V)
    # Paged KV hooks (DESIGN.md §13): the same surface over a page pool
    # and a PageTable; bit-identical to the slot cache.
    init_paged_cache: Optional[Callable] = None
    # (batch, max_len, *, page_size, num_pages, device) -> (pool, meta)
    paged_prefill_into_slot: Optional[Callable] = None
    # (params, pool, page_row, tokens (1,S), positions (1,S), last_idx,
    #  *, window) -> (logits (1,V), pool)
    paged_decode_step_routed: Optional[Callable] = None
    # (params, pool, page_table, tokens, positions, *, window)
    #   -> (logits, pool, route_ids)
    paged_decode_layer_routed: Optional[Callable] = None
    # (params, pool, page_table, x, positions, layer, *, window)
    #   -> (x', pool, route_ids (B, top_k))
    paged_reset_pages: Optional[Callable] = None
    # (pool, pages) -> pool with the pages' position tags cleared
    # Speculative decode (DESIGN.md §17): one multi-token step serves the
    # draft pass (S=1, draft params) and the verify (S=K+1, serving
    # params); rows tagged -1 are dropped, the MoE dispatch is drop-free.
    spec_step_routed: Optional[Callable] = None
    # (params, cache, tokens (B,S), positions (B,S))
    #   -> (logits (B,S,V), cache, route_ids (L, B*S, top_k))
    paged_spec_step_routed: Optional[Callable] = None
    # (params, pool, page_table, tokens, positions, *, window)
    #   -> (logits (B,S,V), pool, route_ids)
    rollback_slots: Optional[Callable] = None
    # (cache, keep (B,)) -> cache with tags > keep[b] invalidated per slot
    paged_rollback: Optional[Callable] = None
    # (pool, page_table, keep (B,)) -> pool, same contract


def _embed_scaled(params, cfg: ModelConfig, tokens: torch.Tensor):
    table = params["embed"]["table"]
    return L.embed(table, tokens) * torch.tensor(
        math.sqrt(cfg.d_model), dtype=table.dtype, device=table.device)


def _embed_inputs(params, cfg: ModelConfig, batch):
    """tokens (+ frontend embeddings) -> (x (B,S,d), positions (B,S)): a
    vision frontend is prepended unscaled, after the token embeddings are
    scaled by sqrt(d_model)."""
    x = _embed_scaled(params, cfg, batch["tokens"])
    if cfg.frontend == "vision":
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[:2])
    return x, positions


def _mesh_params(params, mesh):
    """A param tree with :class:`dist.sharding.Sharded` leaves in the
    form the whole-batch forwards take where the rules keep the dense
    compute whole (the pure-EP serving mesh, and the SSM, hybrid and
    enc-dec families): every dense leaf gathered whole on
    ``mesh.devices[0]`` (its gradient flows back to the shards through
    the gather), the MoE experts as the list of per-position bank shards
    ``mixed_moe.moe_apply`` runs. A tree without sharded leaves is
    returned as it is."""
    if not SH.has_sharded(params):
        return params
    home = mesh.devices[0]
    out = {k: SH.gather(v, home) for k, v in params.items() if k != "layers"}
    layers = {k: v for k, v in params["layers"].items() if k != "moe"}
    out["layers"] = SH.gather(layers, home)
    moe = params["layers"].get("moe")
    if moe is not None:
        banks = moe.get("banks")
        if banks is None:
            banks = mixed_moe.train_banks(moe)
        if not isinstance(banks, list):
            banks = [SH.at_position(banks, p)
                     for p in range(len(mesh.devices))]
        out["layers"]["moe"] = {"router": SH.gather(moe["router"], home),
                                "banks": banks}
    return out


def _plain_leaf(tree, path=""):
    """The path of a dense leaf of ``tree`` that is not a
    :class:`dist.sharding.Sharded` (bank lists excepted), or None."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "banks" and isinstance(v, list):
                continue
            got = _plain_leaf(v, f"{path}/{k}")
            if got:
                return got
        return None
    if isinstance(tree, QTensor):
        return _plain_leaf(tree.q, path)
    return None if tree is None or isinstance(tree, SH.Sharded) else path


def _position_params(params, split):
    """Each mesh position's param tree of its own shards (no gather): the
    dense leaves' shards, and the MoE experts' bank shard of that
    position (the placed serve banks, or the train layout's expert
    shards as a train-layout bank)."""
    bad = _plain_leaf(params)
    if bad:
        raise ValueError(f"{bad} is not placed on the mesh: the split "
                         "forward takes params placed by dist.sharding."
                         "shard_tree (or apply_precision_plan(mesh=))")
    moe = params["layers"].get("moe")
    banks = None if moe is None else moe.get("banks")
    out = []
    for p in range(split.n):
        tree = SH.at_position(params, p)
        if moe is not None:
            m = tree["layers"]["moe"]
            b = banks[p] if isinstance(banks, list) else \
                mixed_moe.train_banks(m) if banks is None else m["banks"]
            tree["layers"] = dict(tree["layers"],
                                  moe={"router": m["router"], "banks": b})
        out.append(tree)
    return out


def place_params(cfg: ModelConfig, mesh, params):
    """``params`` (a placed bank list under ``layers/moe/banks`` kept as
    it is) placed for serving on ``mesh``: by ``dist.sharding.
    param_specs`` where the reference's serving rules split the dense
    compute (``dist.sharding.splits_dense``), every position holding its
    own shards; otherwise every dense leaf on ``mesh.devices[0]``, where
    the whole-batch forwards run it (the pure-EP serving mesh)."""
    moe = params["layers"].get("moe")
    banks = None if moe is None else moe.get("banks")
    if isinstance(banks, list):
        params = dict(params, layers=dict(
            params["layers"], moe={k: v for k, v in moe.items()
                                   if k != "banks"}))
    if SH.splits_dense(cfg, mesh):
        out = SH.shard_tree(params, SH.param_shardings(cfg, mesh, params))
    else:
        out = _tree_to(params, mesh.devices[0])
    if isinstance(banks, list):
        out["layers"]["moe"]["banks"] = banks
    return out


def _split_cache(cfg: ModelConfig, batch: int, max_len: int, split):
    """``init_cache`` on a mesh whose serving rules split the dense
    compute: each position's cache holds its data rank's rows (all KV
    heads), made on its device, as :class:`dist.sharding.Sharded` leaves
    placed per ``dist.sharding.cache_spec`` (batch over the data axes,
    replicated over model)."""
    if batch % split.n_dp:
        raise ValueError(f"batch of {batch} does not split over "
                         f"{split.n_dp} data ranks")
    parts = split.each(lambda p: init_cache(
        cfg, batch // split.n_dp, max_len, device=split.devices[p]))
    return _sharded_cache(parts, batch, split)


def _sharded_cache(parts, batch: int, split):
    """Per-position {k, v, pos} stacks as :class:`dist.sharding.Sharded`
    leaves of the global batch ``batch``."""
    out = {}
    for key, first in parts[0].items():
        shape = (first.shape[0], batch) + tuple(first.shape[2:])
        out[key] = SH.Sharded(SH.Placement(split.mesh, SH.cache_spec(
            shape, batch, split.batch_entry)), shape, [c[key] for c in parts])
    return out


def _split_logits(logits, rows: int, split):
    """Per-position (B_i, V or V/m) logits as one :class:`dist.sharding.
    Sharded` (B, V): rows over the data axes, vocab slices over model
    where the head is vocab-sharded."""
    b = logits[0].shape[0] * split.n_dp
    sharded = logits[0].shape[-1] < rows
    spec = SH.P(split.batch_entry, SH.MODEL_AXIS if sharded else None)
    return SH.Sharded(SH.Placement(split.mesh, spec), (b, rows), logits)


def _whole_only(name: str):
    """A serving hook that raises: the slot, paged and speculative hooks
    run the whole-batch forwards (one device, or the pure-EP serving
    mesh), which a mesh that splits the dense compute does not take."""
    def refuse(*args, **kwargs):
        raise ValueError(f"Model.{name} serves on one device or the pure-EP "
                         "(1, ep) mesh; this mesh splits the dense compute: "
                         "use prefill and decode_step")
    return refuse


def build_model(cfg: ModelConfig, mesh=None, *,
                dp_axes: Tuple[str, ...] = ("data",),
                use_kernel: bool = False) -> Model:
    """The model functions of ``cfg``'s family. Caches are updated in
    place (the engine holds the only reference).

    ``mesh`` (a (data, model) ``launch.mesh.Mesh``; ``None`` is one
    device) runs every MoE layer's expert FFN over the mesh's positions
    (``mixed_moe.moe_apply``'s regimes), the data axes ``dp_axes``
    splitting the tokens and "data" doubling as the experts' d_ff (FSDP)
    axis of the token-gather regime. On a mesh of more than one position,
    ``loss_fn`` runs under the reference's training activation rules and
    ``prefill``/``decode_step`` under its serving rules
    (``dist.sharding.activation_constraints``).

    Where those rules split a decoder family's dense compute
    (``dist.sharding.splits_dense``: not the pure-EP serving mesh), the
    whole-batch entry points take params placed on the mesh
    (``dist.sharding.shard_tree``, ``place_params``,
    ``apply_precision_plan(mesh=)``) and run split: the batch (tokens,
    positions, labels, a vision frontend) is split over ``dp_axes`` at
    entry (a :class:`dist.sharding.Sharded` input placed so is used as
    it is), every position computes attention, the MLP, the embedding
    and the head on its own shards and its data rank's rows
    (``layers.*_split``), ``init_cache`` places each data rank's cache
    rows at its positions, ``prefill``/``decode_step`` return the logits
    as a :class:`dist.sharding.Sharded` (B, V) (rows over data, vocab
    slices over model; ``.full()`` gathers them) and the cache as
    ``Sharded`` leaves, and ``loss_fn`` sums the data ranks' NLL in rank
    order. Nothing is gathered onto ``mesh.devices[0]``; a plain cache or
    an unplaced dense leaf raises, and so do the slot, paged and
    speculative serving hooks (``_whole_only``). On the pure-EP serving
    mesh (params of ``apply_precision_plan(mesh=)``: the banks' shards,
    every other leaf on ``mesh.devices[0]``) the dense compute runs
    whole there, and so does the SSM, hybrid and enc-dec families',
    whose sharded leaves are gathered onto ``mesh.devices[0]``."""
    fwd = encdec_forward if cfg.family == "encdec" else FORWARDS[cfg.family]
    par = None
    if mesh is not None and cfg.moe is not None:
        par = mixed_moe.MoEParallelism(
            mesh=mesh, dp_axes=dp_axes,
            fsdp_axis="data" if "data" in mesh.axis_names else None)
    mkw = {} if par is None else {"par": par}
    multi = mesh is not None and len(mesh.devices) > 1

    def rules(train: bool = False):
        if not multi:
            return contextlib.nullcontext()
        return SH.activation_constraints(cfg, mesh, dp_axes, train=train)

    def local(params):
        return params if mesh is None else _mesh_params(params, mesh)

    def split_for(train: bool):
        """The :class:`dist.sharding.Split` of a call that runs split, or
        None (its params must then be placed: ``_position_params``
        raises on a whole dense leaf)."""
        if not SH.splits_dense(cfg, mesh, train):
            return None
        return SH.split_of(mesh, tuple(dp_axes))

    def split_inputs(params, batch, split):
        """Each position's params, token embeddings (+ frontend) and
        positions."""
        pp = _position_params(params, split)
        tok = SH.rows(batch["tokens"], split)
        xs = L.embed_split([t["embed"]["table"] for t in pp], tok,
                           cfg.padded_vocab, split)
        xs = split.each(lambda p, x: x * torch.tensor(
            math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device), xs)
        if cfg.frontend == "vision" and "frontend" in batch:
            fr = SH.rows(batch["frontend"], split)
            xs = split.each(lambda p, f, x: torch.cat([f.to(x.dtype), x],
                                                      dim=1), fr, xs)
        poss = split.each(lambda p, x: torch.arange(
            x.shape[1], device=x.device)[None].expand(x.shape[:2]), xs)
        return pp, xs, poss

    def split_head(pp, ys, split):
        return split.each(lambda p, t, y: L.unembed(
            t["lm_head"]["table"], L.rms_norm(y, t["final_norm"]["scale"])),
            pp, ys)

    def split_cache_parts(cache, split):
        if not (isinstance(cache, dict)
                and all(isinstance(v, SH.Sharded) for v in cache.values())):
            raise ValueError("on this mesh the cache is split over the "
                             "data ranks: make it with Model.init_cache")
        return [{k: v.shards[p] for k, v in cache.items()}
                for p in range(split.n)]

    def loss_split(params, batch, split):
        with rules(train=True):
            pp, xs, poss = split_inputs(params, batch, split)
            ys, _, aux = decoder_forward_split(pp, cfg, xs, poss,
                                               caches=None, split=split,
                                               train=True, par=par)
            if cfg.frontend == "vision":   # loss over the text tail only
                ys = split.each(lambda p, y: y[:, cfg.frontend_len:], ys)
            logits = split_head(pp, ys, split)
        return L.softmax_xent_split(logits, SH.rows(batch["labels"], split),
                                    cfg.vocab_size, split), aux

    def prefill_split(params, batch, cache, split):
        parts = split_cache_parts(cache, split)
        with rules():
            pp, xs, poss = split_inputs(params, batch, split)
            ys, new, _ = decoder_forward_split(pp, cfg, xs, poss,
                                               caches=parts, split=split,
                                               use_kernel=use_kernel,
                                               par=par)
            logits = split_head(pp, split.each(lambda p, y: y[:, -1:], ys),
                                split)
        logits = split.each(lambda p, lg: lg[:, 0], logits)
        b = next(iter(cache.values())).shape[1]
        return _split_logits(logits, cfg.padded_vocab, split), \
            _sharded_cache(new, b, split)

    def decode_split(params, cache, tokens, positions, split):
        parts = split_cache_parts(cache, split)
        with rules():
            pp, xs, _ = split_inputs(params, {"tokens": tokens}, split)
            poss = split.each(lambda p, q: q[:, None],
                              SH.rows(positions, split))
            ys, _, _ = decoder_forward_split(pp, cfg, xs, poss, caches=parts,
                                             split=split,
                                             use_kernel=use_kernel, par=par)
            logits = split_head(pp, ys, split)
        logits = split.each(lambda p, lg: lg[:, 0], logits)
        return _split_logits(logits, cfg.padded_vocab, split), cache

    def _head(params, y):
        y = L.rms_norm(y, params["final_norm"]["scale"])
        return L.unembed(params["lm_head"]["table"], y)

    def loss_fn(params, batch):
        """The reference's ``loss_fn``: embed (+ frontend), the whole
        sequence through every layer with no cache (MoE on the
        train-layout experts, router losses on, ``cfg.remat`` honoured),
        final norm, unembed (the text tail only behind a vision
        frontend), mean NLL plus the router losses. Returns (loss,
        metrics). Records a graph when grad mode is on and a param
        requires grad; the train step's backward is deterministic on the
        card (``layers.embed``, ``mixed_moe._dispatch_local``)."""
        split = split_for(train=True)
        if split is not None:
            loss, aux = loss_split(params, batch, split)
            metrics = {"nll": loss}
            for k, v in aux.items():
                loss = loss + v.to(loss.device)
                metrics[k] = v
            metrics["loss"] = loss
            return loss, metrics
        params = local(params)
        with rules(train=True):
            x, positions = _embed_inputs(params, cfg, batch)
            kw = {"src": batch["src"]} if cfg.family == "encdec" else {}
            y, _, aux = fwd(params, cfg, x, positions, caches=None,
                            train=True, **kw, **mkw)
            if cfg.frontend == "vision":   # loss over the text tail only
                y = y[:, cfg.frontend_len:]
            logits = _head(params, y)
        loss = L.softmax_xent(logits, batch["labels"], cfg.vocab_size)
        metrics = {"nll": loss}
        for k, v in aux.items():
            loss = loss + v
            metrics[k] = v
        metrics["loss"] = loss
        return loss, metrics

    @torch.no_grad()
    def prefill(params, batch, cache):
        """The whole batch's prompts (+ ``src`` / ``frontend``) into a
        fresh cache from ``init_cache``: (the last position's logits
        (B, V) f32, the cache)."""
        split = split_for(train=False)
        if split is not None:
            return prefill_split(params, batch, cache, split)
        _whole_cache(cache)
        params = local(params)
        with rules():
            x, positions = _embed_inputs(params, cfg, batch)
            kw = {"src": batch["src"]} if cfg.family == "encdec" else {}
            y, new_cache, _ = fwd(params, cfg, x, positions, caches=cache,
                                  use_kernel=use_kernel, **kw, **mkw)
            return _head(params, y[:, -1:])[:, 0], new_cache

    @torch.no_grad()
    def decode_step(params, cache, tokens, positions):
        """tokens (B,1); positions (B,) absolute position of the token
        (behind a vision frontend it counts the frontend's positions).
        Returns (logits (B,V) f32, cache)."""
        split = split_for(train=False)
        if split is not None:
            return decode_split(params, cache, tokens, positions, split)
        _whole_cache(cache)
        params = local(params)
        with rules():
            x = _embed_scaled(params, cfg, tokens)
            kw = {"enc_out": cache["enc_out"]} \
                if cfg.family == "encdec" else {}
            y, new_cache, _ = fwd(params, cfg, x, positions[:, None],
                                  caches=cache, use_kernel=use_kernel, **kw,
                                  **mkw)
            return _head(params, y)[:, 0], new_cache

    def _whole_cache(cache):
        if isinstance(cache, dict) and any(
                isinstance(v, SH.Sharded) for v in cache.values()):
            raise ValueError("a split cache needs params placed on the "
                             "mesh (dist.sharding.shard_tree, "
                             "place_params)")

    def model_init_cache(batch: int, max_len: int, *, device=None):
        """The family's decode cache; on a mesh whose serving rules split
        a decoder's dense compute, each data rank's rows at its
        positions (``device`` is then the mesh's)."""
        if SH.splits_dense(cfg, mesh):
            return _split_cache(cfg, batch, max_len,
                                SH.split_of(mesh, tuple(dp_axes)))
        return init_cache(cfg, batch, max_len, device=device)

    entry = dict(cfg=cfg, init=functools.partial(init_params, cfg),
                 loss_fn=loss_fn, prefill=prefill, decode_step=decode_step,
                 init_cache=model_init_cache)
    if cfg.family not in ("dense", "moe", "vlm") or cfg.frontend != "none":
        return Model(**entry)

    @torch.no_grad()
    def decode_step_routed(params, cache, tokens, positions):
        """tokens (B,1); positions (B,) absolute position of the token.
        Idle slots pass position=-1: their ring-buffer write lands with an
        invalid (-1) tag. Returns (logits (B,V) f32, cache, route ids
        (L, B, top_k) in bank order)."""
        x = _embed_scaled(params, cfg, tokens)
        y, new_cache, aux = decoder_forward(
            params, cfg, x, positions[:, None], caches=cache,
            use_kernel=use_kernel, collect_routes=cfg.moe is not None,
            par=par)
        y = L.rms_norm(y, params["final_norm"]["scale"])
        logits = L.unembed(params["lm_head"]["table"], y)
        return logits[:, 0], new_cache, aux.get("route_ids")

    def _prefill(params, like, tokens, positions, last_idx: int,
                 window: int):
        """Prefill into a fresh one-slot ring of ``window``: returns
        (next-token logits (1, V), the written ring (L, 1, W, ...)).
        Prefill attends over the in-context k/v, so the logits do not
        depend on the cache layout."""
        n, hkv, hd = like["k"].shape[0], like["k"].shape[-2], \
            like["k"].shape[-1]
        x = _embed_scaled(params, cfg, tokens)
        sub = {"k": like["k"].new_zeros((n, 1, window, hkv, hd)),
               "v": like["v"].new_zeros((n, 1, window, hkv, hd)),
               "pos": like["pos"].new_full((n, 1, window), -1)}
        y, new_sub, _ = decoder_forward(params, cfg, x, positions,
                                        caches=sub, use_kernel=use_kernel,
                                        par=par)
        y_last = y[:, min(max(int(last_idx), 0), y.shape[1] - 1)][:, None]
        y_last = L.rms_norm(y_last, params["final_norm"]["scale"])
        logits = L.unembed(params["lm_head"]["table"], y_last)
        return logits[:, 0], new_sub

    @torch.no_grad()
    def prefill_into_slot(params, cache, tokens, positions, slot: int,
                          last_idx: int):
        """Prefill ONE request into decode slot ``slot`` of a live batch
        cache without touching the other slots.

        tokens/positions: (1, S) RIGHT-padded; pad positions are -1 (the
        attention mask and the ring-buffer tags treat them as invalid).
        Returns (next-token logits (1, V), cache with the slot row
        replaced in place)."""
        logits, new_sub = _prefill(params, cache, tokens, positions,
                                   last_idx, cache["k"].shape[2])
        for key in ("k", "v", "pos"):
            cache[key][:, slot] = new_sub[key][:, 0]
        return logits, cache

    def reset_slot(cache, slot: int):
        """Invalidate a retired slot's ring buffer (tags only — k/v bytes
        are dead once every tag is -1)."""
        cache["pos"][:, slot] = -1
        return cache

    # -- per-layer decode (async overlap pipeline, DESIGN.md §12) --------
    @torch.no_grad()
    def decode_embed(params, tokens):
        """tokens (B,1) -> embedded x (B,1,d); the pipeline's front."""
        return _embed_scaled(params, cfg, tokens)

    @torch.no_grad()
    def decode_layer_routed(params, cache, x, positions, layer: int):
        """Decoder block ``layer`` of the stack: the same block as
        ``decoder_forward`` runs, so per-layer and whole-stack decode give
        the same bits. Writes that layer's ring in place; returns (x',
        cache, the layer's route ids (B, top_k) in bank order)."""
        ring = {k: cache[k][layer] for k in ("k", "v", "pos")}
        x, _, ids = decoder_block(layer_slice(params["layers"], layer),
                                  cfg, x, positions[:, None], ring,
                                  use_kernel=use_kernel, par=par)
        return x, cache, ids

    @torch.no_grad()
    def decode_logits(params, x):
        """Pipeline tail: final norm + unembed of the last block output."""
        y = L.rms_norm(x, params["final_norm"]["scale"])
        return L.unembed(params["lm_head"]["table"], y)[:, 0]

    # -- paged KV serving hooks (DESIGN.md §13) ----------------------------
    @torch.no_grad()
    def paged_prefill_into_slot(params, pool, page_row: PageTable, tokens,
                                positions, last_idx: int, *, window: int):
        """Paged ``prefill_into_slot``: the same fresh one-slot prefill,
        then the written ring goes into the slot's mapped pages."""
        logits, new_sub = _prefill(params, pool, tokens, positions,
                                   last_idx, window)
        _scatter_prefill_paged(
            pool, page_row, {k: new_sub[k][:, 0] for k in new_sub}, window)
        return logits, pool

    @torch.no_grad()
    def paged_decode_step_routed(params, pool, pt: PageTable, tokens,
                                 positions, *, window: int):
        """Paged ``decode_step_routed``: gather the page view into the ring
        cache, run the same decode step, scatter the ring back."""
        ring = _gather_paged(pool, pt, window)
        logits, ring, route_ids = decode_step_routed(params, ring, tokens,
                                                     positions)
        return logits, _scatter_paged(pool, pt, ring, window), route_ids

    @torch.no_grad()
    def paged_decode_layer_routed(params, pool, pt: PageTable, x,
                                  positions, layer: int, *, window: int):
        """Paged ``decode_layer_routed`` for the overlap pipeline: one
        layer's page view gathered and scattered per call."""
        ring = _gather_paged_layer(pool, pt, window, layer)
        x, ring, ids = decoder_block(layer_slice(params["layers"], layer),
                                     cfg, x, positions[:, None], ring,
                                     use_kernel=use_kernel, par=par)
        _scatter_paged_layer(pool, pt, ring, window, layer)
        return x, pool, ids

    # -- self-speculative decode hooks (DESIGN.md §17) ---------------------
    @torch.no_grad()
    def spec_step_routed(params, cache, tokens, positions):
        """Multi-token cached step: tokens/positions (B, S), positions
        RIGHT-padded with -1 past each slot's live span (idle slots all
        -1). Returns the full (B, S, V) logits, the cache (written in
        place) and the route ids (L, B*S, top_k), padded rows remapped to
        the sentinel ``num_experts``."""
        x = _embed_scaled(params, cfg, tokens)
        y, cache, aux = decoder_forward(params, cfg, x, positions,
                                        caches=cache, use_kernel=use_kernel,
                                        collect_routes=True, spec=True,
                                        par=par)
        # the head column by column too, at plain decode's shapes
        logits = by_column(lambda yc: L.unembed(
            params["lm_head"]["table"],
            L.rms_norm(yc, params["final_norm"]["scale"])), y)
        return logits, cache, aux["route_ids"]

    @torch.no_grad()
    def paged_spec_step_routed(params, pool, pt: PageTable, tokens,
                               positions, *, window: int):
        """Paged ``spec_step_routed``: gather, the same step, scatter."""
        ring = _gather_paged(pool, pt, window)
        logits, ring, route_ids = spec_step_routed(params, ring, tokens,
                                                   positions)
        return logits, _scatter_paged(pool, pt, ring, window), route_ids

    def rollback_slots(cache, keep):
        """Invalidate ring entries past ``keep[b]`` (the last ACCEPTED
        absolute position per slot): rejected speculative tokens become
        dead tags. Slots outside the speculative batch pass a large
        ``keep``."""
        cache["pos"].masked_fill_(cache["pos"] > keep[None, :, None], -1)
        return cache

    def paged_rollback(pool, pt: PageTable, keep):
        """Paged ``rollback_slots``: the slots' page views' tags are
        gathered, bounded and written back to the mapped pages."""
        pos = pool["pos"][:, pt.gather]                  # (L, B, nc, ps)
        pos = torch.where(pos > keep[None, :, None, None],
                          torch.full_like(pos, -1), pos)
        l, b, nc, ps = pos.shape
        pool["pos"].index_copy_(
            1, pt.page, pos.reshape(l, b * nc, ps).index_select(1, pt.chunk))
        return pool

    hooks = dict(prefill_into_slot=prefill_into_slot,
                 decode_step_routed=decode_step_routed,
                 reset_slot=reset_slot,
                 decode_embed=decode_embed,
                 decode_layer_routed=decode_layer_routed,
                 decode_logits=decode_logits,
                 init_paged_cache=functools.partial(init_paged_cache, cfg),
                 paged_prefill_into_slot=paged_prefill_into_slot,
                 paged_decode_step_routed=paged_decode_step_routed,
                 paged_decode_layer_routed=paged_decode_layer_routed,
                 paged_reset_pages=paged_reset_pages,
                 spec_step_routed=spec_step_routed,
                 paged_spec_step_routed=paged_spec_step_routed,
                 rollback_slots=rollback_slots,
                 paged_rollback=paged_rollback)
    if SH.splits_dense(cfg, mesh):
        hooks = {k: _whole_only(k) for k in hooks}
    return Model(**entry, **hooks)


# ---------------------------------------------------------------------------
# Applying a MoP PrecisionPlan to trained params (serve layout)
# ---------------------------------------------------------------------------

def _stack_like(tree, n: int):
    """Uninitialized storage for ``n`` stacked copies of ``tree`` (dicts of
    tensors and QTensors)."""
    if isinstance(tree, QTensor):
        return tree.map(lambda t: t.new_empty((n,) + tuple(t.shape)))
    if isinstance(tree, dict):
        return {k: _stack_like(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _put(dst, src, i: int) -> None:
    """Copy ``src`` into slot ``i`` of the stacked ``dst``."""
    if isinstance(dst, QTensor):
        dst.q[i].copy_(src.q)
        dst.scales[i].copy_(src.scales)
    elif isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k], i)
    else:
        dst[i].copy_(src)


def _tree_to(tree, device: torch.device):
    """Every tensor of a param tree on ``device`` (no copy where it is
    already there)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@torch.no_grad()
def apply_precision_plan(params, cfg: ModelConfig, plan: PrecisionPlan,
                         mesh=None):
    """Convert train-layout MoE params into N-bank serve layout: one bank
    per ladder rung (ascending-bits order, e.g. [q4 | q8 | f16]) + router
    column permutation. Per-layer rung counts are equal by construction
    (balanced plan), so the banks stack over layers: each layer's banks
    are built and copied into preallocated stacked storage before the
    next layer's, so the build holds one layer's banks beside the result.
    Quantization runs on the params' device.

    ``mesh`` (a (data, model) mesh) places the result on it: the banks
    become a list of per-position shards as ``dist.sharding.
    _expert_spec`` places them (``mixed_moe.shard_banks``): with EP,
    position (i, j) holds model rank j's contiguous slice ``[j*loc_b,
    (j+1)*loc_b)`` of every bank, replicated over data, plus the
    contiguous d_ff slice i the token-gather regime runs where the data
    axis is > 1; with TP (fewer experts than model ranks), all experts
    on d_ff slice j. Each position's shards are in storage of its own on
    ``mesh.devices[p]``, preallocated per position and filled layer by
    layer; every other leaf is placed by :func:`place_params` (its
    ``param_specs`` shards where the serving rules split the dense
    compute, else ``mesh.devices[0]``). Raises ``ValueError`` when a bank
    does not split evenly over the ranks."""
    assert cfg.moe is not None
    moe_p = params["layers"]["moe"]
    stacked = None
    routers = []
    for li in range(cfg.num_layers):
        layer_p = {k: moe_p[k][li] for k in ("w_gate", "w_up", "w_down")}
        banks, order = mixed_moe.build_ladder_banks(
            layer_p, plan.bits[li], ladder=plan.ladder,
            group_size=plan.group_size)
        parts = [banks] if mesh is None \
            else mixed_moe.shard_banks(banks, mesh)
        if stacked is None:
            stacked = [{k: None if v is None else
                        _stack_like(v, cfg.num_layers)
                        for k, v in part.items()} for part in parts]
        for dst, part in zip(stacked, parts):
            for k, v in part.items():
                if v is not None:
                    _put(dst[k], v, li)
        del banks, parts
        idx = torch.as_tensor(order, dtype=torch.long,
                              device=moe_p["router"].device)
        routers.append(moe_p["router"][li].index_select(1, idx))
    new_params = dict(params)
    new_params["layers"] = dict(params["layers"])
    new_params["layers"]["moe"] = {
        "router": torch.stack(routers),
        "banks": stacked[0] if mesh is None else stacked,
    }
    if mesh is not None:
        new_params = place_params(cfg, mesh, new_params)
    return new_params
