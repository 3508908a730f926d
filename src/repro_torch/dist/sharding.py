"""Sharding rules (``repro.dist.sharding``): one module owns every rule of
where a tensor lives on a device mesh.

The reference annotates its programs for GSPMD; the port runs them from
one process over a ``repro_torch.launch.mesh.Mesh`` (whose device list
may repeat a device), so a rule here is explicit storage:

* **Activation constraints** — ``activation_constraints(cfg, mesh,
  dp_axes)`` installs the reference's table of logical activation names
  ("residual", "attn_scores_full", ...) and their specs, and makes
  ``mesh`` the active mesh; ``constrain(x, name)`` returns ``x``
  unchanged (the split forwards hold each activation as per-position
  shards, by these rules, and need no annotation). ``full_grouped_ok``
  reads the active mesh to choose the attention contraction, as the
  reference's does.

* **The split dense path** — :class:`Split` says which rows of the batch
  and which model rank each position holds; :func:`rows` hands each
  position its data rank's rows of an input; :func:`all_reduce` (the
  model-axis closing sum of row-parallel partial outputs) and
  :func:`all_gather` (column shards, vocab slices, token shards, state
  slices) and :func:`reduce_scatter` (RWKV's gated channel mix) are the
  collectives between the positions' work, each an f32 sum (or a
  concatenation) in rank order, rounded once, with a backward of the same
  kind, and each booked with ``roofline.op_count``. :class:`Owner` runs
  a call of one batch row (the engine's slot prefill) at one data rank's
  model group, with its MoE tokens spread over every data rank.

* **Parameter rules** — ``param_specs`` walks a param tree and assigns
  the reference's megatron-style specs by leaf name (column-parallel
  up-projections, row-parallel down-projections, vocab-sharded tables,
  EP- or TP-sharded expert banks). ``param_shardings`` turns them into
  :class:`Placement`\\ s, and ``shard_tree`` stores each tensor leaf as a
  :class:`Sharded`: one shard per mesh position, on that position's
  device, exactly the block the spec gives it. Positions whose blocks
  are the same are replicas; each holds its own copy.

* **IO specs** — ``input_specs`` / ``cache_specs`` give the dry-run
  inputs and caches as ``meta`` tensors (shapes, no storage) with their
  placements.

Every rule degrades to replication when a dim does not divide the mesh
axis. :func:`per_shard`, :func:`whole` and :func:`sum_replicas` are what
the optimizers and the train step use to update a sharded tree once per
distinct shard and keep its replicas equal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quantization import QTensor
from repro_torch.roofline import op_count as OC

MODEL_AXIS = "model"

_ACTIVE = threading.local()          # .rules: Dict[str, P] | None, .mesh


class P(tuple):
    """``jax.sharding.PartitionSpec``: per dim ``None`` (replicated), an
    axis name, or a tuple of axis names (a one-name tuple is the name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def _axis_size(mesh, axis: str) -> int:
    return int(mesh.sizes.get(axis, 1))


def _dp_entry(dp_axes: Tuple[str, ...]):
    """The spec entry for the batch/token dim."""
    if not dp_axes:
        return None
    return dp_axes if len(dp_axes) > 1 else dp_axes[0]


def batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """Data-parallel axes for this (mesh, batch): the ("pod","data") prefix
    whose total size divides the global batch; drops axes (pod first)
    until it does."""
    axes = [a for a in ("pod", "data") if a in mesh.sizes]
    while axes:
        n = math.prod(_axis_size(mesh, a) for a in axes)
        if n and global_batch % n == 0:
            break
        axes.pop(0)
    return tuple(axes)


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------

def ep_only(cfg, mesh, train: bool = False) -> bool:
    """A pure-EP serving mesh: every batch axis has size 1, "model" only
    shards expert banks and attention stays replicated."""
    return cfg.moe is not None and not train and all(
        _axis_size(mesh, a) <= 1 for a in ("pod", "data"))


def splits_dense(cfg, mesh, train: bool = False) -> bool:
    """Do the reference's rules split a model's dense compute over
    ``mesh``: any family on more than one position, outside the pure-EP
    serving rules (which keep attention whole; they apply to MoE models
    only, so never to the SSM, hybrid and enc-dec families)?"""
    return (mesh is not None and len(mesh.devices) > 1
            and not ep_only(cfg, mesh, train))


def _activation_rules(cfg, mesh, dp_axes: Tuple[str, ...],
                      train: bool = False) -> Dict[str, P]:
    dp = _dp_entry(dp_axes)
    m = MODEL_AXIS
    msize = _axis_size(mesh, m)
    shard_m = msize > 1 and not ep_only(cfg, mesh, train)
    h = cfg.attention.num_heads if cfg.attention else 0
    heads_ok = h > 0 and shard_m and h % msize == 0
    ssm_h = 0
    if cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model if cfg.ssm.kind == "mamba2" \
            else cfg.d_model
        ssm_h = di // cfg.ssm.head_dim
    ssm_ok = ssm_h > 0 and shard_m and ssm_h % msize == 0
    return {
        "residual": P(dp, None, None),
        "kv_cache": P(dp, None, None, None),
        "attn_scores_full": P(dp, m if heads_ok else None, None, None),
        "attn_scores_full_g": P(dp, None, None,
                                m if shard_m else None, None),
        "attn_scores_cache_g": P(dp, None, None, None, None),
        "attn_scores_cache": P(dp, None, None, None),
        "ssm_inner": P(dp, None, m if ssm_ok else None, None),
    }


@contextlib.contextmanager
def activation_constraints(cfg, mesh, dp_axes: Tuple[str, ...],
                           train: bool = False):
    """Install the named-constraint table and the active mesh for the
    duration of a forward."""
    prev = (getattr(_ACTIVE, "rules", None), getattr(_ACTIVE, "mesh", None))
    _ACTIVE.rules = _activation_rules(cfg, mesh, dp_axes, train=train)
    _ACTIVE.mesh = mesh
    try:
        yield
    finally:
        _ACTIVE.rules, _ACTIVE.mesh = prev


def under_current_rules(fn):
    """``fn`` run, wherever and whenever it is called, under the
    activation rules and the mesh active now. A remat recompute runs in
    the backward: after the forward's ``activation_constraints`` closed,
    and on the card in autograd's own thread, where this thread's rules
    are not set; it must choose the attention spelling the forward
    chose."""
    state = (getattr(_ACTIVE, "rules", None), getattr(_ACTIVE, "mesh", None))

    @functools.wraps(fn)
    def run(*args, **kwargs):
        prev = (getattr(_ACTIVE, "rules", None),
                getattr(_ACTIVE, "mesh", None))
        _ACTIVE.rules, _ACTIVE.mesh = state
        try:
            return fn(*args, **kwargs)
        finally:
            _ACTIVE.rules, _ACTIVE.mesh = prev

    return run


def _effective_spec(spec: P, mesh) -> Optional[P]:
    """``spec`` with size-1 mesh axes stripped; None when nothing is
    left (sharding over a size-1 axis is replication)."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if _axis_size(mesh, a) > 1)
        out.append(axes if len(axes) > 1
                   else (axes[0] if axes else None))
    if all(e is None for e in out):
        return None
    return P(*out)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """The reference's sharding constraint, returned as it is: the split
    forwards already hold each activation as the rules place it."""
    return x


def full_grouped_ok(h: int, hkv: int) -> bool:
    """Should the FULL-attention path use the grouped GQA contraction?
    Flat when heads shard evenly over the active mesh's model axis,
    grouped otherwise and outside a mesh context."""
    mesh = getattr(_ACTIVE, "mesh", None)
    if hkv == h:
        return False
    if mesh is None:
        return True
    return not (h % _axis_size(mesh, MODEL_AXIS) == 0)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# 2D weights sharded on the OUTPUT dim (column-parallel)
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "ffn_k", "w_r",
                 "w_k", "w_v", "w_g", "w_in", "ffn_r"}
# 2D weights sharded on the INPUT (reduction) dim (row-parallel)
_ROW_PARALLEL = {"wo", "w_down", "ffn_v", "w_out", "w_o"}
# Embedding/unembedding tables: vocab-sharded (padded_vocab divides)
_VOCAB_SHARDED = {"table"}


def _expert_spec(path: str, shape, msize: int) -> P:
    """Spec for a (stacked) expert-bank leaf: (L, E, ...) arrays, a
    QTensor's ``q``/``scales`` included. EP shards E when it divides the
    model axis, otherwise TP shards the d_ff dim (dim -2 for w_down and
    its scales, dim -1 for up/gate)."""
    if len(shape) < 3:
        return P(*([None] * len(shape)))
    e = shape[1]
    spec = [None] * len(shape)
    if msize > 1 and e % msize == 0:
        spec[1] = MODEL_AXIS                           # EP over experts
        return P(*spec)
    fdim = len(shape) - 2 if "w_down" in path else len(shape) - 1
    if msize > 1 and shape[fdim] % msize == 0:
        spec[fdim] = MODEL_AXIS                        # TP over d_ff
    return P(*spec)


def _leaf_spec(path: str, shape, msize: int) -> P:
    """Megatron-style spec by leaf name; stacked (L, ...) leaves get a
    leading None (layer dims are never sharded)."""
    parts = [p for p in path.split("/") if p]
    last = parts[-1] if parts else ""
    ndim = len(shape)
    if msize <= 1 or ndim == 0:
        return P(*([None] * ndim))
    if "moe" in parts and last != "router":
        return _expert_spec(path, shape, msize)
    if last in _VOCAB_SHARDED and ndim == 2:
        return P(MODEL_AXIS if shape[0] % msize == 0 else None, None)
    if last in _COL_PARALLEL and ndim >= 2:
        spec = [None] * ndim
        if shape[-1] % msize == 0:
            spec[-1] = MODEL_AXIS
        return P(*spec)
    if last in _ROW_PARALLEL and ndim >= 2:
        spec = [None] * ndim
        if shape[-2] % msize == 0:
            spec[-2] = MODEL_AXIS
        return P(*spec)
    return P(*([None] * ndim))


def _walk_specs(tree, msize: int, path: str = ""):
    if isinstance(tree, dict):
        return {k: _walk_specs(v, msize, f"{path}/{k}")
                for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, QTensor):      # one spec per array: packed dims
        return QTensor(q=_leaf_spec(path, tuple(tree.q.shape), msize),
                       scales=_leaf_spec(path, tuple(tree.scales.shape),
                                         msize),
                       bits=tree.bits, group_size=tree.group_size)
    return _leaf_spec(path, tuple(tree.shape), msize)


def param_specs(cfg, mesh, tree) -> Any:
    """Spec tree for a (train- or serve-layout) param tree."""
    return _walk_specs(tree, _axis_size(mesh, MODEL_AXIS))


@dataclasses.dataclass(frozen=True)
class Placement:
    """``jax.sharding.NamedSharding``: a spec over a mesh."""
    mesh: Any
    spec: P


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, QTensor):
        return QTensor(q=fn(tree.q), scales=fn(tree.scales),
                       bits=tree.bits, group_size=tree.group_size)
    return fn(tree)


def shardings(mesh, spec_tree) -> Any:
    """A spec tree as a placement tree on ``mesh``."""
    return _map_specs(lambda s: Placement(mesh, P(*s)), spec_tree)


def param_shardings(cfg, mesh, tree) -> Any:
    """Placement tree (same structure as ``tree``)."""
    return shardings(mesh, param_specs(cfg, mesh, tree))


# ---------------------------------------------------------------------------
# Sharded storage
# ---------------------------------------------------------------------------

def coords(mesh, pos: int) -> Dict[str, int]:
    """Axis name -> index of mesh position ``pos`` (row-major)."""
    idx = np.unravel_index(pos, mesh.shape)
    return {a: int(i) for a, i in zip(mesh.axis_names, idx)}


@dataclasses.dataclass(frozen=True)
class _Layout:
    counts: Tuple[int, ...]                  # shards per dim
    index: Tuple[Tuple[int, ...], ...]       # per position: block index
    groups: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]
    # (block index, the positions holding it in row-major order), one per
    # distinct shard in block order; the first position is the
    # representative the updates run on

    def block(self, shape, idx) -> Tuple[slice, ...]:
        return tuple(slice(i * (n // c), (i + 1) * (n // c))
                     for i, n, c in zip(idx, shape, self.counts))


@functools.lru_cache(maxsize=None)
def _layout(placement: Placement, shape: Tuple[int, ...]) -> _Layout:
    mesh, spec = placement.mesh, placement.spec
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dims than shape {shape}")
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    counts = []
    for n, e in zip(shape, entries):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        c = math.prod(_axis_size(mesh, a) for a in axes)
        if n % c:
            raise ValueError(f"dim of {n} does not split over {axes} "
                             f"({c}) in spec {spec}")
        counts.append(c)
    index = []
    for pos in range(len(mesh.devices)):
        at = coords(mesh, pos)
        idx = []
        for e in entries:
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            i = 0
            for a in axes:
                i = i * _axis_size(mesh, a) + at.get(a, 0)
            idx.append(i)
        index.append(tuple(idx))
    groups: Dict[Tuple[int, ...], list] = {}
    for pos, idx in enumerate(index):
        groups.setdefault(idx, []).append(pos)
    return _Layout(tuple(counts), tuple(index),
                   tuple((k, tuple(groups[k])) for k in sorted(groups)))


def _copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` (always new storage)."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


class Sharded:
    """A tensor of global ``shape`` stored as one shard per mesh position
    of ``placement``: ``shards[p]`` is the block the spec gives position
    ``p``, on ``mesh.devices[p]``."""
    __slots__ = ("placement", "shape", "shards")

    def __init__(self, placement: Placement, shape, shards):
        self.placement = placement
        self.shape = tuple(shape)
        self.shards = list(shards)

    @property
    def mesh(self):
        return self.placement.mesh

    @property
    def spec(self) -> P:
        return self.placement.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        """The home device, ``mesh.devices[0]``, where gathers land."""
        return self.mesh.devices[0]

    @property
    def layout(self) -> _Layout:
        return _layout(self.placement, self.shape)

    def distinct(self):
        """The representative shard of each distinct block, in block
        order: every element of the tensor once."""
        return [self.shards[pos[0]] for _, pos in self.layout.groups]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: home), assembled from
        the representatives; differentiable. A tensor with one distinct
        block already on ``device`` is that shard itself."""
        device = self.device if device is None else torch.device(device)
        lay = self.layout
        rep = {idx: self.shards[pos[0]] for idx, pos in lay.groups}

        def build(prefix, dim):
            if dim == self.ndim:
                return rep[prefix].to(device)
            pieces = [build(prefix + (k,), dim + 1)
                      for k in range(lay.counts[dim])]
            return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

        with OC.at_position(0):          # the gather lands on the home
            out = build((), 0)
        if OC.counting() and len(lay.groups) > 1:
            _book_gather(out, {pos[0]: OC.nbytes(self.shards[pos[0]])
                               for _, pos in lay.groups})
        return out

    @torch.no_grad()
    def assign(self, value: torch.Tensor) -> None:
        """Write the whole tensor ``value`` into every position's shard
        (a shard that is ``value`` itself is left as it is)."""
        lay = self.layout
        for pos, idx in enumerate(lay.index):
            if self.shards[pos] is not value:
                self.shards[pos].copy_(value[lay.block(self.shape, idx)])

    @torch.no_grad()
    def sync(self) -> None:
        """Copy each representative into its replicas."""
        for _, pos in self.layout.groups:
            src = self.shards[pos[0]]
            for p in pos[1:]:
                if self.shards[p] is not src:
                    self.shards[p].copy_(src)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.shape})")


def _book_gather(out: torch.Tensor, blocks: Dict[int, int]) -> None:
    """Book an all-gather of the representatives' ``blocks`` (position ->
    bytes) into ``out`` at the home (position 0), and, when ``out`` takes a
    gradient, the scatter of its blocks' gradients back to them."""
    whole_b = OC.nbytes(out)
    OC.collective("all-gather", {0: whole_b}, blocks)
    if out.requires_grad:
        out.register_hook(
            lambda g: OC.collective("scatter", blocks, {0: whole_b}))


def shard(x, placement: Placement) -> Sharded:
    """``jax.device_put(x, NamedSharding)``: each position's block of
    ``x`` (a tensor anywhere, or a :class:`Sharded` to reshard) copied to
    its device."""
    if isinstance(x, Sharded):
        x = x.full()
    x = x.detach()
    lay = _layout(placement, tuple(x.shape))
    shards = []
    for p, (idx, dev) in enumerate(zip(lay.index, placement.mesh.devices)):
        with OC.at_position(p):
            shards.append(_copy_to(x[lay.block(x.shape, idx)], dev))
    return Sharded(placement, x.shape, shards)


def shard_tree(tree, placements):
    """Every tensor leaf of ``tree`` stored by its placement (a tree of
    the same structure; QTensors map over ``q`` and ``scales``)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, placements[k]) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, QTensor):
        return QTensor(q=shard(tree.q, placements.q),
                       scales=shard(tree.scales, placements.scales),
                       bits=tree.bits, group_size=tree.group_size)
    return shard(tree, placements)


def has_sharded(tree) -> bool:
    if isinstance(tree, dict):
        return any(has_sharded(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return isinstance(tree.q, Sharded)
    return isinstance(tree, Sharded)


def gather(tree, device):
    """Every :class:`Sharded` leaf of ``tree`` whole on ``device``."""
    if isinstance(tree, dict):
        return {k: gather(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.map(lambda t: gather(t, device))
    return tree.full(device) if isinstance(tree, Sharded) else tree


def at_position(tree, pos: int):
    """``tree`` with each :class:`Sharded` leaf replaced by its shard at
    mesh position ``pos``."""
    if isinstance(tree, dict):
        return {k: at_position(v, pos) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.map(lambda t: at_position(t, pos))
    return tree.shards[pos] if isinstance(tree, Sharded) else tree


def distinct(x):
    """The distinct shards of a leaf (a plain tensor is its own)."""
    return x.distinct() if isinstance(x, Sharded) else [x]


def value(x) -> torch.Tensor:
    """A replicated leaf's value (a plain tensor is its own)."""
    return x.shards[0] if isinstance(x, Sharded) else x


def replicate(v: torch.Tensor, like):
    """``v`` replicated over ``like``'s mesh (``P()``), or ``v`` itself
    when ``like`` is a plain tensor. Position 0 holds ``v``."""
    if not isinstance(like, Sharded):
        return v
    devs = like.mesh.devices
    shards = [v]
    for i, d in enumerate(devs[1:], 1):
        with OC.at_position(i):
            shards.append(_copy_to(v, d))
    return Sharded(Placement(like.mesh, P()), v.shape, shards)


def zeros(x, dtype: torch.dtype = torch.float32, drop: Optional[int] = None):
    """f32 zeros shaped and placed like leaf ``x``; ``drop`` removes one
    dim (and its spec entry): Adafactor's factored moments."""
    shape = tuple(x.shape)
    if drop is not None:
        drop %= len(shape)
        shape = shape[:drop] + shape[drop + 1:]
    if not isinstance(x, Sharded):
        return torch.zeros(shape, dtype=dtype, device=x.device)
    spec = tuple(x.spec) + (None,) * (x.ndim - len(x.spec))
    if drop is not None:
        spec = spec[:drop] + spec[drop + 1:]
    placement = Placement(x.mesh, P(*spec))
    lay = _layout(placement, shape)
    shards = []
    for p, (idx, dev) in enumerate(zip(lay.index, x.mesh.devices)):
        with OC.at_position(p):
            shards.append(torch.zeros(
                tuple(s.stop - s.start for s in lay.block(shape, idx)),
                dtype=dtype, device=dev))
    return Sharded(placement, shape, shards)


def per_shard(fn):
    """``fn`` over each distinct shard of its :class:`Sharded` arguments
    (which share one placement; other arguments pass as they are), on the
    representatives only; replicas of an argument ``fn`` changed in place
    are then synced, and a tensor result comes back sharded like the
    arguments. For elementwise updates."""
    @functools.wraps(fn)
    def apply(*args):
        sh = [a for a in args if isinstance(a, Sharded)]
        if not sh:
            return fn(*args)
        first = sh[0]
        if any(a.placement != first.placement for a in sh):
            raise ValueError("per_shard: arguments placed differently")
        groups = first.layout.groups
        seen = [[a.shards[pos[0]]._version for _, pos in groups]
                for a in sh]
        outs = []
        for _, pos in groups:
            with OC.at_position(pos[0]):
                outs.append(fn(*(a.shards[pos[0]] if isinstance(a, Sharded)
                                 else a for a in args)))
        for a, vers in zip(sh, seen):
            if any(a.shards[pos[0]]._version != v
                   for (_, pos), v in zip(groups, vers)):
                a.sync()
        if all(o is None for o in outs):
            return None
        shards = [None] * len(first.shards)
        devs = first.mesh.devices
        for out, (_, pos) in zip(outs, groups):
            shards[pos[0]] = out
            for p in pos[1:]:
                with OC.at_position(p):
                    shards[p] = _copy_to(out, devs[p])
        return Sharded(first.placement, first.shape, shards)
    return apply


def whole(fn):
    """``fn`` on whole tensors: each :class:`Sharded` argument (also
    inside dict arguments) is gathered on its home device, ``fn`` runs
    once, every gathered tensor ``fn`` changed in place is written back
    to all its positions, and a tensor result is sharded like the first
    sharded argument. For updates with reductions over a whole tensor
    (Adafactor's factored moments, int8 absmax scales)."""
    @functools.wraps(fn)
    def apply(*args):
        taken = []

        def pull(a):
            if isinstance(a, dict):
                return {k: pull(v) for k, v in a.items()}
            if isinstance(a, Sharded):
                g = a.full()
                taken.append((a, g, g._version))
                return g
            return a

        call = [pull(a) for a in args]
        if not taken:
            return fn(*args)
        out = fn(*call)
        for a, g, v in taken:
            if g._version != v:
                a.assign(g)
        if isinstance(out, torch.Tensor):
            return shard(out, taken[0][0].placement)
        return out
    return apply


def sum_replicas(x: Sharded) -> Sharded:
    """Per-position partial values (``None`` = zero) -> one value per
    distinct shard: the replicas' sum in f32 in position order, rounded
    once to the dtype (what the reference's bf16 ``psum`` over replicas
    gives on XLA:CPU), at every position of the group."""
    devs = x.mesh.devices
    shards = [None] * len(x.shards)
    moved: Dict[int, int] = {}
    for _, pos in x.layout.groups:
        held = [p for p in pos if x.shards[p] is not None]
        if not held:
            raise ValueError("sum_replicas: no position holds a value")
        parts = [x.shards[p] for p in held]
        with OC.at_position(held[0]):
            if len(parts) == 1:
                out = parts[0]
            else:
                dev = parts[0].device
                acc = parts[0].to(torch.float32)
                for t in parts[1:]:
                    acc = acc + t.to(dev, torch.float32)
                out = acc.to(parts[0].dtype)
        for p in pos:
            with OC.at_position(p):
                shards[p] = out if devs[p] == out.device \
                    else out.to(devs[p])
        if len(pos) > 1:
            moved.update(dict.fromkeys(pos, OC.nbytes(out)))
    if moved:                  # each replica group's all-reduce, booked once
        OC.collective("all-reduce", moved, moved)
    return Sharded(x.placement, x.shape, shards)


# ---------------------------------------------------------------------------
# The split dense path: who holds what, and the collectives between
# ---------------------------------------------------------------------------

class Split:
    """The positions of ``mesh`` as the split dense path uses them: the
    batch rows split over ``dp_axes`` (position ``p`` holds data rank
    ``dp[p]``'s rows; positions with the same rows are replicas), and
    ``rank[p]`` its index on the model axis. ``model_groups`` are the
    positions that differ only along "model", each in rank order (the
    closing sums run over them); ``lead`` is the first position of each
    data rank, in data-rank order (the loss is summed over them)."""

    def __init__(self, mesh, dp_axes: Tuple[str, ...]):
        self.mesh = mesh
        self.dp_axes = tuple(a for a in dp_axes if a in mesh.sizes)
        self.devices = mesh.devices
        self.n = len(mesh.devices)
        self.n_dp = math.prod(_axis_size(mesh, a) for a in self.dp_axes)
        self.msize = _axis_size(mesh, MODEL_AXIS)
        at = [coords(mesh, p) for p in range(self.n)]
        self.dp = []
        for c in at:
            i = 0
            for a in self.dp_axes:
                i = i * _axis_size(mesh, a) + c[a]
            self.dp.append(i)
        self.rank = [c.get(MODEL_AXIS, 0) for c in at]
        self.model_groups = self.groups(MODEL_AXIS)
        lead: Dict[int, int] = {}
        for p in range(self.n):
            lead.setdefault(self.dp[p], p)
        self.lead = [lead[i] for i in range(self.n_dp)]

    def groups(self, axis: str) -> Tuple[Tuple[int, ...], ...]:
        """The positions that differ only along ``axis``, one group per
        setting of the other axes, each in that axis's order."""
        at = [coords(self.mesh, p) for p in range(self.n)]
        out: Dict[Tuple, list] = {}
        for p, c in enumerate(at):
            out.setdefault(tuple(v for a, v in sorted(c.items())
                                 if a != axis), []).append(p)
        return tuple(tuple(g) for g in out.values())

    @property
    def batch_entry(self):
        """The spec entry of the batch dim."""
        return _dp_entry(self.dp_axes)

    def each(self, fn, *lists):
        """``[fn(p, lists[0][p], ...) for p]``, each call's ops charged
        to its position."""
        out = []
        for p in range(self.n):
            with OC.at_position(p):
                out.append(fn(p, *(a[p] for a in lists)))
        return out


@functools.lru_cache(maxsize=None)
def split_of(mesh, dp_axes: Tuple[str, ...]) -> Split:
    return Split(mesh, tuple(dp_axes))


def rows(x, split: Split):
    """Each position's data-rank rows of an input whose dim 0 is the
    batch: a :class:`Sharded` placed over the split's batch axes gives
    its shards; a tensor is scattered from its device (booked as a
    ``scatter`` from position 0)."""
    if isinstance(x, Sharded):
        if x.spec[:1] != (split.batch_entry,) or x.mesh != split.mesh:
            raise ValueError(f"input placed by {x.spec}, not split over "
                             f"{split.dp_axes}")
        return list(x.shards)
    b = x.shape[0]
    if b % split.n_dp:
        raise ValueError(f"batch of {b} does not split over {split.n_dp} "
                         f"data ranks ({split.dp_axes})")
    loc = b // split.n_dp
    out = split.each(lambda p: _copy_to(
        x[split.dp[p] * loc:(split.dp[p] + 1) * loc], split.devices[p]))
    if OC.counting():
        got = {p: OC.nbytes(t) for p, t in enumerate(out)}
        OC.collective("scatter", got, {0: sum(got.values())})
    return out


class Owner:
    """A call of one batch row, which does not split over the data ranks
    (the engine's slot prefill: batch 1, S the power-of-two bucket),
    placed as the reference's GSPMD places it:

    * the dense compute (embedding, attention, norms, router, head) runs
      the row at data rank ``r``'s model group (``group``, in model-rank
      order) only, heads and vocab slices split over model as in the
      batched split, its model-axis sums in rank order: :attr:`sub` is
      that group as a :class:`Split` of a (1, m) mesh, whose position
      ``i`` is global position ``group[i]``. Its model ranks hold
      bit-equal copies of the row, as a data rank's positions do;
    * the MoE's S tokens split over every data rank (:meth:`spread`):
      data rank ``i``'s positions get token block ``i`` from the group's
      position of their own model rank, so the token-gather regime's
      d_ff slices, which live on different data ranks, each see their
      tokens, as ``shard_map`` splits the flattened B*S tokens; where S
      does not divide by the data ranks (a bucket cut to a KV window),
      the tokens are padded to a multiple of them with idle rows (the
      sentinel expert id, zero weight), as the reference's GSPMD pads;
    * each token block's output comes back to the group (:meth:`collect`),
      concatenated in data-rank order at every model rank's position and
      cut back to the S tokens.

    The other data ranks run only their share of the MoE."""

    def __init__(self, split: Split, r: int):
        self.split = split
        self.group = next(g for g in split.model_groups
                          if split.dp[g[0]] == r)
        devs = tuple(split.devices[p] for p in self.group)
        self.sub = split_of(type(split.mesh)((1, len(devs)),
                                             ("data", MODEL_AXIS), devs),
                            ("data",))
        # (data rank, model rank) -> its first position
        self._at: Dict[Tuple[int, int], int] = {}
        for p in range(split.n):
            self._at.setdefault((split.dp[p], split.rank[p]), p)

    def spread(self, parts, fill=0):
        """The group's copies (one per model rank, dim 0 the tokens) ->
        each mesh position's block of its data rank (dim 0, padded with
        rows of ``fill`` to a multiple of ``split.n_dp``, split in that
        many blocks), copied from its model rank's copy."""
        s = self.split
        t = parts[0].shape[0]
        loc = -(-t // s.n_dp)

        def block(p):
            x = parts[s.rank[p]][s.dp[p] * loc:(s.dp[p] + 1) * loc]
            out = torch.full((loc,) + tuple(x.shape[1:]), fill,
                             dtype=x.dtype, device=s.devices[p])
            out[:x.shape[0]].copy_(x)
            return out
        out = s.each(block)
        if OC.counting():
            OC.collective("scatter", {p: OC.nbytes(v)
                                      for p, v in enumerate(out)},
                          {q: OC.nbytes(parts[i])
                           for i, q in enumerate(self.group)})
        return out

    def collect(self, parts, rows: int):
        """Each mesh position's block -> at each group position the
        blocks of its model rank, concatenated in data-rank order, its
        first ``rows`` (the tokens :meth:`spread` was given)."""
        s = self.split
        out = []
        for i, q in enumerate(self.group):
            with OC.at_position(q):
                out.append(torch.cat([
                    parts[self._at[(d, s.rank[q])]].to(s.devices[q])
                    for d in range(s.n_dp)])[:rows])
        if OC.counting():
            OC.collective("all-gather", {q: OC.nbytes(v)
                                         for q, v in zip(self.group, out)},
                          {p: OC.nbytes(v) for p, v in enumerate(parts)})
        return out


def rank_sum(parts, device, dtype=None) -> torch.Tensor:
    """A bf16 ``psum`` as XLA:CPU runs it: ``parts`` summed in f32 in
    rank order on ``device``, rounded once to ``dtype`` (default: the
    parts' dtype)."""
    acc = parts[0].to(device, torch.float32)
    for t in parts[1:]:
        acc = acc + t.to(device, torch.float32)
    return acc.to(parts[0].dtype if dtype is None else dtype)


def _book_all(kind: str, outs, parts) -> None:
    if OC.counting():
        OC.collective(kind, {p: OC.nbytes(t) for p, t in enumerate(outs)
                             if t is not None},
                      {p: OC.nbytes(t) for p, t in enumerate(parts)
                       if t is not None})


def _sizes(n: int, m: int):
    """The lengths of ``m`` contiguous pieces of ``n`` (differing by at
    most one)."""
    base, extra = divmod(n, m)
    return [base + (j < extra) for j in range(m)]


def _piece_sums(groups, devices, parts, like):
    """A reduce-scatter: rank j of each group gets piece j (of one per
    rank, along the last dim) of the group's rank-order f32 sum of
    ``parts`` (``None`` = zero), rounded once to ``like[p]``. Each part is
    cut into its pieces in one op, and rank j sums piece j over the
    group's parts (:func:`rank_sum`)."""
    outs = [None] * len(parts)
    for g in groups:
        held = [q for q in g if parts[q] is not None]
        if not held:
            continue
        sizes = _sizes(parts[held[0]].shape[-1], len(g))
        pieces = {}
        for q in held:
            with OC.at_position(q):
                pieces[q] = parts[q].to(torch.float32).split(sizes, -1)
        for i, p in enumerate(g):
            with OC.at_position(p):
                outs[p] = rank_sum([pieces[q][i] for q in held],
                                   devices[p], like[p])
    return outs


def _group_sums(groups, devices, parts, like):
    """Every position's copy of its group's rank-order f32 sum of
    ``parts`` (``None`` = zero), rounded once to ``like[p]``: a ring
    all-reduce's reduce-scatter (:func:`_piece_sums`) and all-gather, each
    position concatenating the pieces in rank order. Every element is the
    same sequence of f32 adds whichever position made it, so the copies
    are bit-equal."""
    sums = _piece_sums(groups, devices, parts, like)
    outs = [None] * len(parts)
    for g in groups:
        if sums[g[0]] is None:
            continue
        for p in g:
            with OC.at_position(p):
                outs[p] = torch.cat([sums[q].to(devices[p]) for q in g], -1)
    return outs


class _AllReduce(torch.autograd.Function):
    """Every position's sum of its group's parts, in f32 in rank order,
    rounded once (:func:`_group_sums`), so the replicas of a data rank's
    rows stay bit-equal. The backward is the same sum of the gradients:
    never autograd's adds in order of arrival."""

    @staticmethod
    def forward(ctx, groups, devices, *parts):
        ctx.groups, ctx.devices = groups, devices
        ctx.like = [t.dtype for t in parts]
        outs = _group_sums(groups, devices, parts, ctx.like)
        _book_all("all-reduce", outs, parts)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        out = _group_sums(ctx.groups, ctx.devices, grads, ctx.like)
        _book_all("all-reduce", out, grads)
        return (None, None, *out)


class _ReduceScatter(torch.autograd.Function):
    """Each position's piece of its group's sum of the parts (one piece
    per rank along the last dim, :func:`_piece_sums`); the backward
    all-gathers the pieces' gradients in rank order."""

    @staticmethod
    def forward(ctx, groups, devices, *parts):
        ctx.groups, ctx.devices = groups, devices
        outs = _piece_sums(groups, devices, parts, [t.dtype for t in parts])
        _book_all("reduce-scatter", outs, parts)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        out = [None] * len(grads)
        for g in ctx.groups:
            for p in g:
                with OC.at_position(p):
                    out[p] = torch.cat([grads[q].to(ctx.devices[p])
                                        for q in g], -1)
        _book_all("all-gather", out, grads)
        return (None, None, *out)


class _AllGather(torch.autograd.Function):
    """Every position's concatenation of its group's parts along ``dim``
    in rank order; the backward reduce-scatters the gradients (each
    part's slice summed over the group in f32 in rank order)."""

    @staticmethod
    def forward(ctx, groups, devices, dim, *parts):
        ctx.groups, ctx.devices, ctx.dim = groups, devices, dim
        ctx.like = [t.dtype for t in parts]
        ctx.at = {}
        outs = [None] * len(parts)
        for g in groups:
            off = 0
            for q in g:
                ctx.at[q] = (off, parts[q].shape[dim])
                off += parts[q].shape[dim]
            for p in g:
                with OC.at_position(p):
                    outs[p] = torch.cat([parts[q].to(devices[p])
                                         for q in g], dim)
        _book_all("all-gather", outs, parts)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        out = [None] * len(grads)
        for g in ctx.groups:
            for q in g:
                parts = [grads[p].narrow(ctx.dim, *ctx.at[q])
                         for p in g if grads[p] is not None]
                if parts:
                    with OC.at_position(q):
                        out[q] = rank_sum(parts, ctx.devices[q], ctx.like[q])
        _book_all("reduce-scatter", out, grads)
        return (None, None, None, *out)


class _FanOut(torch.autograd.Function):
    """``n`` aliases of ``x`` whose gradients are added in their order.
    A tensor read by several ops gets their gradients in the order they
    finish; with positions on distinct cards that order follows the
    other cards' threads, and three or more bf16 terms then round
    differently from run to run."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        acc = None
        for g in grads:
            if g is not None:
                acc = g if acc is None else acc + g
        return acc, None


def fan_out(x: torch.Tensor, n: int):
    """``x`` for ``n`` readers (:class:`_FanOut` while it takes a
    gradient, else ``x`` itself ``n`` times)."""
    if not x.requires_grad:
        return (x,) * n
    return _FanOut.apply(x, n)


def all_reduce(parts, groups, devices):
    """Per-position partial values (one per position) -> each position's
    sum over its group (see :class:`_AllReduce`); groups of one are
    returned as they are."""
    if all(len(g) == 1 for g in groups):
        return list(parts)
    return list(_AllReduce.apply(tuple(groups), tuple(devices), *parts))


def reduce_scatter(parts, groups, devices):
    """Per-position partial values -> each position's piece (its rank's
    of one per rank, along the last dim) of its group's sum (see
    :class:`_ReduceScatter`); groups of one are returned as they are."""
    if all(len(g) == 1 for g in groups):
        return list(parts)
    return list(_ReduceScatter.apply(tuple(groups), tuple(devices), *parts))


def all_gather(parts, groups, devices, dim: int):
    """Per-position shards -> each position's concatenation of its
    group's shards along ``dim`` (see :class:`_AllGather`)."""
    if all(len(g) == 1 for g in groups):
        return list(parts)
    return list(_AllGather.apply(tuple(groups), tuple(devices), dim,
                                 *parts))


def to_lead(parts, split: Split, dim: int):
    """Each data rank's model group's shards concatenated along ``dim``
    at the group's first position (a gather in rank order): one tensor
    per data rank, in data-rank order."""
    out, moved = [], {}
    for lead in split.lead:
        g = next(g for g in split.model_groups if g[0] == lead)
        with OC.at_position(lead):
            out.append(parts[lead] if len(g) == 1 else torch.cat(
                [parts[q].to(split.devices[lead]) for q in g], dim))
        if len(g) > 1:
            moved[lead] = OC.nbytes(out[-1])
    if moved and OC.counting():
        OC.collective("all-gather", moved, {
            q: OC.nbytes(parts[q]) for g in split.model_groups
            if g[0] in moved for q in g})
    return out


def cache_spec(shape, batch: int, lead) -> P:
    """A decode cache leaf's spec (the reference's ``cache_specs`` rule):
    the batch dim of an (L, B, ...) stack (dim 1 where it equals the
    batch) or else of a (B, ...) leaf (Seamless's ``enc_out``) over the
    batch axes, the rest replicated: every model rank of a data rank holds
    all the heads, channels and states of its rows."""
    spec = [None] * len(shape)
    if len(shape) >= 2 and shape[1] == batch:
        spec[1] = lead
    elif len(shape) >= 1 and shape[0] == batch:
        spec[0] = lead
    return P(*spec)


# ---------------------------------------------------------------------------
# IO specs for the dry run (the reference's launch/dryrun.py)
# ---------------------------------------------------------------------------

def input_specs(cfg, shape, mesh):
    """(inputs as ``meta`` tensors, placements) for one dry-run cell;
    ``shape`` has ``kind``, ``global_batch`` and ``seq_len``."""
    dp = batch_axes(mesh, shape.global_batch)
    lead = _dp_entry(dp)
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    def ns(*spec):
        return Placement(mesh, P(*spec))

    if shape.kind == "decode":
        return ({"tokens": meta((b, 1)), "positions": meta((b,))},
                {"tokens": ns(lead, None), "positions": ns(lead)})
    inp = {"tokens": meta((b, s)), "labels": meta((b, s))}
    sh = {"tokens": ns(lead, None), "labels": ns(lead, None)}
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        inp["src"] = meta((b, cfg.frontend_len or s, cfg.d_model), dtype)
        sh["src"] = ns(lead, None, None)
    if cfg.frontend == "vision":
        inp["frontend"] = meta((b, cfg.frontend_len, cfg.d_model), dtype)
        sh["frontend"] = ns(lead, None, None)
    return inp, sh


def cache_specs(cfg, shape, mesh):
    """(the decode cache as ``meta`` tensors, placements). Caches shard
    over the batch dim only."""
    from repro_torch.models.model import init_cache  # deferred: a cycle
    lead = _dp_entry(batch_axes(mesh, shape.global_batch))
    b = shape.global_batch
    cache = init_cache(cfg, b, shape.seq_len, device="meta")
    return cache, _map_specs(
        lambda leaf: Placement(mesh, cache_spec(leaf.shape, b, lead)), cache)
