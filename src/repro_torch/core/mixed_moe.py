"""Mixed-precision MoE layer: N expert banks (one per ladder
rung, e.g. int4 | int8 | bf16), the capacity-bounded local dispatch, and
its regimes over a device mesh.

The paper's partial expert quantization turns each MoE layer into per-rung
banks — ``q4`` (packed int4 + scales), ``q8`` (int8 + scales) and ``f16``
(bf16) — in ASCENDING-bits bank order, with a per-layer expert permutation
mapping routed ids into bank slots (``PrecisionPlan.expert_order``).

Dispatch (the reference's ``repro.core.mixed_moe``):

  * one device (``par=None``, or a mesh of one position): rank 0 of an EP
    group of one, every expert local, no collective;
  * a (data, model) mesh (``MoEParallelism``): one process drives every
    position, and ``moe_apply`` runs the reference's shard_map body per
    position on that position's device with its collectives spelled
    out: the token-gather, data x EP and TP regimes (see
    :func:`moe_apply`). Each closing sum runs in f32 in rank order and
    rounds once to the outputs' dtype: that is what the reference's bf16
    ``psum`` and ``psum_scatter`` give on XLA:CPU (a running bf16 sum
    over 4 or 8 ranks is not). A token's expert output is computed by
    exactly one model rank where the regime does not split d_ff, and the
    other ranks add exact zeros, so at top-2 data x EP and the (1, ep)
    serving mesh are bit-identical to one device; at top-k > 2 a token's
    outputs on one rank are summed there first, so the result is
    bit-identical to the reference's, not to one device. Token-gather
    and TP sum partial d_ff products, whose bf16 rounding differs from
    one device's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.quantization import QTensor, dequantize, quantize
from repro_torch.dist import sharding as SH
from repro_torch.kernels import ops
from repro_torch.roofline import op_count as OC

# --------------------------------------------------------------------------
# Routing
# --------------------------------------------------------------------------

_TRACE = threading.local()


class capture_routing:
    """Collect the routing ids (numpy, one (T, k) array per MoE layer call)
    of the forwards run inside the ``with`` block."""

    def __enter__(self):
        _TRACE.ids = []
        return _TRACE.ids

    def __exit__(self, *exc):
        _TRACE.ids = None


class capture_moe_inputs:
    """Collect each MoE layer's router inputs from the forwards run inside
    the ``with`` block: one ``(x (T,d) f32, probs (T,E) f32)`` pair of
    host numpy arrays per layer, in layer order. The sensitivity
    calibration (core/sensitivity.py, DESIGN.md §15) replays the captured
    tokens through each expert's FFN at every ladder rung."""

    def __enter__(self):
        _TRACE.moe = []
        return _TRACE.moe

    def __exit__(self, *exc):
        _TRACE.moe = None


def route(router_w: torch.Tensor, x: torch.Tensor, moe: MoEConfig, *,
          aux: Optional[Dict[str, torch.Tensor]] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (weights (T,k) f32, ids (T,k) int64). ``aux`` (the
    training forward) accumulates the Switch-style load-balance and
    router-z losses into the given dict."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, ids = torch.topk(probs, moe.top_k, dim=-1)
    trace = getattr(_TRACE, "ids", None)
    if trace is not None:
        trace.append(ids.cpu().numpy().astype(np.int32))
    moe_trace = getattr(_TRACE, "moe", None)
    if moe_trace is not None:
        moe_trace.append((x.detach().to(torch.float32).cpu().numpy(),
                          probs.detach().cpu().numpy()))
    if aux is not None:
        e = moe.num_experts
        # one-hot by comparison: F.one_hot checks the ids' range on the
        # host, which a meta tensor cannot and the card does not do
        dispatch = (ids[..., None] == torch.arange(e, device=ids.device)
                    ).to(torch.float32).sum(1)                      # (T,E)
        lb = moe.load_balance_loss * e * torch.sum(
            dispatch.mean(0) * probs.mean(0))
        lse = torch.logsumexp(logits, dim=-1)
        z = moe.router_z_loss * torch.mean(lse ** 2)
        aux["load_balance"] = aux.get("load_balance", 0.0) + lb
        aux["router_z"] = aux.get("router_z", 0.0) + z
    weights = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return weights, ids


# --------------------------------------------------------------------------
# Local dispatch: sort -> capacity scatter -> FFN -> weighted combine.
# --------------------------------------------------------------------------

def _bank_bits(name: str) -> int:
    """Bank key -> bit-width: 'f16' -> 16, 'qN' -> N."""
    return 16 if name == "f16" else int(name[1:])


def _bank_name(bits: int) -> str:
    return "f16" if bits >= 16 else f"q{bits}"


def bank_keys(banks) -> list:
    """Non-empty bank keys in ascending-bits BANK ORDER (the expert
    storage order: cheapest rung first — binary: ['q4', 'f16'])."""
    return sorted((k for k in banks if banks.get(k) is not None),
                  key=_bank_bits)


def _local_slot(flat_e, *, rank, totals, locs):
    """Map global (permuted) expert ids to this rank's local bank slots.

    ``totals``/``locs`` are per-bank global/per-rank expert counts in
    bank order. Within bank b (global offset O_b), rank r owns experts
    [O_b + r*loc_b, O_b + (r+1)*loc_b) -> local slots
    [sum(loc_<b), sum(loc_<b) + loc_b). Returns (slot, is_local)."""
    slot = torch.zeros_like(flat_e)
    ok = torch.zeros(flat_e.shape, dtype=torch.bool, device=flat_e.device)
    g_off = l_off = 0
    for tot, loc in zip(totals, locs):
        rel = flat_e - g_off - rank * loc
        in_bank = (flat_e >= g_off) & (flat_e < g_off + tot)
        bank_ok = in_bank & (rel >= 0) & (rel < loc)
        slot = torch.where(bank_ok, l_off + rel, slot)
        ok = ok | bank_ok
        g_off += tot
        l_off += loc
    return slot, ok


def bucket_starts(sorted_e: torch.Tensor, n: int) -> torch.Tensor:
    """The first index of each value ``0..n-1`` in the sorted ids
    ``sorted_e``: ``cumsum(bincount(sorted_e, minlength=n)) - bincount``,
    exact integers, with a shape that does not depend on the data (the
    length of ``bincount``'s output does, so it has no ``meta`` kernel)."""
    return torch.searchsorted(sorted_e, torch.arange(
        n, dtype=sorted_e.dtype, device=sorted_e.device))


def _dispatch_local(x, ids, weights, *, rank, totals, locs, capacity):
    """Pack routed tokens into (e_loc, capacity, d); returns buffers +
    metadata needed for the combine. Dropped assignments (over capacity,
    or ids outside this rank's banks, e.g. the invalid-token sentinel)
    point at one extra buffer row that is cut off, which stands in for the
    reference's scatter ``mode="drop"``."""
    t, d = x.shape
    e_loc = sum(locs)
    k = ids.shape[1]
    flat_e = ids.reshape(-1)                                  # (T*k,)
    flat_w = weights.reshape(-1)
    local_e, is_local = _local_slot(flat_e, rank=rank, totals=totals,
                                    locs=locs)
    key = torch.where(is_local, local_e, torch.full_like(local_e, e_loc))
    order = torch.argsort(key, stable=True)                   # (T*k,)
    sorted_e = key[order]
    starts = bucket_starts(sorted_e, e_loc + 1)
    pos = torch.arange(t * k, device=x.device) - starts[sorted_e]
    valid = (sorted_e < e_loc) & (pos < capacity)
    drop = e_loc * capacity
    dest = torch.where(valid, sorted_e * capacity + pos,
                       torch.full_like(pos, drop))
    # x[order // k], spelled as a permutation of the k copies of each row
    # so that the backward adds no two rows into one (a scatter-add of
    # repeated rows has no fixed order; the sum over the copies does)
    rows = x[:, None].expand(t, k, d).reshape(t * k, d)[order]
    xbuf = torch.zeros((drop + 1, d), dtype=x.dtype, device=x.device)
    xbuf[dest] = rows
    return xbuf[:drop].reshape(e_loc, capacity, d), dest, order, \
        flat_w[order]


def _combine_local(ybuf, dest, order, w_sorted, t, d, k):
    """Weighted combine. The reference scatter-adds the (T*k) sorted
    contributions into zeros one after another, so each token's sum runs
    in sorted (expert) order. Here each token's k contributions are
    gathered into that order and summed in it (deterministic on CUDA,
    where ``index_add_`` is atomic), so the bf16 sums are bit-equal to
    the reference's at any top-k."""
    flat = ybuf.reshape(-1, ybuf.shape[-1])
    flat = torch.cat([flat, flat.new_zeros((1, flat.shape[-1]))])
    contrib = flat[dest]                       # dropped -> the zero row
    contrib = contrib * w_sorted[:, None].to(contrib.dtype)
    # token-major, sorted order within a token: a stable sort of the
    # sorted entries by token; ``grouped[slot] = contrib`` (not a gather
    # by ``by_token``) keeps the backward a gather
    by_token = torch.argsort(order // k, stable=True)
    slot = torch.empty_like(by_token)
    slot[by_token] = torch.arange(t * k, device=by_token.device)
    grouped = torch.empty_like(contrib)
    grouped[slot] = contrib
    grouped = grouped.reshape(t, k, d)
    y = torch.zeros((t, d), dtype=ybuf.dtype, device=ybuf.device)
    for j in range(k):
        y = y + grouped[:, j]
    return y


# --------------------------------------------------------------------------
# N-bank expert FFN (one bank per ladder rung, ascending-bits order)
# --------------------------------------------------------------------------

def _act(act: str, up: torch.Tensor, gate_fn) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(gate_fn()) * up
    if act == "gelu":
        return F.gelu(up, approximate="tanh")
    return torch.square(F.relu(up))


def _matmul_promoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` with the reference einsum's dtype promotion: f32
    activations times bf16 weights run in f32 (bf16 x bf16 is unchanged,
    no copies)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(t), b.to(t))


def _ffn_bf16(bank, xb, act, use_kernel: bool = False):
    """(E, C, d) x (E, d, f) -> (E, C, d).

    ``use_kernel=True`` runs the grouped bf16 CUDA kernel (B4, one launch
    for the whole f16 bank); otherwise a batched matmul in the promoted
    dtype of activations and weights (bf16 on the serving path)."""
    mm = ops.grouped_bf16_matmul if use_kernel else _matmul_promoted
    up = mm(xb, bank["w_up"])
    h = _act(act, up, lambda: mm(xb, bank["w_gate"]))
    return mm(h, bank["w_down"])


def _ffn_q(bank, xb, act, use_kernel: bool):
    """Quantized bank: the grouped dequant-matmul CUDA kernel (B3; f32
    dequant inside the kernel) or the dequant-to-bf16 reference path."""
    if use_kernel:
        mm = ops.q_expert_matmul
    else:
        # each matrix is dequantized just before its product and dropped
        # after it, so a bank of hundreds of experts holds one bf16 copy
        # at a time (the products and their order are _ffn_bf16's)
        def mm(a, qt):
            return _matmul_promoted(a, dequantize(qt))
    up = mm(xb, bank["w_up"])
    h = _act(act, up, lambda: mm(xb, bank["w_gate"]))
    return mm(h, bank["w_down"])


def _expert_ffn(banks, xb, act, use_kernel):
    """banks: {"q4"|"q8": {...QTensor...}|None, "f16": {...bf16...}|None}
    with expert storage in ascending-bits bank order along E (quantized
    rungs first); ``xb`` is sliced per bank accordingly. With
    ``use_kernel`` each rung's whole bank is ONE grouped kernel launch per
    matrix."""
    outs = []
    off = 0
    for key in bank_keys(banks):
        bank = banks[key]
        n = _bank_len(bank)
        if not n:
            continue
        sl = xb[off:off + n]
        if _bank_bits(key) < 16:
            outs.append(_ffn_q(bank, sl, act, use_kernel))
        else:
            outs.append(_ffn_bf16(bank, sl, act, use_kernel))
        off += n
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def _bank_len(bank) -> int:
    w = bank["w_up"]
    return (w.q if isinstance(w, QTensor) else w).shape[0]


# --------------------------------------------------------------------------
# Parallelism: the (data, model) mesh
# --------------------------------------------------------------------------

# Token-gather pays only while the gathered activations stay ~cache-scale;
# above this the dispatch-buffer amplification dominates (see moe_apply).
TOKEN_GATHER_MAX_BYTES = 64 << 20

#: the key of a placed bank's d_ff slice, which the token-gather regime runs
DFF = "dff"
_MATS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class MoEParallelism:
    mesh: Any                      # repro_torch.launch.mesh.Mesh
    dp_axes: Tuple[str, ...]       # token axes ("pod","data") / ("data",)
    ep_axis: str = "model"
    # Second weight-sharding axis for EP banks (ZeRO/FSDP dimension): the
    # d_ff dim of every expert is sharded over it. Token-gather dispatch
    # keeps the weights sharded and moves ACTIVATIONS over this axis.
    fsdp_axis: Optional[str] = None

    @property
    def ep_size(self) -> int:
        return self.mesh.sizes[self.ep_axis]

    @property
    def fsdp_size(self) -> int:
        if self.fsdp_axis is None or self.fsdp_axis not in self.mesh.sizes:
            return 1
        return self.mesh.sizes[self.fsdp_axis]


def _dff_dim(name: str, axis: int = 0) -> int:
    """The d_ff dim of a bank matrix whose expert dim is ``axis``: the
    rows (K) of w_down and its scales, the columns (N) of up/gate."""
    return axis + 1 if name == "w_down" else axis + 2


def _dff_divides(banks, n: int, axis: int = 0) -> bool:
    """Every bank matrix's d_ff dim (a QTensor's codes and scales both)
    splits into ``n`` equal slices."""
    for key in bank_keys(banks):
        for name in _MATS:
            w = banks[key][name]
            parts = (w.q, w.scales) if isinstance(w, QTensor) else (w,)
            if any(t.shape[_dff_dim(name, axis)] % n for t in parts):
                return False
    return True


def _fsdp_active(banks, moe: MoEConfig, par: MoEParallelism, ep: bool):
    """Token-gather EP applies when experts are also d_ff-sharded over the
    fsdp axis (kimi-1T: (E/16 on model) x (f/16 on data) per device)."""
    return ep and par.fsdp_size > 1 and _dff_divides(banks, par.fsdp_size)


def _map_bank(bank, fn):
    return {k: bank[k].map(fn) if isinstance(bank[k], QTensor)
            else fn(bank[k]) for k in _MATS}


def _dff_slice(bank, i: int, n: int, axis: int = 0):
    """Slice ``i`` of ``n`` of a bank's d_ff dim as contiguous copies (a
    strided view is never handed to a kernel)."""
    out = {}
    for name in _MATS:
        dim = _dff_dim(name, axis)

        def cut(t):
            size = t.shape[dim] // n
            return t.narrow(dim, i * size, size).contiguous()
        w = bank[name]
        out[name] = w.map(cut) if isinstance(w, QTensor) else cut(w)
    return out


def _totals(banks, axis: int = 0):
    keys = bank_keys(banks)
    return keys, tuple((banks[k]["w_up"].q if isinstance(
        banks[k]["w_up"], QTensor) else banks[k]["w_up"]).shape[axis]
        for k in keys)


def shard_banks(banks, mesh, *, axis: int = 0, ep_axis: str = "model",
                fsdp_axis: Optional[str] = "data") -> List[Dict[str, Any]]:
    """Per-position shards of a bank tree, as ``dist.sharding.
    _expert_spec`` places them. With at least as many experts as the
    model axis (EP), position (i, j) holds the contiguous slice
    ``[j*loc_b, (j+1)*loc_b)`` of every bank b along the expert dim
    ``axis`` (0 for one layer's banks, 1 for the layer-stacked serve
    layout) at full d_ff — the experts ``PrecisionPlan.
    device_assignment`` gives rank j — replicated over the data axis; on
    a mesh whose data axis has size > 1, the shard also carries under
    ``DFF`` a contiguous copy of its d_ff slice i, which the token-gather
    regime runs. With fewer experts (TP), every position holds all
    experts on d_ff slice j. Shards live on ``mesh.devices[p]``: views on
    the bank's own device where the slice is contiguous, copies
    elsewhere. Raises ``ValueError`` when an EP bank does not split
    evenly or a TP d_ff dim does not divide."""
    m = mesh.sizes[ep_axis]
    keys, totals = _totals(banks, axis)
    ep = sum(totals) >= m
    if ep and any(tot % m for tot in totals):
        raise ValueError(
            f"EP banks must split evenly: "
            f"{dict(zip(keys, totals))} over {m} shards "
            f"(planner rounds per-layer counts)")
    if not ep and not _dff_divides(banks, m, axis):
        raise ValueError(f"TP banks: a d_ff dim does not split over {m}")
    fs = mesh.sizes.get(fsdp_axis, 1)
    dff = ep and fs > 1 and _dff_divides(banks, fs, axis)
    shards = []
    for pos, dev in enumerate(mesh.devices):
        at = SH.coords(mesh, pos)
        j = at[ep_axis]
        shard: Dict[str, Any] = {}
        for key, bank in banks.items():
            if bank is None:
                shard[key] = None
                continue
            if ep:
                loc = totals[keys.index(key)] // m
                part = _map_bank(
                    bank, lambda t: t.narrow(axis, j * loc, loc).to(dev))
                if dff:
                    part[DFF] = _dff_slice(part, at[fsdp_axis], fs, axis)
            else:
                part = _map_bank(_dff_slice(bank, j, m, axis),
                                 lambda t: t.to(dev))
            shard[key] = part
        shards.append(shard)
    return shards


def _on(device: torch.device):
    """Make ``device`` current while a position's work is issued: the
    kernels' C entry points launch on the current card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _take_rows(a: torch.Tensor, rows) -> torch.Tensor:
    """The row slices ``rows`` of ``a``, concatenated in order."""
    return torch.cat([a[r] for r in rows]) if len(rows) > 1 else a[rows[0]]


def _row_bytes(shape, dtype: torch.dtype, rows) -> Dict[int, int]:
    """Bytes of the rows ``rows[p]`` of a tensor of ``shape`` and ``dtype``
    that position ``p`` holds."""
    per_row = math.prod(shape[1:]) * dtype.itemsize
    return {p: per_row * sum(sl.stop - sl.start for sl in r)
            for p, r in enumerate(rows)}


def _book_scatter(a: torch.Tensor, rows) -> None:
    """Book the home device (position 0) sending each position its rows."""
    got = _row_bytes(a.shape, a.dtype, rows)
    OC.collective("scatter", got, {0: sum(got.values())})


class _Spread(torch.autograd.Function):
    """Copies of row slices of ``x`` on the mesh positions' devices:
    output p holds ``x``'s rows ``rows[p]`` on ``devices[p]``. The
    backward adds the positions' gradients on ``x``'s device in f32 in
    position order and rounds once; autograd would add them as they
    arrive, which on distinct cards is in no fixed order."""

    @staticmethod
    def forward(ctx, x, rows, devices):
        ctx.rows, ctx.meta = rows, (x.shape, x.dtype, x.device)
        if OC.counting():
            _book_scatter(x, rows)
        out = []
        for p, (r, dev) in enumerate(zip(rows, devices)):
            with OC.at_position(p):
                out.append(_take_rows(x, r).to(dev, copy=True))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        shape, dtype, device = ctx.meta
        if OC.counting():
            OC.collective("reduce", {0: math.prod(shape) * dtype.itemsize},
                          _row_bytes(shape, dtype, ctx.rows))
        with OC.at_position(0):
            acc = torch.zeros(shape, dtype=torch.float32, device=device)
            for r, g in zip(ctx.rows, grads):
                if g is None:
                    continue
                g = g.to(device, torch.float32)
                off = 0
                for sl in r:
                    n = sl.stop - sl.start
                    acc[sl] += g[off:off + n]
                    off += n
            return acc.to(dtype), None, None


def _sum_f32(parts, device) -> torch.Tensor:
    """A bf16 ``psum`` as XLA:CPU runs it: the parts summed in f32 in rank
    order on ``device``, rounded once to their dtype (``psum_scatter``
    rounds the same way)."""
    acc = parts[0].to(device, torch.float32)
    for t in parts[1:]:
        acc = acc + t.to(device, torch.float32)
    return acc.to(parts[0].dtype)


# --------------------------------------------------------------------------
# The MoE apply
# --------------------------------------------------------------------------

def moe_regime(banks, t: int, d: int, moe: MoEConfig,
               par: Optional[MoEParallelism]) -> str:
    """The regime :func:`moe_apply` runs ``t`` tokens of width ``d`` in:
    "one device", "token-gather", "data x EP" or "TP". Token-gather
    needs EP and a d_ff-divisible fsdp axis > 1, and pays only while the
    gathered tokens stay within ``TOKEN_GATHER_MAX_BYTES``: at
    train/prefill token counts the gathered activations and the
    amplified dispatch buffers blow device memory, so each data rank
    runs its own tokens through the full d_ff instead."""
    if par is None or len(par.mesh.devices) == 1:
        return "one device"
    ep = moe.num_experts >= par.ep_size
    if not ep:
        return "TP"
    tree = banks[0] if isinstance(banks, list) else banks
    if _fsdp_active(tree, moe, par, ep):
        n_dp = math.prod(par.mesh.sizes.get(a, 1) for a in par.dp_axes)
        if (t // n_dp) * par.fsdp_size * d * 2 <= TOKEN_GATHER_MAX_BYTES:
            return "token-gather"
    return "data x EP"


def _local_fn(pos, bank, x, weights, ids, *, rank, totals, locs, capacity,
              act, use_kernel):
    """One mesh position's share (the reference's shard_map body between
    its collectives): dispatch the tokens it sees to its local experts,
    run the N-bank FFN on its bank shard, combine. ``pos`` names the
    position (launch bookkeeping reads it)."""
    t, d = x.shape
    xbuf, dest, order, w_sorted = _dispatch_local(
        x, ids, weights, rank=rank, totals=totals, locs=locs,
        capacity=capacity)
    ybuf = _expert_ffn(bank, xbuf, act, use_kernel)
    return _combine_local(ybuf, dest, order, w_sorted, t, d, ids.shape[1])


def moe_apply(banks, x: torch.Tensor, weights: torch.Tensor,
              ids: torch.Tensor, moe: MoEConfig,
              par: Optional[MoEParallelism] = None, *,
              act: str = "swiglu", use_kernel: bool = False,
              capacity: Optional[int] = None) -> torch.Tensor:
    """x: (T, d) -> (T, d).

    ``banks`` is either the train layout {"f16": {...(E,d,f) bf16...}} or
    the rung-keyed serve layout {"q4": ..., "q8": ..., "f16": ...}
    (bank order = ascending bits, cheapest rung first). ``capacity``
    overrides the capacity-factor formula with an explicit per-expert slot
    count.

    ``par`` (a mesh of more than one position) runs the reference's
    shard_map: ``banks`` is then one bank tree, placed here by
    :func:`shard_banks`, or the list of per-position shards that
    :func:`shard_banks` (through ``apply_precision_plan(..., mesh=)``) or
    ``build_model``'s gather of a sharded param tree placed. The data axes split the tokens; position
    (i, j) (data rank i, model rank j) runs one of three regimes:

      * token-gather (EP, a d_ff-divisible fsdp axis > 1, and the
        gathered tokens within ``TOKEN_GATHER_MAX_BYTES``): the data
        ranks' token shards gathered in rank order through rank j's
        experts on d_ff slice i, the partial outputs reduce-scattered
        over data, then summed over model;
      * data x EP (the gate says no): data shard i through rank j's
        experts at full d_ff, summed over model;
      * TP (fewer experts than model ranks): data shard i through all
        experts on d_ff slice j, whose down projections are partial sums
        closed by the sum over model.

    Each sum runs in f32 in rank order and rounds once, as XLA:CPU's bf16
    ``psum`` and ``psum_scatter`` do; the data ranks' outputs are then
    concatenated in order on ``x``'s device. Every position's work is
    issued before the sums, so positions on distinct cards overlap, and
    the whole is differentiable."""
    t, d = x.shape
    regime = moe_regime(banks, t, d, moe, par)
    if regime == "one device":
        if isinstance(banks, list):           # placed on a (1, 1) mesh
            (banks,) = banks
        if capacity is None:
            cap = int(np.ceil(t * moe.top_k * moe.capacity_factor
                              / moe.num_experts))
        else:
            cap = int(capacity)
        cap = max(4, ((cap + 3) // 4) * 4)
        keys = bank_keys(banks)
        totals = tuple(_bank_len(banks[key]) for key in keys)
        return _local_fn(0, banks, x, weights, ids, rank=0, totals=totals,
                         locs=totals, capacity=cap, act=act,
                         use_kernel=use_kernel)
    mesh, m = par.mesh, par.ep_size
    ep = regime != "TP"
    fsdp = regime == "token-gather"
    n_dp = math.prod(mesh.sizes.get(a, 1) for a in par.dp_axes)
    if t % n_dp:
        raise ValueError(f"{t} tokens do not split over {n_dp} data ranks "
                         f"({par.dp_axes})")
    t_loc = t // n_dp
    if not isinstance(banks, list):
        banks = shard_banks(banks, mesh, ep_axis=par.ep_axis,
                            fsdp_axis=par.fsdp_axis)
    locs = tuple(_bank_len(banks[0][k]) for k in bank_keys(banks[0]))
    totals = tuple(n * m for n in locs) if ep else locs
    fs = par.fsdp_size if fsdp else 1
    t_disp = t_loc * fs
    # static per-shard capacity: each position sees all the assignments
    # of its (gathered) tokens and keeps its local experts' share
    if capacity is None:
        cap = int(np.ceil(t_disp * moe.top_k * moe.capacity_factor
                          / moe.num_experts))
    else:
        cap = int(capacity)
    cap = max(4, ((cap + 3) // 4) * 4)

    at = [SH.coords(mesh, p) for p in range(len(mesh.devices))]

    def dp_index(c):
        i = 0
        for a in par.dp_axes:
            i = i * mesh.sizes.get(a, 1) + c.get(a, 0)
        return i

    def peers(p, axis):
        """The positions that differ from ``p`` only along ``axis``, in
        that axis's order."""
        return [q for q in range(len(at)) if all(
            at[q][a] == at[p][a] for a in mesh.axis_names if a != axis)]

    def tokens(i):
        return slice(i * t_loc, (i + 1) * t_loc)

    # the token rows each position sees: its data rank's, or with
    # token-gather every fsdp peer's in rank order
    rows = [[tokens(dp_index(at[q])) for q in peers(p, par.fsdp_axis)]
            if fsdp else [tokens(dp_index(at[p]))] for p in range(len(at))]
    xs = _Spread.apply(x, rows, mesh.devices)
    ws = _Spread.apply(weights, rows, mesh.devices)
    if OC.counting():
        _book_scatter(ids, rows)
    y = []
    for p, dev in enumerate(mesh.devices):
        c = at[p]
        j = c[par.ep_axis]
        bank = banks[p]
        if fsdp:
            bank = {k: None if b is None else
                    b.get(DFF) or _dff_slice(b, c[par.fsdp_axis], fs)
                    for k, b in bank.items()}
        with _on(dev), OC.at_position(p):
            y.append(_local_fn(p, bank, xs[p], ws[p],
                               _take_rows(ids, rows[p]).to(dev),
                               rank=j if ep else 0, totals=totals,
                               locs=locs, capacity=cap, act=act,
                               use_kernel=use_kernel))
    z = y
    if fsdp:
        # psum_scatter over the fsdp axis: position p keeps block
        # (its fsdp rank) of the gathered token rows, summed over the
        # fsdp peers
        z = []
        for p, dev in enumerate(mesh.devices):
            blk = slice(at[p][par.fsdp_axis] * t_loc,
                        (at[p][par.fsdp_axis] + 1) * t_loc)
            with OC.at_position(p):
                z.append(_sum_f32([y[q][blk]
                                   for q in peers(p, par.fsdp_axis)], dev))
        if OC.counting():
            OC.collective("reduce-scatter",
                          {p: OC.nbytes(v) for p, v in enumerate(z)},
                          {p: OC.nbytes(v) for p, v in enumerate(y)})
    # psum over the model axis, read at the first position of each data
    # rank; the data ranks' outputs concatenated in order
    first = {}
    for p in range(len(at)):
        first.setdefault(dp_index(at[p]), p)
    with OC.at_position(0):
        outs = [_sum_f32([z[q] for q in peers(first[i], par.ep_axis)],
                         x.device) for i in range(n_dp)]
    if OC.counting():
        sent: Dict[int, int] = {}
        for i in range(n_dp):
            for q in peers(first[i], par.ep_axis):
                sent[q] = sent.get(q, 0) + OC.nbytes(z[q])
        OC.collective("all-reduce", {0: sum(OC.nbytes(o) for o in outs)},
                      sent)
    return outs[0] if n_dp == 1 else torch.cat(outs)


# --------------------------------------------------------------------------
# Bank construction from a PrecisionPlan (serve) or plain params (train)
# --------------------------------------------------------------------------

def train_banks(moe_params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {"q4": None,
            "f16": {k: moe_params[k] for k in ("w_gate", "w_up", "w_down")}}


def build_ladder_banks(moe_params: Dict[str, torch.Tensor], bits_row,
                       *, ladder=(16, 4), group_size: int = 64):
    """Split one layer's experts into per-rung banks in ascending-bits
    bank order.

    ``bits_row``: (E,) int — each expert's ladder rung. Returns
    (banks, order) where ``order`` is the expert permutation (cheapest
    rung first) — the caller permutes the router columns with it. Every
    ladder rung gets a bank key (``None`` when empty)."""
    bits_row = np.asarray(bits_row)
    rungs = sorted(ladder)
    order = np.concatenate(
        [np.where(bits_row == b)[0] for b in rungs]).astype(np.int32)
    dev = moe_params["w_up"].device
    banks: Dict[str, Any] = {}
    off = 0
    for b in rungs:
        cnt = int((bits_row == b).sum())
        name = _bank_name(b)
        if cnt == 0:
            banks[name] = None
            continue
        experts = order[off:off + cnt]
        if b >= 16:
            idx = torch.as_tensor(experts, dtype=torch.long, device=dev)
            banks[name] = {k: moe_params[k].index_select(0, idx)
                           for k in ("w_gate", "w_up", "w_down")}
        else:
            # one expert at a time: the f32 temporaries of quantize stay
            # one expert's size, and no permuted bf16 copy is made
            banks[name] = {k: _stack_q([quantize(moe_params[k][int(e)], b,
                                                 group_size)
                                        for e in experts])
                           for k in ("w_gate", "w_up", "w_down")}
        off += cnt
    return banks, order


def build_mixed_banks(moe_params: Dict[str, torch.Tensor], quant_mask,
                      *, bits: int = 4, group_size: int = 64):
    """Legacy binary spelling of :func:`build_ladder_banks`:
    quant_mask (E,) bool -> [q4 | f16] banks, quantized first."""
    quant_mask = np.asarray(quant_mask).astype(bool)
    bits_row = np.where(quant_mask, bits, 16)
    return build_ladder_banks(moe_params, bits_row, ladder=(16, bits),
                              group_size=group_size)


def _stack_q(qts) -> QTensor:
    return QTensor(q=torch.stack([t.q for t in qts]),
                   scales=torch.stack([t.scales for t in qts]),
                   bits=qts[0].bits, group_size=qts[0].group_size)


def moe_dense_ref(moe_params, x, moe: MoEConfig, act: str = "swiglu"):
    """O(T*E) oracle: every expert computes every token (tests only)."""
    weights, ids = route(moe_params["router"], x, moe)
    w_full = torch.zeros((x.shape[0], moe.num_experts), dtype=torch.float32,
                         device=x.device)
    w_full.scatter_add_(1, ids, weights)
    banks = {"w_gate": moe_params["w_gate"], "w_up": moe_params["w_up"],
             "w_down": moe_params["w_down"]}
    y_all = _ffn_bf16(banks, x[None].expand((moe.num_experts,) + x.shape),
                      act)                               # (E, T, d)
    return torch.einsum("etd,te->td", y_all.to(torch.float32), w_full
                        ).to(x.dtype)
