"""Mixed-precision MoE layer on one device: N expert banks (one per ladder
rung, e.g. int4 | int8 | bf16) + the capacity-bounded local dispatch.

The paper's partial expert quantization turns each MoE layer into per-rung
banks — ``q4`` (packed int4 + scales), ``q8`` (int8 + scales) and ``f16``
(bf16) — in ASCENDING-bits bank order, with a per-layer expert permutation
mapping routed ids into bank slots (``PrecisionPlan.expert_order``).

Dispatch (the reference's ``repro.core.mixed_moe``):

  * one device (``par=None``): rank 0 of an EP group of one, every expert
    local, no collective;
  * **EP** over a (1, ep) mesh (``MoEParallelism``): one process drives
    every rank. Rank r holds the contiguous slice ``[r*loc_b,
    (r+1)*loc_b)`` of every bank b on ``mesh.devices[r]``; each rank
    dispatches all tokens (the data axis has size 1) to its local experts
    under the unchanged capacity, runs the N-bank FFN on its shard and
    combines its weighted outputs; the ranks' (T, d) outputs are then
    summed on the activation's device, the counterpart of the reference's
    closing ``psum`` over "model". The sum runs in f32 in rank order and
    rounds once to the outputs' dtype: that is what the reference's bf16
    psum gives on XLA:CPU (a running bf16 sum over 4 or 8 ranks is not).
    A token's expert output is computed by exactly one rank and the other
    ranks add exact zeros, so at top-2 the result is bit-identical to one
    device; at top-k > 2 a token's outputs on one rank are summed there
    first, so EP is bit-identical to the reference's EP, not to one
    device.

The reference's token-gather (ZeRO) regime, which needs a data axis > 1,
and its TP regime (fewer experts than ranks) are not ported; a mesh that
asks for either raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.quantization import QTensor, dequantize, quantize
from repro_torch.kernels import ops

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
        dispatch = F.one_hot(ids, e).to(torch.float32).sum(1)     # (T,E)
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
    counts = torch.bincount(sorted_e, minlength=e_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
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
# Parallelism: the (1, ep) expert-parallel mesh
# --------------------------------------------------------------------------

#: what a mesh the serving slice does not shard raises
LATER_SLICE = ("is a later slice of the PyTorch port (sharded training: "
               "dist/sharding.py and moe_apply's token-gather/ZeRO and TP "
               "regimes); serving shards experts over a (1, ep) mesh")


@dataclasses.dataclass(frozen=True)
class MoEParallelism:
    mesh: Any                      # repro_torch.launch.mesh.Mesh
    dp_axes: Tuple[str, ...]       # token axes ("pod","data") / ("data",)
    ep_axis: str = "model"
    # Second weight-sharding axis for EP banks (ZeRO/FSDP dimension): the
    # d_ff dim of every expert is sharded over it (the reference's
    # token-gather regime; not ported).
    fsdp_axis: Optional[str] = None

    @property
    def ep_size(self) -> int:
        return self.mesh.sizes[self.ep_axis]

    @property
    def fsdp_size(self) -> int:
        if self.fsdp_axis is None or self.fsdp_axis not in self.mesh.sizes:
            return 1
        return self.mesh.sizes[self.fsdp_axis]


def _fsdp_active(banks, moe: MoEConfig, par: MoEParallelism, ep: bool):
    """Token-gather EP applies when experts are also d_ff-sharded over the
    fsdp axis (kimi-1T: (E/16 on model) x (f/16 on data) per device).
    The regime gate of the later sharded-training slice; a serving mesh
    has no fsdp axis above 1, so it is never active there."""
    if not ep or par.fsdp_size <= 1:
        return False
    fs = par.fsdp_size
    for key in bank_keys(banks):
        for name, w in banks[key].items():
            arr = w.q if isinstance(w, QTensor) else w
            fdim = 1 if name == "w_down" else 2
            if arr.shape[fdim] % fs:
                return False
            if isinstance(w, QTensor) and w.scales.shape[fdim] % fs:
                return False
    return True


def _require_ep_regime(moe: MoEConfig, par: MoEParallelism) -> None:
    """The serving regime: experts over the EP axis, every other mesh
    axis of size 1 (every rank sees every token)."""
    n_dp = 1
    for a in par.dp_axes:
        n_dp *= par.mesh.sizes.get(a, 1)
    if n_dp > 1 or par.fsdp_size > 1:
        raise NotImplementedError(
            f"moe_apply over mesh {par.mesh.sizes}: a data axis > 1 (the "
            f"token-gather/ZeRO regime) {LATER_SLICE}")
    if moe.num_experts < par.ep_size:
        raise NotImplementedError(
            f"moe_apply with {moe.num_experts} experts over ep="
            f"{par.ep_size} (the TP regime) {LATER_SLICE}")


def _map_bank(bank, fn):
    return {k: v.map(fn) if isinstance(v, QTensor) else fn(v)
            for k, v in bank.items()}


def shard_banks(banks, mesh, *, axis: int = 0,
                ep_axis: str = "model") -> List[Dict[str, Any]]:
    """Per-rank shards of a bank tree (the counterpart of the reference's
    ``_bank_specs`` in the EP regime): rank r's shard of bank b is the
    contiguous slice ``[r*loc_b, (r+1)*loc_b)`` of the expert dim ``axis``
    (0 for one layer's banks, 1 for the layer-stacked serve layout) on
    ``mesh.devices[r]`` — the experts ``PrecisionPlan.device_assignment``
    gives rank r. On the bank's own device a shard is a view (a one-layer
    shard is then contiguous); elsewhere it is a copy. Raises
    ``ValueError`` when a bank does not split evenly."""
    ep = mesh.sizes[ep_axis]
    keys = bank_keys(banks)
    totals = tuple((banks[k]["w_up"].q if isinstance(
        banks[k]["w_up"], QTensor) else banks[k]["w_up"]).shape[axis]
        for k in keys)
    if any(tot % ep for tot in totals):
        raise ValueError(
            f"EP banks must split evenly: "
            f"{dict(zip(keys, totals))} over {ep} shards "
            f"(planner rounds per-layer counts)")
    shards = []
    for r, dev in enumerate(mesh.devices):
        shard: Dict[str, Any] = {}
        for key, bank in banks.items():
            if bank is None:
                shard[key] = None
                continue
            loc = totals[keys.index(key)] // ep
            shard[key] = _map_bank(
                bank, lambda t: t.narrow(axis, r * loc, loc).to(dev))
        shards.append(shard)
    return shards


def _on(device: torch.device):
    """Make ``device`` current while a rank's work is issued: the kernels'
    C entry points launch on the current card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# --------------------------------------------------------------------------
# The MoE apply
# --------------------------------------------------------------------------

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

    ``par`` (an EP mesh of size > 1) runs the sharded path: ``banks`` is
    then one bank tree, sharded here (:func:`shard_banks`), or the list of
    per-rank shards that ``apply_precision_plan(..., mesh=)`` placed on
    the ranks' devices. Each rank's work is issued before the sum, so
    ranks on distinct cards overlap."""
    t, d = x.shape
    if capacity is None:
        # tokens are replicated over the EP axis: every rank sees every
        # assignment and keeps its local experts' share
        cap = int(np.ceil(t * moe.top_k * moe.capacity_factor
                          / moe.num_experts))
    else:
        cap = int(capacity)
    cap = max(4, ((cap + 3) // 4) * 4)
    k = ids.shape[1]
    if par is not None:
        _require_ep_regime(moe, par)
    if par is None or par.ep_size == 1:
        if isinstance(banks, list):           # placed on a (1, 1) mesh
            (banks,) = banks
        keys = bank_keys(banks)
        totals = tuple(_bank_len(banks[key]) for key in keys)
        xbuf, dest, order, w_sorted = _dispatch_local(
            x, ids, weights, rank=0, totals=totals, locs=totals,
            capacity=cap)
        ybuf = _expert_ffn(banks, xbuf, act, use_kernel)
        return _combine_local(ybuf, dest, order, w_sorted, t, d, k)
    ep = par.ep_size
    shards = banks if isinstance(banks, list) \
        else shard_banks(banks, par.mesh, ep_axis=par.ep_axis)
    keys = bank_keys(shards[0])
    locs = tuple(_bank_len(shards[0][key]) for key in keys)
    totals = tuple(loc * ep for loc in locs)
    outs = []
    for r, (dev, shard) in enumerate(zip(par.mesh.devices, shards)):
        with _on(dev):
            xr, wr, ir = x.to(dev), weights.to(dev), ids.to(dev)
            xbuf, dest, order, w_sorted = _dispatch_local(
                xr, ir, wr, rank=r, totals=totals, locs=locs, capacity=cap)
            ybuf = _expert_ffn(shard, xbuf, act, use_kernel)
            outs.append(_combine_local(ybuf, dest, order, w_sorted, t, d,
                                       k))
    # the closing psum: an f32 sum in rank order, rounded once
    y = outs[0].to(x.device, torch.float32)
    for out in outs[1:]:
        y = y + out.to(x.device, torch.float32)
    return y.to(outs[0].dtype)


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
