"""Train step: microbatched gradient accumulation + optimizer update
(``repro.training.train_loop``).

The reference accumulates with a ``lax.scan`` over microbatches; here a
Python loop runs them in the same order, adds each microbatch's gradient
in ``grad_dtype`` and divides by their count, as the scan body does. The
optimizer updates params and state in place (see
:mod:`repro_torch.training.optimizer`).

Sharded training is the reference's spelling: ``make_train_step(model.
loss_fn, tcfg)`` on a model built with a mesh, with params placed by
``dist.sharding.shard_tree(params, param_shardings(cfg, mesh, params))``
and the state made from them (it shards by :func:`opt_state_specs`).
Every mesh position's shard is a leaf of its own: the backward gives
each position its part of the gradient (the dense weights' through the
gather onto ``mesh.devices[0]``, the expert shards' from the tokens that
position ran), and a replicated shard's gradient is summed over its
replicas in f32 in position order and rounded once, as the reference's
bf16 ``psum`` over the data axis is. The optimizer then updates each
distinct shard once and copies it to its replicas.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.dist import sharding as SH
from repro_torch.training import adafactor as AF
from repro_torch.training import compression as C
from repro_torch.training import optimizer as O


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: O.OptConfig = O.OptConfig()
    optimizer: str = "adamw"                # adamw | adafactor
    num_microbatches: int = 1
    grad_dtype: torch.dtype = torch.bfloat16  # accumulation dtype
    # int8 + error-feedback gradient compression (training/compression.py);
    # None disables.
    grad_compression: Optional[str] = None  # None | "int8"


def init_train_state(params, tcfg: TrainConfig):
    state = AF.init_adafactor_state(params) \
        if tcfg.optimizer == "adafactor" else O.init_opt_state(params)
    if tcfg.grad_compression == "int8":
        state["ef"] = C.init_error_feedback(params)
    return state


def _opt_update(params, grads, opt_state, tcfg: TrainConfig):
    if tcfg.optimizer == "adafactor":
        return AF.adafactor_update(params, grads, opt_state, tcfg.opt)
    return O.adamw_update(params, grads, opt_state, tcfg.opt)


def _grad_leaf(p):
    if isinstance(p, SH.Sharded):       # one leaf per mesh position
        return SH.Sharded(p.placement, p.shape,
                          [s.detach().requires_grad_(True)
                           for s in p.shards])
    return p.detach().requires_grad_(True)


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: (loss, metrics,
    grads), grads in the params' dtypes (zeros for an unused leaf). A
    sharded leaf's gradient is sharded like it, each distinct shard's
    summed over its replicas (``sharding.sum_replicas``)."""
    leaves = O.tree_map(_grad_leaf, params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
    flat = [t for _, x in O.tree_leaves(leaves)
            for t in (x.shards if isinstance(x, SH.Sharded) else [x])]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))

    def take(p):                        # tree_map walks tree_leaves' order
        if isinstance(p, SH.Sharded):
            parts = [next(grads) for _ in p.shards]
            if all(g is None for g in parts):
                parts[0] = torch.zeros_like(p.shards[0])
            return SH.sum_replicas(SH.Sharded(p.placement, p.shape, parts))
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        O.tree_map(take, leaves)


def make_train_step(loss_fn: Callable, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (loss, metrics). Returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics);
    params and opt_state are updated in place and returned."""

    def train_step(params, opt_state, batch):
        n = tcfg.num_microbatches
        if n == 1:
            _, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            micro = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                     for k, v in batch.items()}
            grads = O.tree_map(
                lambda p: SH.zeros(p, dtype=tcfg.grad_dtype), params)
            ms = []
            for i in range(n):
                _, m, g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in micro.items()})
                O.tree_map(SH.per_shard(
                    lambda a, b: a.add_(b.to(tcfg.grad_dtype))), grads, g)
                del g
                ms.append(m)
            O.tree_map(SH.per_shard(lambda g: g.div_(torch.tensor(
                n, dtype=g.dtype, device=g.device))), grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        if tcfg.grad_compression == "int8":
            grads, _ = C.compress_grads(grads, opt_state["ef"])
        params, opt_state, om = _opt_update(params, grads, opt_state, tcfg)
        return params, opt_state, {**metrics, **om}

    return train_step


def opt_state_specs(param_spec_tree, tcfg: TrainConfig, params_struct):
    """Spec tree for the optimizer state, derived from the param specs
    (moments and the int8 residual shard like their params; Adafactor's
    factored moments drop the reduced dim's partition; the step is
    replicated). ``params_struct`` is the param tree (tensors, ``meta``
    tensors or :class:`dist.sharding.Sharded`)."""
    extra = {}
    if tcfg.grad_compression == "int8":
        extra["ef"] = param_spec_tree    # residual shards like its param
    if tcfg.optimizer == "adamw":
        return {"m": param_spec_tree, "v": param_spec_tree,
                "step": SH.P(), **extra}

    def factor_specs(spec, p):
        if len(p.shape) < 2:
            return {"v": spec}
        parts = tuple(spec) + (None,) * (len(p.shape) - len(spec))
        return {"vr": SH.P(*parts[:-1]),
                "vc": SH.P(*(parts[:-2] + parts[-1:]))}

    return {"f": O.tree_map(factor_specs, param_spec_tree, params_struct),
            "step": SH.P(), **extra}
