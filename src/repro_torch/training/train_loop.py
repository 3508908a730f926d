"""Train step: microbatched gradient accumulation + optimizer update
(``repro.training.train_loop``).

The reference accumulates with a ``lax.scan`` over microbatches; here a
Python loop runs them in the same order, adds each microbatch's gradient
in ``grad_dtype`` and divides by their count, as the scan body does. The
optimizer updates params and state in place (see
:mod:`repro_torch.training.optimizer`). ``opt_state_specs``, the
reference's sharding helper, waits for EP x DP.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

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


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: (loss, metrics,
    grads), grads in the params' dtypes (zeros for an unused leaf)."""
    leaves = O.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
    flat = [x for _, x in O.tree_leaves(leaves)]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))

    def take(p):                        # tree_map walks tree_leaves' order
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
            grads = O.tree_map(lambda p: torch.zeros(
                p.shape, dtype=tcfg.grad_dtype, device=p.device), params)
            ms = []
            for i in range(n):
                _, m, g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in micro.items()})
                O.tree_map(lambda a, b: a.add_(b.to(tcfg.grad_dtype)),
                           grads, g)
                del g
                ms.append(m)
            O.tree_map(lambda g: g.div_(torch.tensor(
                n, dtype=g.dtype, device=g.device)), grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        if tcfg.grad_compression == "int8":
            grads, _ = C.compress_grads(grads, opt_state["ef"])
        params, opt_state, om = _opt_update(params, grads, opt_state, tcfg)
        return params, opt_state, {**metrics, **om}

    return train_step
