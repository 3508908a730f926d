"""AdamW + cosine schedule + global-norm clipping (``repro.training.
optimizer``) over the port's nested-dict param trees.

Moments are f32 and params keep their own dtype. The update runs in
place: each step rewrites the params and the moments it was given (and
returns them), so a full-width model never holds two copies of its
optimizer state; the reference returns new trees. The arithmetic is the
reference's, op for op. Step-dependent scalars are f32 tensors on the
params' device, and every division has a tensor divisor: on a CUDA
tensor PyTorch turns a division by a Python scalar into a multiply by
its reciprocal, which is not the true quotient.

A tree may hold :class:`repro_torch.dist.sharding.Sharded` leaves (a
param tree placed on a mesh): AdamW then updates each distinct shard
once (``sharding.per_shard``) and syncs its replicas, the global norm
counts each element once, and the step counter is replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from repro_torch.dist import sharding as SH


# --------------------------------------------------------------------------
# Param trees: nested dicts of tensors, leaves in sorted-key order (the
# order ``jax.tree_util.tree_leaves`` gives a dict)
# --------------------------------------------------------------------------

def tree_leaves(tree, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree, *rest, path: Tuple[str, ...] = (),
             with_path: bool = False):
    """``fn(leaf, *same-position nodes of rest)`` over the leaves of
    ``tree`` (``fn(path, leaf, ...)`` with ``with_path``); a node of
    ``rest`` may be a whole subtree where ``tree`` has a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            path=path + (k,), with_path=with_path)
                for k in sorted(tree)}
    return fn(path, tree, *rest) if with_path else fn(tree, *rest)


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device (a divisor that divides)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to 10% of ``cfg.lr``; f32."""
    step = step.to(torch.float32)
    warm = step / f32(max(cfg.warmup_steps, 1), step)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                             step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm,
                                0.1 + 0.9 * cos)


def init_step(params):
    """The step counter: an int32 zero on the params' (home) device,
    replicated over their mesh when they are sharded."""
    first = next(leaf for _, leaf in tree_leaves(params))
    return SH.replicate(torch.zeros((), dtype=torch.int32,
                                    device=first.device), first)


def init_opt_state(params) -> Dict[str, Any]:
    def zeros(p):
        return tree_map(SH.zeros, p)
    return {"m": zeros(params), "v": zeros(params),
            "step": init_step(params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every element, each once (a sharded
    leaf's distinct shards, not its replicas), on the first leaf's
    device."""
    total, dev = 0, None
    for _, x in tree_leaves(tree):
        for s in SH.distinct(x):
            part = torch.sum(torch.square(s.to(torch.float32)))
            dev = part.device if dev is None else dev
            total = total + part.to(dev)
    return torch.sqrt(total)


def _is_matrix(path: tuple) -> bool:
    last = str(path[-1])
    return not any(s in last for s in ("scale", "norm", "bias", "ln_x",
                                       "A_log", "D", "mix", "bonus"))


def clip_scale(gnorm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """min(1, clip_norm / (gnorm + 1e-9)), a true quotient."""
    return torch.clamp(f32(clip_norm, gnorm) / (gnorm + 1e-9), max=1.0)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step, in place. Returns (params, state, {grad_norm,
    lr})."""
    step = SH.value(state["step"]) + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.clip_norm)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(f32(cfg.b1, stepf), stepf)
    bc2 = 1 - torch.pow(f32(cfg.b2, stepf), stepf)

    @SH.per_shard
    def upd(path, p, g, m, v):
        # the step scalars on this shard's device (a mesh's cards differ)
        lr_, scale_, bc1_, bc2_ = (t.to(p.device)
                                   for t in (lr, scale, bc1, bc2))
        g = g.to(torch.float32) * scale_
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        delta = (m / bc1_) / (torch.sqrt(v / bc2_) + cfg.eps)
        if _is_matrix(path):
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr_ * delta).to(p.dtype))

    tree_map(upd, params, grads, state["m"], state["v"], with_path=True)
    state["step"] = SH.replicate(step, state["step"])
    return params, state, {"grad_norm": gnorm, "lr": lr}
