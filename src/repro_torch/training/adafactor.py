"""Adafactor (factored second moment, no first moment;
``repro.training.adafactor``): the memory-lean optimizer option. Updates
in place, like :func:`repro_torch.training.optimizer.adamw_update`.

On a sharded tree the factored moments shard like their param with the
reduced dim's partition dropped (``train_loop.opt_state_specs``), and a
leaf's update runs once on the whole tensor (``sharding.whole``): the row
and column means and the update's RMS see every element."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.dist import sharding as SH
from repro_torch.training.optimizer import (OptConfig, clip_scale,
                                            global_norm, init_step,
                                            schedule, tree_map)


def init_adafactor_state(params) -> Dict[str, Any]:
    def factors(x):
        if x.ndim < 2:
            return {"v": SH.zeros(x)}
        return {"vr": SH.zeros(x, drop=-1), "vc": SH.zeros(x, drop=-2)}
    return {"f": tree_map(factors, params), "step": init_step(params)}


@torch.no_grad()
def adafactor_update(params, grads, state, cfg: OptConfig):
    """One Adafactor step, in place. Returns (params, state, {grad_norm,
    lr})."""
    step = SH.value(state["step"]) + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.clip_norm)
    b2 = 1.0 - torch.pow(step.to(torch.float32), -0.8)

    @SH.whole
    def upd(p, g, f):
        g = g.to(torch.float32) * scale
        g2 = g * g + 1e-30
        if p.ndim < 2:
            f["v"].copy_(b2 * f["v"] + (1 - b2) * g2)
            u = g * torch.rsqrt(f["v"] + 1e-30)
        else:
            vr, vc = f["vr"], f["vc"]
            vr.copy_(b2 * vr + (1 - b2) * g2.mean(-1))
            vc.copy_(b2 * vc + (1 - b2) * g2.mean(-2))
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=1e-30))
            u = g * torch.rsqrt(denom + 1e-30)
        # update clipping (Adafactor RMS rule)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms_u, min=1.0)
        pf = p.to(torch.float32)
        p.copy_((pf - lr * u - lr * cfg.weight_decay * pf
                 * float(p.ndim >= 2)).to(p.dtype))

    tree_map(upd, params, grads, state["f"])
    state["step"] = SH.replicate(step, state["step"])
    return params, state, {"grad_norm": gnorm, "lr": lr}
