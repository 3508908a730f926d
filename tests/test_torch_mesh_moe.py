"""The port's ``mixed_moe.moe_apply`` over (data, model) meshes against the
reference's ``shard_map``: the token-gather, data x EP and TP regimes,
forward and gradients.

One subprocess forces eight host devices before importing JAX (as the
reference's EP tests do), runs every case through the reference and
writes inputs, outputs and gradients to an ``.npz``; the tests run the
same inputs through the port on ``["cpu"] * n`` meshes. Per case two
variants:

* ``exact``: bf16 ternary weights and tokens with the relu^2 activation,
  so every expert product is exact in both frameworks and only the
  dispatch, the combine and the collectives can differ: output bytes
  equal (the port's closing sums reproduce XLA:CPU's bf16 ``psum`` and
  ``psum_scatter``, f32 in rank order rounded once), gradients within
  1e-2 of max |ref| (bf16 backward products are not exact);
* ``f32``: float32 normal weights with SwiGLU: output within 1e-6 and
  gradients within 1e-5 of max |ref|.

The data x EP regime is forced on both sides by setting
``TOKEN_GATHER_MAX_BYTES`` to 0 in the test, and also reached without an
fsdp axis. The port's placed per-position shards (``shard_banks``) give
the bytes of its in-call slicing.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import mixed_moe as tm
from repro_torch.launch.mesh import make_test_mesh

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
D, F, T = 32, 64, 16

# name: (mesh shape, axis names, dp axes, experts, top-k, fsdp axis,
#        force data x EP, regime)
CASES = {
    "token-gather 2x2 top-2": ((2, 2), ("data", "model"), ("data",), 8, 2,
                               "data", False, "token-gather"),
    "token-gather 2x2 top-8": ((2, 2), ("data", "model"), ("data",), 8, 8,
                               "data", False, "token-gather"),
    "token-gather 4x1": ((4, 1), ("data", "model"), ("data",), 8, 2, "data",
                         False, "token-gather"),
    "token-gather pod 2x2x2": ((2, 2, 2), ("pod", "data", "model"),
                               ("pod", "data"), 8, 2, "data", False,
                               "token-gather"),
    "data x EP forced 2x2 top-2": ((2, 2), ("data", "model"), ("data",), 8,
                                   2, "data", True, "data x EP"),
    "data x EP forced 2x2 top-8": ((2, 2), ("data", "model"), ("data",), 8,
                                   8, "data", True, "data x EP"),
    "data x EP no fsdp 2x2": ((2, 2), ("data", "model"), ("data",), 8, 2,
                              None, False, "data x EP"),
    "TP 1x4": ((1, 4), ("data", "model"), ("data",), 2, 2, "data", False,
               "TP"),
    "TP 2x4": ((2, 4), ("data", "model"), ("data",), 2, 2, "data", False,
               "TP"),
}

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import MoEConfig
from repro.core import mixed_moe as MM
from repro.launch.mesh import use_mesh

CASES = %(cases)r
D, F, T = %(D)d, %(F)d, %(T)d
out = {}


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


for ci, (name, (shape, axes, dp, e, k, fsdp, force, _)) in enumerate(
        CASES.items()):
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n])
    par = MM.MoEParallelism(mesh=mesh, dp_axes=dp, fsdp_axis=fsdp)
    moe = MoEConfig(num_experts=e, top_k=k, d_ff_expert=F,
                    capacity_factor=2.0)
    MM.TOKEN_GATHER_MAX_BYTES = 0 if force else 64 << 20
    for variant in ("exact", "f32"):
        rng = np.random.default_rng(ci)
        if variant == "exact":
            dt, act = jnp.bfloat16, "relu2"
            mk = lambda s: rng.integers(-1, 2, s).astype(np.float32)
        else:
            dt, act = jnp.float32, "swiglu"
            mk = lambda s: (rng.standard_normal(s) / np.sqrt(s[-2])
                            ).astype(np.float32)
        bank = {"w_gate": mk((e, D, F)), "w_up": mk((e, D, F)),
                "w_down": mk((e, F, D))}
        x = mk((T, D)) if variant == "exact" else \
            rng.standard_normal((T, D)).astype(np.float32)
        router = rng.standard_normal((D, e)).astype(np.float32)
        r = rng.standard_normal((T, D)).astype(np.float32)
        jb = {key: jnp.asarray(v, dt) for key, v in bank.items()}
        jx = jnp.asarray(x, dt)
        w, ids, _ = MM.route(jnp.asarray(router), jx, moe, train=False)

        def loss(b, xx):
            y = MM.moe_apply({"q4": None, "f16": b}, xx, w, ids, moe, par,
                             act=act)
            return jnp.sum(y.astype(jnp.float32) * r), y

        with use_mesh(mesh):
            (_, y), (gb, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(jb, jx)
        pre = f"{ci}/{variant}/"
        for key, v in bank.items():
            out[pre + "in/" + key] = bits(jb[key])
            out[pre + "grad/" + key] = bits(gb[key])
        out[pre + "in/x"] = bits(jx)
        out[pre + "in/r"] = r
        out[pre + "in/w"] = np.asarray(w)
        out[pre + "in/ids"] = np.asarray(ids)
        out[pre + "y"] = bits(y)
        out[pre + "grad/x"] = bits(gx)
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_moe") / "reference.npz"
    script = _SCRIPT % {"cases": CASES, "D": D, "F": F, "T": T}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert "OK" in r.stdout, r.stdout + r.stderr
    return dict(np.load(path))


def _tensor(a, bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t.view(torch.bfloat16) if bf16 else t


def _run(banks, x, w, ids, moe, par, act):
    leaves = {k: v.clone().requires_grad_(True) for k, v in banks.items()}
    xx = x.clone().requires_grad_(True)
    y = tm.moe_apply({"q4": None, "f16": leaves}, xx, w, ids, moe, par,
                     act=act)
    return y, leaves, xx


@pytest.mark.parametrize("variant", ["exact", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_regime_like_the_reference(reference, case, variant,
                                             monkeypatch):
    shape, axes, dp, e, k, fsdp, force, regime = CASES[case]
    ci = list(CASES).index(case)
    pre = f"{ci}/{variant}/"
    bf16 = variant == "exact"
    act = "relu2" if bf16 else "swiglu"
    monkeypatch.setattr(tm, "TOKEN_GATHER_MAX_BYTES",
                        0 if force else 64 << 20)
    n = int(np.prod(shape))
    mesh = make_test_mesh(shape, axes, devices=["cpu"] * n)
    par = tm.MoEParallelism(mesh=mesh, dp_axes=dp, fsdp_axis=fsdp)
    moe = MoEConfig(num_experts=e, top_k=k, d_ff_expert=F,
                    capacity_factor=2.0)
    banks = {key: _tensor(reference[pre + "in/" + key], bf16)
             for key in ("w_gate", "w_up", "w_down")}
    x = _tensor(reference[pre + "in/x"], bf16)
    w = torch.from_numpy(reference[pre + "in/w"])
    ids = torch.from_numpy(reference[pre + "in/ids"]).long()
    r = torch.from_numpy(reference[pre + "in/r"])
    # the regime the gate takes is the one the case names
    ep = e >= mesh.sizes["model"]
    tg = tm._fsdp_active({"f16": banks}, moe, par, ep) and \
        T // int(np.prod([mesh.sizes[a] for a in dp])) * par.fsdp_size \
        * D * 2 <= tm.TOKEN_GATHER_MAX_BYTES
    assert regime == ("token-gather" if tg else
                      "data x EP" if ep else "TP")
    y, leaves, xx = _run(banks, x, w, ids, moe, par, act)
    (y.to(torch.float32) * r).sum().backward()
    want = _tensor(reference[pre + "y"], bf16)
    if bf16:
        assert torch.equal(y.view(torch.int16), want.view(torch.int16)), \
            f"{int((y != want).sum())} of {y.numel()} differ"
    else:
        bar = 1e-6 * float(want.abs().max())
        assert float((y - want).abs().max()) <= bar
    grads = dict(leaves, x=xx)
    for key, leaf in grads.items():
        g = _tensor(reference[pre + "grad/" + key], bf16).to(torch.float32)
        got = torch.zeros_like(g) if leaf.grad is None \
            else leaf.grad.to(torch.float32)    # relu^2 leaves w_gate unused
        tol = (1e-2 if bf16 else 1e-5) * max(float(g.abs().max()), 1e-30)
        assert float((got - g).abs().max()) <= tol, key
    # the placed per-position shards give the same bytes
    placed = tm.moe_apply(tm.shard_banks({"q4": None, "f16": banks}, mesh),
                          x, w, ids, moe, par, act=act)
    assert torch.equal(placed.view(torch.int16) if bf16 else placed,
                       y.detach().view(torch.int16) if bf16 else y.detach())


def test_regimes_raise_what_the_reference_cannot_run():
    """Tokens that do not split over the data ranks, and an EP bank that
    does not split over the model ranks."""
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    par = tm.MoEParallelism(mesh=mesh, dp_axes=("data",), fsdp_axis="data")
    moe = MoEConfig(num_experts=8, top_k=2, d_ff_expert=F)
    g = torch.Generator().manual_seed(0)
    banks = {"q4": None, "f16": {
        "w_gate": torch.randn(8, D, F, generator=g),
        "w_up": torch.randn(8, D, F, generator=g),
        "w_down": torch.randn(8, F, D, generator=g)}}
    x = torch.randn(5, D, generator=g)
    w, ids = tm.route(torch.randn(D, 8, generator=g), x, moe)
    with pytest.raises(ValueError, match="do not split over 2 data ranks"):
        tm.moe_apply(banks, x, w, ids, moe, par)
    odd = {"q4": None, "f16": {k: v[:6] for k, v in banks["f16"].items()}}
    with pytest.raises(ValueError, match="EP banks must split evenly"):
        tm.shard_banks(odd, make_test_mesh((1, 4), devices=["cpu"] * 4))
