"""The port's roofline (``repro_torch.roofline``) against the reference's.

* ``analysis``: the same numbers in each package's record format, loaded
  with the reference's TPU v5e constants passed into the port's
  ``Hardware`` (the port defines only the H100), give the same terms,
  bound, dominant term, MFU bound, useful ratio, table rows and picks;
* ``op_count`` on smoke Mixtral's decode, prefill and train step counts
  the same FLOPs, bytes, collective bytes, op sequence and peak bytes on
  ``["cpu"] * n`` as on ``["meta"] * n`` at (1, 1) and (2, 2);
* the matmul FLOPs of decode and prefill at (1, 1) equal the reference's
  ``hlo_parse.cost_summary`` of the compiled cell (one subprocess); the
  train step's equal it once the port's one-hot embedding backward
  product (``models/layers.py`` ``_Embed``, 2·V·N·d per microbatch) is
  taken off, with no residual;
* the collective payloads of one MoE layer under data × EP and
  token-gather on (2, 2), computed by hand;
* the byte conventions of single ops, and the dispatch's static count
  (``mixed_moe.bucket_starts``) against ``torch.bincount``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.roofline import analysis as ref_analysis
from repro_torch.configs import ShapeConfig, get_config, reduce_for_smoke
from repro_torch.core import mixed_moe
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.roofline import analysis as A
from repro_torch.roofline.op_count import OpCounter

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMOKE = reduce_for_smoke(get_config("mixtral-8x7b"))
# (seq_len, global_batch, kind): a 32-token decode cache, a 16-token
# prefill, two microbatches of 16 tokens
STEPS = {"decode": (32, 4, "decode"), "prefill": (16, 4, "prefill"),
         "train": (16, 2, "train")}

# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

# (arch, shape, mesh, flops, bytes, collective bytes, peak GiB, active B)
RECORDS = [
    ("mixtral-8x7b", "decode_32k", "pod16x16", 3.1e11, 2.2e10, 4.0e9, 21.5,
     12.9),
    ("mixtral-8x7b", "train_4k", "pod16x16", 9.7e15, 6.1e13, 9.0e11, 70.2,
     12.9),
    ("qwen3-8b", "prefill_32k", "pod16x16", 2.4e15, 1.1e12, 0.0, 33.0, 8.2),
    ("qwen3-8b", "train_4k", "pod2x16x16", 3.3e15, 4.0e13, 2.0e11, 44.1,
     8.2),
    ("rwkv6-3b", "long_500k", "pod16x16", 7.0e9, 6.5e9, 1.0e8, 6.0, 3.1),
]


def _write(tmp, rec_fmt):
    tmp.mkdir()
    for arch, shape, mesh, fl, by, co, peak, act in RECORDS:
        base = {"arch": arch, "shape": shape, "mesh": mesh, "ok": True,
                "params_b": act, "active_params_b": act,
                "memory": {"peak_per_device_gib": peak},
                "collectives": {"total_bytes": co}}
        base.update(rec_fmt(fl, by))
        (tmp / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(base))
    return tmp


def test_analysis_equals_the_reference_on_the_same_numbers(tmp_path):
    ref_dir = _write(tmp_path / "ref", lambda fl, by: {
        "hlo_cost": {"flops": fl, "bytes_accessed": 2 * by},
        "hlo_cost_tpu": {"bytes_accessed": by}})
    port_dir = _write(tmp_path / "port", lambda fl, by: {
        "cost": {"flops": fl, "bytes_accessed": by}, "trace_s": 1.5})
    v5e = ref_analysis.V5E
    hw = A.Hardware(name=v5e.name, peak_flops=v5e.peak_flops,
                    hbm_bw=v5e.hbm_bw, link_bw=v5e.ici_bw,
                    hbm_bytes=v5e.hbm_bytes)
    ref = ref_analysis.load_all(ref_dir)
    port = A.load_all(port_dir, hw=hw)
    assert len(ref) == len(port) == len(RECORDS)
    for r, p in zip(ref, port):
        assert (r.arch, r.shape, r.mesh, r.chips, r.tokens) == \
            (p.arch, p.shape, p.mesh, p.chips, p.tokens)
        for f in ("t_compute", "t_memory", "t_collective", "t_model",
                  "model_flops", "useful_ratio", "bound", "mfu_bound"):
            assert getattr(r, f) == getattr(p, f), f
        assert r.dominant == p.dominant
        assert (r.hlo_flops, r.hlo_bytes) == (p.op_flops, p.op_bytes)
    # the port's table is the reference's with the host seconds appended
    ref_rows = ref_analysis.markdown_table(ref).splitlines()
    port_rows = A.markdown_table(port).splitlines()
    assert [row.rsplit("|", 2)[0] + "|" for row in port_rows[2:]] == \
        ref_rows[2:]
    assert all(row.endswith("| 1.50 |") for row in port_rows[2:])
    picks = {k: (c.arch, c.shape, c.mesh)
             for k, c in A.pick_hillclimb_cells(port).items()}
    assert picks == {k: (c.arch, c.shape, c.mesh) for k, c in
                     ref_analysis.pick_hillclimb_cells(ref).items()}
    for c in port:
        assert c.advice()


def test_h100_constants_and_load_cell_defaults(tmp_path):
    assert (A.H100.peak_flops, A.H100.hbm_bw, A.H100.hbm_bytes) == \
        (989e12, 3.35e12, 80e9)
    assert A.H100.link_bw == 450e9
    path = tmp_path / "x__decode_32k__pod16x16.json"
    path.write_text(json.dumps({
        "arch": "x", "shape": "decode_32k", "mesh": "pod16x16", "ok": True,
        "active_params_b": 1.0, "cost": {"flops": 989e9,
                                         "bytes_accessed": 6.7e9},
        "collectives": {"total_bytes": 450e6}, "trace_s": 2.0}))
    c = A.load_cell(path)
    assert (c.t_compute, c.t_memory, c.t_collective) == \
        pytest.approx((1e-3, 2e-3, 1e-3))
    assert c.dominant == "memory" and c.bound == pytest.approx(2e-3)
    assert c.trace_s == 2.0
    failed = tmp_path / "y__decode_32k__pod16x16.json"
    failed.write_text('{"ok": false}')
    assert A.load_cell(failed) is None


# ---------------------------------------------------------------------------
# op_count: meta == real, and the reference's HLO FLOPs
# ---------------------------------------------------------------------------

def _count(kind: str, mesh_shape, device: str):
    seq, batch, k = STEPS[kind]
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_test_mesh(mesh_shape, devices=[device] * n)
    with use_mesh(mesh):
        step, args = D.build_cell(SMOKE, ShapeConfig(kind, seq, batch, k),
                                  mesh)
        counter, _ = D.count_step(step, args, n)
    return counter


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("kind", list(STEPS))
def test_meta_counts_equal_real_counts(kind, mesh_shape):
    real = _count(kind, mesh_shape, "cpu")
    meta = _count(kind, mesh_shape, "meta")
    assert real.digest() == meta.digest()          # the same op sequence
    assert real.cost_summary() == meta.cost_summary()
    assert real.collective_summary() == meta.collective_summary()
    assert real.memory() == meta.memory()
    assert real.cost_summary()["flops"] > 0
    if mesh_shape == (2, 2):
        assert meta.collective_summary()["total_bytes"] > 0


_REF = r"""
import json, sys
import jax
from repro.configs import get_config, reduce_for_smoke
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import build_cell
from repro.launch.mesh import make_test_mesh, use_mesh
from repro.roofline.hlo_parse import cost_summary

cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
mesh = make_test_mesh((1, 1))
out = {}
for name, (seq, batch, kind) in json.loads(sys.argv[1]).items():
    fn, args, in_sh, out_sh, _ = build_cell(
        cfg, ShapeConfig(name, seq, batch, kind), mesh)
    kw = dict(in_shardings=in_sh)
    if out_sh is not None:
        kw["out_shardings"] = out_sh
    with use_mesh(mesh):
        hlo = jax.jit(fn, **kw).lower(*args).compile().as_text()
    out[name] = cost_summary(hlo)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_hlo_costs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, json.dumps(STEPS)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_matmul_flops_equal_the_reference_hlo(kind, reference_hlo_costs):
    port = _count(kind, (1, 1), "meta").cost_summary()
    ref = reference_hlo_costs[kind]
    assert port["flops"] == ref["flops"]
    assert port["dot_count"] == ref["dot_count"]


def test_train_flops_equal_the_reference_hlo_but_the_embed_product(
        reference_hlo_costs):
    """The port's embedding backward is a product with the one-hot matrix
    of the ids (V x N by N x d per microbatch, deterministic on the card);
    the reference's is a scatter-add, which counts no FLOPs. Taken off,
    the residual must be 0 (tolerance: none, both counts are exact
    integers)."""
    seq, batch, _ = STEPS["train"]
    port = _count("train", (1, 1), "meta").cost_summary()
    ref = reference_hlo_costs["train"]
    micro = batch                      # one sequence per microbatch
    onehot = micro * 2 * SMOKE.padded_vocab * seq * SMOKE.d_model
    residual = port["flops"] - onehot - ref["flops"]
    assert residual == 0
    assert port["dot_count"] - micro == ref["dot_count"]


# ---------------------------------------------------------------------------
# collective payloads of one MoE layer on (2, 2), by hand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", ["data x EP", "token-gather"])
def test_moe_layer_collective_payloads(regime, monkeypatch):
    if regime == "data x EP":          # past the gate at any token count
        monkeypatch.setattr(mixed_moe, "TOKEN_GATHER_MAX_BYTES", 0)
    t, d, f, e, k = 16, 64, 64, 8, 2
    gen = torch.Generator().manual_seed(0)
    banks = {"q4": None, "f16": {
        name: (torch.randn(shape, generator=gen) * 0.1).to(torch.bfloat16)
        for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                            ("w_down", (e, f, d)))}}
    x = torch.randn((t, d), generator=gen).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.stack([rng.choice(e, k, replace=False)
                                     for _ in range(t)]))
    weights = torch.full((t, k), 0.5)
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    par = mixed_moe.MoEParallelism(mesh=mesh, dp_axes=("data",),
                                   fsdp_axis="data")
    assert mixed_moe.moe_regime(banks, t, d, SMOKE.moe, par) == regime
    placed = mixed_moe.shard_banks(banks, mesh, fsdp_axis="data")
    with OpCounter(4) as c:
        mixed_moe.moe_apply(placed, x, weights, ids, SMOKE.moe, par)
    t_loc = t // 2
    row = d * 2 + k * 4 + k * 8        # x bf16, weights f32, ids int64
    b = t_loc * d * 2                  # one data rank's output, bf16
    seen = t if regime == "token-gather" else t_loc   # rows per position
    # the home sends all four positions' rows (its own included) and
    # receives both data ranks' model sums; the others receive their rows
    # and send their part of their data rank's sum
    want = {"scatter_bytes": 4 * seen * row, "all-reduce_bytes": 2 * b,
            "reduce-scatter_bytes": 0, "all-gather_bytes": 0}
    if regime == "token-gather":
        # every position reduce-scatters its (t, d) outputs over data
        want["reduce-scatter_bytes"] = 2 * b
    got = c.collective_summary()
    assert got["position"] == 0
    assert {key: got[key] for key in want} == want
    assert got["total_bytes"] == sum(want.values())
    others = [sum(c.coll[kind][p] for kind in c.coll) for p in (1, 2, 3)]
    assert others == [seen * row + b + want["reduce-scatter_bytes"]] * 3
    assert got["scatter_count"] == 3 and got["all-reduce_count"] == 1


# ---------------------------------------------------------------------------
# op conventions and the static count
# ---------------------------------------------------------------------------

def test_op_byte_conventions():
    a = torch.randn(8, 16)
    b = torch.randn(16, 4)
    idx = torch.tensor([1, 3, 5])
    with OpCounter(1) as c:
        a.reshape(16, 8).t()                   # views: nothing
        a @ b                                  # 2*8*16*4 FLOPs
        a[idx]                                 # rows: 3 x 16 f32
        dst = torch.empty(8, 16)               # empty: 0 bytes
        dst.copy_(a)                           # read a, write dst
        dst[idx] = torch.zeros(3, 16)          # zeros + indexed write
    assert c.flops == [2 * 8 * 16 * 4] and c.dots == [1]
    mm = (8 * 16 + 16 * 4 + 8 * 4) * 4
    index = 3 * 8 + 2 * 3 * 16 * 4
    copy = 2 * 8 * 16 * 4
    zeros = 3 * 16 * 4
    put = 3 * 8 + 3 * 16 * 4 + 3 * 16 * 4
    assert c.bytes == [mm + index + copy + zeros + put]
    assert set(c.by_op) == {"aten.mm.default", "aten.index.Tensor",
                            "aten.empty.memory_format", "aten.copy_.default",
                            "aten.zeros.default", "aten.index_put_.default"}


def test_live_bytes_peak_and_arguments():
    w = torch.randn(32, 32)
    with OpCounter(1) as c:
        c.place({"w": w, "again": w[1:]})      # one storage, counted once
        y = w @ w                              # 4 KiB made
        z = y + 1                              # 4 KiB more: peak 8 KiB
        del y                                  # freed
        c.outputs(z)
    assert c.args == [32 * 32 * 4]
    assert c.peak == [2 * 32 * 32 * 4] and c.live == [32 * 32 * 4]
    mem = c.memory()
    assert mem["output_bytes"] == 32 * 32 * 4
    assert mem["peak_per_device_gib"] == 3 * 32 * 32 * 4 / 2**30


@pytest.mark.parametrize("e_loc", [1, 3, 8, 48])
def test_bucket_starts_equal_bincount(e_loc):
    rng = np.random.default_rng(e_loc)
    for n in (0, 1, 7, 200):
        ids = torch.from_numpy(rng.integers(0, e_loc + 1, n))  # + sentinel
        sorted_e = torch.sort(ids, stable=True).values
        counts = torch.bincount(sorted_e, minlength=e_loc + 1)
        want = torch.cumsum(counts, 0) - counts
        got = mixed_moe.bucket_starts(sorted_e, e_loc + 1)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
