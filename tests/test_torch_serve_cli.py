"""The port's serving CLI (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), both run in process on the CPU
(``--device cpu`` for the port) with ``--temperature 0``:

* the same ``target[...] -> ...`` and imperative plan lines, the same
  greedy tokens of the first requests, the same dynamic-precision line,
  and in ``--tenants`` mode the same phases, per-tenant points, replan
  reports and request counts;
* both CLIs get the same weights (the reference's ``model.init(key(i))``,
  handed to the port through ``params_from_numpy`` in place of its own
  ``init_params(cfg, seed=i)``) and the same hardware model (the
  reference's defaults with a fixed 24 GB/s host link, in place of each
  engine's measured link), so the frontier points are equal;
* the smoke model runs in float32 in both: in bf16 the two frameworks'
  router probabilities differ by up to 2.6e-3, which flips an expert at
  a router near-tie, while in float32 they differ by 2.1e-7;
* in bf16, the served dtype, the lines no near-tie can move (targets,
  plans, phases, per-tenant points, the arbiter summary) must agree;
* ``--ckpt-dir`` on one float32 checkpoint (written by either package):
  the same restore, target, plan and token lines.

Printed times, tokens/s and latency percentiles are measurements and are
not compared."""
import dataclasses
import re
import sys

import jax
import numpy as np
import pytest

import repro.launch.serve as jserve
import repro.serving.engine as jengine
import repro_torch.launch.serve as tserve
import repro_torch.serving.engine as tengine
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.core.sensitivity import SensitivityProfile as JProfile
from repro.models.model import build_model as jbuild_model
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.sensitivity import SensitivityProfile
from repro_torch.models.model import params_from_numpy

LINK_BW = 24e9


def _clis(monkeypatch, capsys, dtype):
    """Both CLIs on one smoke model in ``dtype``, one hardware model and
    the reference's weights; returns run(package, argv) -> stdout lines."""
    jget, tget = jserve.get_config, tserve.get_config
    monkeypatch.setattr(jserve, "get_config",
                        lambda a: jget(a).replace(dtype=dtype))
    monkeypatch.setattr(tserve, "get_config",
                        lambda a: tget(a).replace(dtype=dtype))
    monkeypatch.setattr(jengine, "measure_host_link_bw",
                        lambda *a, **k: LINK_BW)
    monkeypatch.setattr(tengine, "measure_host_link_bw",
                        lambda *a, **k: LINK_BW)
    ref_hw = dataclasses.asdict(JHardwareModel())
    monkeypatch.setattr(tengine, "HardwareModel",
                        lambda **kw: HardwareModel(**{**ref_hw, **kw}))

    def port_init(cfg, seed=0, *, device=None):
        from repro.configs import get_config, reduce_for_smoke
        jcfg = reduce_for_smoke(get_config(cfg.arch_id)).replace(
            dtype=dtype, mop=dataclasses.replace(
                get_config(cfg.arch_id).mop, ladder=cfg.mop.ladder))
        p = jbuild_model(jcfg).init(jax.random.key(seed))
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                 device)

    monkeypatch.setattr(tserve, "init_params", port_init)

    def run(pkg, argv):
        capsys.readouterr()
        if pkg == "ref":
            monkeypatch.setattr(sys, "argv", ["serve", *argv])
            jserve.main()
        else:
            tserve.main(["--device", "cpu", *argv])
        return capsys.readouterr().out.splitlines()

    return run


@pytest.fixture()
def clis(monkeypatch, capsys):
    return _clis(monkeypatch, capsys, "float32")


@pytest.fixture()
def clis_bf16(monkeypatch, capsys):
    return _clis(monkeypatch, capsys, "bfloat16")


_TIMED = [(re.compile(r"tok in \d+ ms"), "tok in _ ms"),
          (re.compile(r"p50 \d+ ms p95 \d+ ms"), "p50 _ p95 _"),
          (re.compile(r"derate=\S+"), "derate=_")]


def compared(lines):
    """The lines whose content the CLIs must agree on, with measured
    times masked."""
    keep = []
    for ln in lines:
        if ln.startswith(("[serve] ep=", "  req ", "[serve] precision",
                          "[serve] sensitivity", "[serve] dynamic",
                          "[serve] phase", "[serve]   ", "[serve] multi",
                          "[serve] speculative", "[serve] async")) \
                and "kv[" not in ln and " decode=" not in ln:
            for pat, rep in _TIMED:
                ln = pat.sub(rep, ln)
            keep.append(ln)
    return keep


def test_trace_and_ladder_match_reference(clis, tmp_path):
    """A three-phase trace on the 3-rung ladder: two imperative phases
    (throughput, quality with 8 quantized experts) and a declarative SLO
    phase (the trace's fourth column)."""
    trace = tmp_path / "trace.csv"
    trace.write_text("# budget_gb, preference, num_q, min_tps\n"
                     "0.0003, throughput\n0.00025, quality, 8\n"
                     "0.0003, quality, , 1000\n")
    argv = ["--ladder", "16,8,4", "--trace", str(trace), "--temperature",
            "0", "--requests", "2", "--max-new-tokens", "4",
            "--priority-split"]
    got, want = compared(clis("port", argv)), compared(clis("ref", argv))
    assert got == want
    assert sum(ln.startswith("[serve] ep=1 dp=1 target[") for ln in got) \
        == 1
    assert sum(ln.startswith("[serve] ep=1 dp=1 [") for ln in got) == 2
    assert sum("tokens=[" in ln for ln in got) == 2


def test_profile_and_dynamic_precision_match_reference(clis, tmp_path):
    """``--calibrate`` twice gives the same bytes (loadable by the
    reference), then both CLIs serve with that profile and
    ``--dynamic-precision``."""
    prof = tmp_path / "prof.json"
    cal = ["--ladder", "16,8,4", "--calibrate", "--calibrate-out",
           str(prof)]
    clis("port", cal)
    first = prof.read_bytes()
    clis("port", cal)
    assert prof.read_bytes() == first
    assert JProfile.load(prof).to_json_bytes() == first
    assert not SensitivityProfile.load(prof).is_uniform()
    argv = ["--ladder", "16,8,4", "--profile", str(prof),
            "--dynamic-precision", "--temperature", "0", "--requests", "4",
            "--max-new-tokens", "8", "--speculate", "2"]
    got, want = compared(clis("port", argv)), compared(clis("ref", argv))
    assert got == want
    assert any(ln.startswith("[serve] dynamic precision:") for ln in got)
    assert any("calibrated" in ln for ln in got)


def test_tenants_match_reference(clis, tmp_path):
    """Two tenants under one budget with a budget shift: the same phases,
    per-tenant points, replan reports and request counts."""
    spec = tmp_path / "tenants.json"
    spec.write_text(
        '{"budget_fracs": [0.6, 0.45], "tenants": ['
        '{"name": "chat", "min_tps": null, "weight": 2.0, "priority": 1,'
        ' "deadline_s": 30.0, "requests": 2},'
        '{"name": "batch", "max_ppl_x": 1.1, "requests": 2}]}')
    argv = ["--tenants", str(spec), "--temperature", "0",
            "--max-new-tokens", "4", "--overlap", "on"]
    got, want = compared(clis("port", argv)), compared(clis("ref", argv))
    assert got == want
    assert sum(ln.startswith("[serve] phase") for ln in got) == 2
    assert not [t for t in __import__("threading").enumerate()
                if t.name.startswith("expert-xfer") and t.is_alive()]


def plan_lines(lines):
    """The compared lines that no router near-tie can move: targets,
    plans, phases, per-tenant points and the arbiter summary (no tokens,
    no per-tenant request counts)."""
    return [ln for ln in compared(lines)
            if not ln.startswith("  req ") and " done, " not in ln]


def test_trace_and_ladder_bf16_plans_match_reference(clis_bf16, tmp_path):
    """The served dtype, bf16, on the trace of the float32 test above:
    the same target and plan lines (tolerance: none). Tokens are held to
    the reference in float32 only."""
    trace = tmp_path / "trace.csv"
    trace.write_text("0.0003, throughput\n0.00025, quality, 8\n"
                     "0.0003, quality, , 1000\n")
    argv = ["--ladder", "16,8,4", "--trace", str(trace), "--temperature",
            "0", "--requests", "2", "--max-new-tokens", "4"]
    got = plan_lines(clis_bf16("port", argv))
    want = plan_lines(clis_bf16("ref", argv))
    assert got == want
    assert sum(ln.startswith("[serve] ep=1 dp=1 target[") for ln in got) \
        == 1
    assert sum(ln.startswith("[serve] ep=1 dp=1 [") for ln in got) == 2


def test_tenants_bf16_points_match_reference(clis_bf16, tmp_path):
    """bf16 tenants across a budget shift from 0.9x to 0.35x the summed
    bf16 footprint, which moves the chat tenant's point: the same phases,
    per-tenant points and arbiter summary (tolerance: none)."""
    spec = tmp_path / "tenants.json"
    spec.write_text(
        '{"budget_fracs": [0.9, 0.35], "tenants": ['
        '{"name": "chat", "min_tps": null, "weight": 2.0, "priority": 1,'
        ' "deadline_s": 30.0, "requests": 2},'
        '{"name": "batch", "max_ppl_x": 1.1, "requests": 2}]}')
    argv = ["--tenants", str(spec), "--temperature", "0",
            "--max-new-tokens", "4"]
    got = plan_lines(clis_bf16("port", argv))
    want = plan_lines(clis_bf16("ref", argv))
    assert got == want
    chat = [ln for ln in got if ln.startswith("[serve]   chat: slo")]
    assert len(chat) == 2 and chat[0].split("->")[1] != chat[1].split("->")[1]


def test_ep_dp_raise_the_engine_message(clis, tmp_path):
    """``--ep``/``--dp`` serve (over ``--device cpu`` repeated ep*dp
    times); what the reference's CLI refuses before building a model
    (ep or dp below 1, an expert count that does not divide, ``--tenants``
    or ``--speculate`` with EP/DP) raises the same ``SystemExit``."""
    lines = clis("port", ["--ep", "2", "--dp", "2", "--temperature", "0",
                          "--requests", "4", "--max-new-tokens", "4"])
    assert any(ln.startswith("[serve] ep=2 dp=2 target[") for ln in lines)
    assert any(ln.startswith("[serve] ep=2 dp=2 16 tokens across 2 "
                             "replicas") for ln in lines)
    lines = clis("port", ["--ep", "2", "--temperature", "0",
                          "--requests", "2", "--max-new-tokens", "3"])
    assert any("(1, 2) mesh over cpu, cpu" in ln for ln in lines)
    assert sum(ln.startswith("  req ") for ln in lines) == 2
    spec = tmp_path / "tenants.json"
    spec.write_text('{"tenants": [{"name": "a"}]}')
    for argv in (["--ep", "0"], ["--dp", "0"], ["--ep", "3"],
                 ["--ep", "2", "--tenants", str(spec)],
                 ["--dp", "2", "--speculate", "2"]):
        with pytest.raises(SystemExit) as want:
            clis("ref", argv)
        with pytest.raises(SystemExit) as got:
            clis("port", argv)
        if "--speculate" in argv:   # the reason differs: no jit here
            assert str(got.value).split(" (")[0] \
                == str(want.value).split(" (")[0]
        else:
            assert str(got.value) == str(want.value)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_ckpt_dir_serves_the_checkpoint_like_the_reference(clis, tmp_path,
                                                           writer):
    """Both CLIs serve one float32 checkpoint of trained-layout params
    (seed 7, not the CLIs' own seed 0) through ``--ckpt-dir``: the same
    restore, target, plan and token lines, and other tokens than the
    seed-0 params give. The reference's manager writes the checkpoint as
    ``{"params": ...}``, the port's as the bare params tree; the CLI
    serves ``tree.get("params", tree)`` of either."""
    from repro.configs import get_config, reduce_for_smoke
    from repro.ft.checkpoint import CheckpointManager as JManager
    from repro_torch.ft.checkpoint import CheckpointManager
    cfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(
        dtype="float32")
    params = jax.tree_util.tree_map(
        np.asarray, jbuild_model(cfg).init(jax.random.key(7)))
    if writer == "reference":
        JManager(str(tmp_path), async_save=False).save(
            3, {"params": params, "opt": {"step": np.asarray(3)}})
    else:
        CheckpointManager(str(tmp_path), async_save=False).save(
            3, params_from_numpy(params, "cpu"))
    argv = ["--ladder", "16,8,4", "--temperature", "0", "--requests", "2",
            "--max-new-tokens", "4"]
    got = clis("port", argv + ["--ckpt-dir", str(tmp_path)])
    want = clis("ref", argv + ["--ckpt-dir", str(tmp_path)])
    restored = f"[serve] restored params from {tmp_path}"
    assert restored in got and restored in want
    assert compared(got) == compared(want)
    tokens = [ln for ln in compared(got) if "tokens=[" in ln]
    assert len(tokens) == 2
    fresh = [ln for ln in compared(clis("port", argv)) if "tokens=[" in ln]
    assert fresh != tokens
