"""The port's dry run (``repro_torch.launch.dryrun``) and the cell list it
sweeps (``repro_torch.configs.all_cells``).

* ``all_cells()`` is the reference's list, in its order;
* ``run_cell`` and the CLI on the smoke Mixtral over a (2, 2) mesh of
  ``meta`` positions (the production mesh and config swapped for smoke
  ones, so no production cell runs here) write one well-formed record: the
  reference's keys, per-position memory, cost and collectives and
  ``trace_s``; a second CLI run skips the cached cell, and the port's
  ``analysis`` reads the record;
* a failing cell is recorded with its error, and the CLI exits 1;
* the dry run's train step (``remat="full"``) on a (2, 2) mesh runs with
  no ambient mesh and with its backward in another thread, as autograd
  runs a card's backward: the recompute takes the attention spelling the
  forward chose under its activation rules (it raised ``CheckpointError``
  before ``dist.sharding.under_current_rules``).
"""
import json
import sys
import threading

import pytest
import torch

from repro.configs import all_cells as ref_all_cells
from repro_torch.configs import (ShapeConfig, all_cells, get_config,
                                 reduce_for_smoke)
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.roofline import analysis as A


def test_all_cells_are_the_references():
    assert list(all_cells()) == list(ref_all_cells())


@pytest.fixture
def smoke_cells(monkeypatch, tmp_path):
    """``run_cell`` on the smoke config over a (2, 2) meta mesh, writing
    under ``tmp_path``."""
    monkeypatch.setattr(D, "get_config",
                        lambda arch: reduce_for_smoke(get_config(arch)))
    monkeypatch.setattr(
        D, "make_production_mesh", lambda multi_pod, devices:
        make_test_mesh((2, 2), devices=devices[:4]))
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    return tmp_path


def test_run_cell_writes_a_well_formed_record(smoke_cells):
    rec = D.run_cell("mixtral-8x7b", "decode_32k", False)
    path = smoke_cells / "mixtral-8x7b__decode_32k__pod16x16.json"
    assert json.loads(path.read_text()) == rec
    assert rec["ok"], rec.get("traceback")
    for key in ("arch", "shape", "mesh", "params_b", "active_params_b",
                "build_s", "trace_s", "total_s", "memory", "cost",
                "collectives"):
        assert key in rec, key
    mem = rec["memory"]
    assert len(mem["per_position_gib"]) == 4
    assert mem["position"] == 0 and mem["argument_bytes"] > 0
    assert mem["peak_per_device_gib"] == max(mem["per_position_gib"])
    assert mem["peak_per_device_gib"] == (
        mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
    cost = rec["cost"]
    assert cost["flops"] == max(cost["per_position"]["flops"]) > 0
    assert cost["dot_count"] > 0 and cost["bytes_accessed"] > 0
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0 and coll["scatter_count"] > 0
    cell = A.load_cell(path)
    assert cell.op_flops == cost["flops"] and cell.trace_s == rec["trace_s"]
    assert cell.bound > 0


def test_cli_runs_a_cell_then_skips_it(smoke_cells, monkeypatch, capsys):
    argv = ["dryrun", "--arch", "mixtral-8x7b", "--shape", "decode_32k"]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(SystemExit) as done:
        D.main()
    assert done.value.code == 0
    assert "[OK ] mixtral-8x7b" in capsys.readouterr().out
    with pytest.raises(SystemExit) as done:
        D.main()
    assert done.value.code == 0
    assert "[skip] mixtral-8x7b decode_32k pod16x16 (cached ok)" in \
        capsys.readouterr().out
    monkeypatch.setattr(A, "RESULTS", smoke_cells)
    monkeypatch.setattr(sys, "argv", ["analysis", "--pick"])
    A.main()
    out = capsys.readouterr().out
    assert "| mixtral-8x7b | decode_32k | pod16x16 |" in out
    assert "paper-representative   mixtral-8x7b decode_32k" in out


def test_a_failing_cell_is_recorded(smoke_cells, monkeypatch):
    def boom(*a):
        raise RuntimeError("no such layout")
    monkeypatch.setattr(D, "build_cell", boom)
    rec = D.run_cell("qwen3-8b", "decode_32k", False)
    assert not rec["ok"]
    assert rec["error"] == "RuntimeError: no such layout"
    assert "boom" in rec["traceback"]
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "qwen3-8b",
                                      "--shape", "decode_32k"])
    with pytest.raises(SystemExit) as done:
        D.main()
    assert done.value.code == 1


@pytest.mark.parametrize("where", ["this thread", "another thread"])
def test_remat_recompute_takes_the_forwards_attention_spelling(where):
    cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    step, args = D.build_cell(cfg, ShapeConfig("t", 16, 2, "train"), mesh)
    out, errors = [], []

    def run():
        try:
            out.append(step(*args))
        except Exception as e:          # noqa: BLE001 (asserted below)
            errors.append(e)

    if where == "this thread":
        run()
    else:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    metrics = out[0][2]
    assert torch.isfinite(metrics["nll"]) and metrics["grad_norm"] > 0
