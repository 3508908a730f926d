"""The port's examples run end to end on the CPU (``--device cpu``): the
quickstart trains and serves under three budgets, the elastic example
survives its injected failure and converges, ``serve_adaptive`` serves
six Poisson-driven phases under the QoS controller, ``multi_tenant``
passes its own asserted per-tenant trace, and ``pareto_explorer``
(host-only, no device) prints the reference's table and queries when
given the reference's hardware model. Each example that takes a device
defaults to the card."""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from repro.core.cost_model import HardwareModel as JHardwareModel
from repro_torch.core.cost_model import HardwareModel
from repro_torch.examples import (elastic_restart, multi_tenant,
                                  pareto_explorer, quickstart,
                                  serve_adaptive)


def test_quickstart_trains_and_serves(capsys):
    quickstart.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert out.count("[4] budget=") == 3 and out.count("[5] plan[") == 3
    assert "step    2  nll=" in out and "sample output" in out


def test_elastic_restart_recovers_and_converges(capsys):
    elastic_restart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[restore] resumed from step 20" in out
    assert "1 failure(s), rescales at [30]" in out
    assert out.rstrip().endswith("training converged.")


def test_serve_adaptive_runs_every_phase(capsys):
    serve_adaptive.main(["--device", "cpu"])
    out = capsys.readouterr().out
    n = len(serve_adaptive.TRACE)
    assert all(f"[t={i}] target[" in out for i in range(n))
    assert out.count("phase latency p50") == n
    total = n * serve_adaptive.REQUESTS_PER_PHASE
    assert f"{total} done total" in out
    assert "totals: " in out and "deadlines met" in out


def test_multi_tenant_trace_asserted(capsys):
    multi_tenant.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[shrink] " in out and "[phase-2] batch" in out
    assert out.rstrip().endswith("[mt] OK — per-tenant trace asserted")


@pytest.mark.parametrize("argv", [[], ["--ladder", "16,8,4",
                                       "--min-tps", "5",
                                       "--max-ppl-x", "1.05"]])
def test_pareto_explorer_matches_reference(monkeypatch, capsys, argv):
    """Given the reference's hardware model, every line but the header's
    hardware name is the reference example's."""
    path = Path(__file__).resolve().parents[1] / "examples" \
        / "pareto_explorer.py"
    spec = importlib.util.spec_from_file_location("ref_pareto", path)
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    monkeypatch.setattr(sys, "argv", ["pareto_explorer"] + argv)
    jmod.main()
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(pareto_explorer, "HardwareModel", lambda: (
        HardwareModel(**dataclasses.asdict(JHardwareModel()))))
    pareto_explorer.main(argv)
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0].replace("v5e-chip model", "H100 model")
    assert got[1:] == want[1:] and len(got) > 10


@pytest.mark.parametrize("example", [quickstart, elastic_restart,
                                     serve_adaptive, multi_tenant])
def test_examples_default_to_the_card(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
