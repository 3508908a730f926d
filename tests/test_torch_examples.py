"""The port's training examples run end to end on the CPU (``--device
cpu``): the quickstart trains and serves under three budgets, and the
elastic example survives its injected failure and converges."""
import pytest
import torch

from repro_torch.examples import elastic_restart, quickstart


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


@pytest.mark.parametrize("example", [quickstart, elastic_restart])
def test_examples_default_to_the_card(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
