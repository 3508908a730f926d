"""The port's train CLI (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``), run in process at the smoke scale.

Both start from the same weights by resuming from copies of one
checkpoint that the reference wrote (each package's fresh params come
from its own generator): they print the same steps with nll within 1e-3
relative. A checkpoint the port wrote resumes in the reference the same
way, and the port's own resume is bit-equal to a straight run."""
import re
import shutil
import sys

import pytest
import torch

from repro.launch import train as J
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.launch import train as T
from repro_torch.training.optimizer import tree_leaves

STEP = re.compile(r"step\s+(\d+) nll=([0-9.]+) gnorm=([0-9.]+) tok/s=")
COMMON = ["--batch", "2", "--seq", "32", "--log-every", "1"]


def run_ref(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    capsys.readouterr()
    J.main()
    return capsys.readouterr().out


def run_port(capsys, argv):
    capsys.readouterr()
    T.main(["--device", "cpu"] + argv)
    return capsys.readouterr().out


def steps(out):
    return [(int(s), float(n)) for s, n, _ in STEP.findall(out)]


def assert_same_steps(got, want):
    assert [s for s, _ in got] == [s for s, _ in want] and got
    for (s, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-3), f"step {s}: {a} vs {b}"


@pytest.fixture(scope="module", params=["smollm-360m", "mixtral-8x7b"])
def ref_ckpt(request, tmp_path_factory):
    """A 2-step reference run's checkpoint (step 2)."""
    d = tmp_path_factory.mktemp("ref_ckpt")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys, "argv", ["train", "--arch", request.param,
                                 "--steps", "2", "--ckpt-dir", str(d),
                                 "--ckpt-every", "2"] + COMMON)
        J.main()
    finally:
        mp.undo()
    return request.param, d


def test_both_clis_resume_a_reference_checkpoint(ref_ckpt, tmp_path,
                                                 monkeypatch, capsys):
    arch, src = ref_ckpt
    argv = ["--arch", arch, "--steps", "5", "--resume"] + COMMON
    shutil.copytree(src, tmp_path / "j")
    shutil.copytree(src, tmp_path / "t")
    want = run_ref(monkeypatch, capsys,
                   argv + ["--ckpt-dir", str(tmp_path / "j")])
    got = run_port(capsys, argv + ["--ckpt-dir", str(tmp_path / "t")])
    assert "[train] resumed from step 2" in got
    assert "[train] final checkpoint at step 5" in got
    assert_same_steps(steps(got), steps(want))
    assert [s for s, _ in steps(got)] == [2, 3, 4]


def test_reference_resumes_a_port_checkpoint(tmp_path, monkeypatch,
                                             capsys):
    arch = "smollm-360m"
    run_port(capsys, ["--arch", arch, "--steps", "2", "--ckpt-dir",
                      str(tmp_path / "src"), "--ckpt-every", "2"] + COMMON)
    shutil.copytree(tmp_path / "src", tmp_path / "j")
    shutil.copytree(tmp_path / "src", tmp_path / "t")
    argv = ["--arch", arch, "--steps", "4", "--resume"] + COMMON
    want = run_ref(monkeypatch, capsys,
                   argv + ["--ckpt-dir", str(tmp_path / "j")])
    got = run_port(capsys, argv + ["--ckpt-dir", str(tmp_path / "t")])
    assert "[train] resumed from step 2" in want
    assert_same_steps(steps(got), steps(want))


@pytest.mark.parametrize("extra", [[], ["--optimizer", "adafactor",
                                        "--microbatches", "2"]])
def test_port_resume_is_bit_equal_to_a_straight_run(tmp_path, capsys,
                                                    extra):
    """6 steps with a checkpoint every 3, then a restart from step 3: the
    final params, optimizer state and pipeline cursor equal the straight
    run's bit for bit."""
    argv = ["--arch", "mixtral-8x7b", "--steps", "6", "--ckpt-every",
            "3"] + COMMON + extra
    straight = run_port(capsys, argv + ["--ckpt-dir", str(tmp_path / "a")])
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_3", tmp_path / "b" / "step_3")
    (tmp_path / "b" / "step_3.COMMITTED").touch()
    resumed = run_port(capsys, argv + ["--resume", "--ckpt-dir",
                                       str(tmp_path / "b")])
    assert "[train] resumed from step 3" in resumed
    assert steps(resumed) == steps(straight)[3:]
    a, ma = CheckpointManager(str(tmp_path / "a")).restore(6)
    b, mb = CheckpointManager(str(tmp_path / "b")).restore(6)
    assert ma["extra"] == mb["extra"]
    assert ma["extra"]["step"] == 6
    flat_a, flat_b = dict(tree_leaves(a)), dict(tree_leaves(b))
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        x, y = flat_a[k], flat_b[k]
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8)), k


def test_mesh_raises_not_implemented(capsys):
    """``--mesh`` used to raise; now ``--mesh 1,1`` and ``--mesh 2,2``
    on CPU device lists train and print their mesh."""
    for mesh, devices in (("1,1", "cpu"), ("2,2", "cpu,cpu,cpu,cpu")):
        T.main(["--device", devices, "--arch", "smollm-360m", "--mesh",
                mesh, "--steps", "2", "--batch", "2", "--seq", "16"])
        out = capsys.readouterr().out
        assert f"mesh={mesh.replace(',', 'x')}" in out
        assert len(re.findall(r"step +\d+ nll=[0-9.]+", out)) == 2, out


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--arch", "smollm-360m", "--steps", "1"])
