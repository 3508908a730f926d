"""The port's elastic-recovery policies (a numpy-only copy) against the
reference's: the same heartbeats, timings, worker counts and failure
schedules give the same decisions and the same recovery history."""
import numpy as np
import pytest

from repro.ft import elastic as J
from repro_torch.ft import elastic as T


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def detector_trace(mod):
    clk = Clock()
    d = mod.HeartbeatFailureDetector([f"w{i}" for i in range(6)],
                                     timeout_s=10, clock=clk)
    out = []
    for t, beats, dead in ((5, ["w0", "w1", "w2"], None),
                           (12, ["w0"], "w4"), (25, ["w0", "w3"], None)):
        clk.t = t
        for w in beats:
            d.heartbeat(w)
        if dead:
            d.mark_failed(dead)
        out.append((d.failed(), d.healthy()))
    return out


def test_failure_detector_replay_equal():
    assert detector_trace(T) == detector_trace(J)


def straggler_trace(mod, seed):
    workers = [f"w{i}" for i in range(8)]
    m = mod.StragglerMonitor(workers, window=4, z_thresh=3.0, patience=2)
    rng = np.random.default_rng(seed)
    out = []
    for step in range(10):
        t = {w: 1.0 + rng.normal() * 0.01 for w in workers}
        if step >= 3:
            t["w5"] = 2.0
        m.record_step(t)
        out.append((m.quarantine(), dict(m.strikes)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_replay_equal(seed):
    assert straggler_trace(T, seed) == straggler_trace(J, seed)


@pytest.mark.parametrize("n", [512, 256, 511, 300, 64, 16, 17])
def test_plan_mesh_equal(n):
    a, b = T.plan_mesh(n), J.plan_mesh(n)
    assert (a.n_workers, a.mesh_shape, a.mesh_axes, a.dropped_workers,
            a.degraded) == (b.n_workers, b.mesh_shape, b.mesh_axes,
                            b.dropped_workers, b.degraded)
    with pytest.raises(RuntimeError):
        T.plan_mesh(8)


@pytest.mark.parametrize("old,new", [(32, 16), (16, 4), (8, 8), (5, 3)])
def test_remap_equal(old, new):
    assert T.remap_data_shards(old, new, 7) == J.remap_data_shards(old, new,
                                                                   7)


def recovery_trace(mod):
    log = []
    clk = Clock()
    det = mod.HeartbeatFailureDetector([f"w{i:03d}" for i in range(512)],
                                       timeout_s=1e9, clock=clk)
    saved = {"step": 0}
    fails = {7: "w003", 19: "w100"}

    def step_fn(step):
        if step in fails:
            raise mod.WorkerFailure(fails.pop(step), "(injected)")
        log.append(("step", step))

    def save_fn(step):
        saved["step"] = step
        log.append(("save", step))

    def restore_fn():
        log.append(("restore", saved["step"]))
        return saved["step"]

    def on_rescale(plan, dead):
        log.append(("rescale", plan.mesh_shape, tuple(dead)))

    hist = mod.run_with_recovery(step_fn=step_fn, save_fn=save_fn,
                                 restore_fn=restore_fn, detector=det,
                                 max_steps=30, checkpoint_every=5,
                                 on_rescale=on_rescale)
    return hist, log


def test_run_with_recovery_replay_equal():
    assert recovery_trace(T) == recovery_trace(J)
    with pytest.raises(T.WorkerFailure):
        det = T.HeartbeatFailureDetector(["w0"], timeout_s=1e9)

        def always(step):
            raise T.WorkerFailure("w0")

        T.run_with_recovery(step_fn=always, save_fn=None, restore_fn=None,
                            detector=det, max_steps=3, max_failures=2)
