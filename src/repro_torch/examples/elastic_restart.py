"""Fault tolerance end-to-end (``examples/elastic_restart.py`` of the
reference): train, kill a worker mid-run, rescale the mesh, restore from
the latest checkpoint, and converge to the same loss trajectory. On the
card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart \\
        [--device cpu]

The meshes are stand-ins (one device), but every policy component is the
production one: HeartbeatFailureDetector, plan_mesh, remap_data_shards,
CheckpointManager restore, and the deterministic resumable data
pipeline.
"""
import argparse
import shutil
import tempfile

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import (DataPipeline, SyntheticCorpus,
                                       SyntheticCorpusConfig)
from repro_torch.device import resolve_device
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.elastic import (HeartbeatFailureDetector,
                                    WorkerFailure, plan_mesh,
                                    remap_data_shards, run_with_recovery)
from repro_torch.launch.train import batch_to
from repro_torch.models.model import build_model, init_params
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    model = build_model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=10))
    corpus = SyntheticCorpus(SyntheticCorpusConfig(vocab_size=cfg.vocab_size))

    workers = [f"w{i:03d}" for i in range(512)]
    detector = HeartbeatFailureDetector(workers, timeout_s=1e9)
    ckdir = tempfile.mkdtemp(prefix="elastic_ckpt_")
    mgr = CheckpointManager(ckdir, keep=2)

    state = {
        "params": init_params(cfg, seed=0, device=device),
        "opt": None, "pipe": DataPipeline(corpus, batch=8, seq=64),
        "mesh_plan": plan_mesh(len(workers)),
    }
    state["opt"] = init_train_state(state["params"], tcfg)
    step_fn_ = make_train_step(model.loss_fn, tcfg)
    losses = []
    injected = {"done": False}

    def step_fn(step):
        # inject one failure at step 30 (simulated hardware loss)
        if step == 30 and not injected["done"]:
            injected["done"] = True
            raise WorkerFailure("w007", "(injected: link down)")
        batch = batch_to(state["pipe"].next_batch(), device)
        state["params"], state["opt"], m = step_fn_(
            state["params"], state["opt"], batch)
        losses.append(float(m["nll"]))

    def save_fn(step):
        mgr.save(step, {"params": state["params"], "opt": state["opt"]},
                 extra={"pipe": state["pipe"].state(),
                        "step": step}, block=True)
        print(f"  [ckpt] step {step} saved")

    def restore_fn():
        tree, manifest = mgr.restore(shardings=device)
        state["params"], state["opt"] = tree["params"], tree["opt"]
        state["pipe"].restore(manifest["extra"]["pipe"])
        print(f"  [restore] resumed from step {manifest['extra']['step']}")
        return manifest["extra"]["step"]

    def dp_size(plan):
        shape = plan.mesh_shape
        return shape[-2] * (shape[0] if len(shape) == 3 else 1)

    def on_rescale(plan, dead):
        old_dp, new_dp = dp_size(state["mesh_plan"]), dp_size(plan)
        remap = remap_data_shards(old_dp, new_dp, 0)
        state["mesh_plan"] = plan
        print(f"  [rescale] lost {dead} -> mesh {plan.mesh_shape} "
              f"({plan.dropped_workers} spare); dp {old_dp}->{new_dp}, "
              f"rank0 takes shards {remap[0][:4]}...")

    print(f"mesh {state['mesh_plan'].mesh_shape} | ckpts in {ckdir}")
    save_fn(0)
    hist = run_with_recovery(step_fn=step_fn, save_fn=save_fn,
                             restore_fn=restore_fn, detector=detector,
                             max_steps=60, checkpoint_every=20,
                             on_rescale=on_rescale)
    print(f"\ncompleted {hist['completed']} step-executions "
          f"({hist['failures']} failure(s), rescales at "
          f"{[r[0] for r in hist['rescales']]})")
    print(f"loss: start {losses[0]:.3f} -> end {losses[-1]:.3f} "
          f"(monotone-ish through the failure)")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training did not survive the failure")
    mgr.wait()
    shutil.rmtree(ckdir)
    print("OK — failure injected, mesh rescaled, checkpoint restored, "
          "training converged.")


if __name__ == "__main__":
    main()
