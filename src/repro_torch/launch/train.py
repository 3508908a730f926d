"""Training launcher (``repro.launch.train``), on the card unless
``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 100 --batch 8 --seq 128 [--smoke] [--ckpt-dir DIR] \\
        [--resume] [--microbatches 2] [--device cpu]

``--smoke`` (default on) reduces the config to the same-family smoke
scale; ``--no-smoke`` trains the full config. Fresh params are
``init_params(cfg, seed=0)``. Checkpoints have the reference's layout
(``repro_torch.ft.checkpoint``), so a run resumes from a checkpoint that
either package wrote. ``--mesh`` (a data x model device mesh) raises
``NotImplementedError``: sharded training waits for EP x DP.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.data.pipeline import (DataPipeline, SyntheticCorpus,
                                       SyntheticCorpusConfig)
from repro_torch.device import resolve_device
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.models.model import build_model, init_params
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card; 'cpu' runs on the CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduce config to the smoke scale (default on)")
    ap.add_argument("--mesh", default=None,
                    help="comma data,model sizes (not ported: raises)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def batch_to(batch, device):
    """A pipeline batch (int32 numpy) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v.astype(np.int64)).to(device)
            for k, v in batch.items()}


def main(argv=None) -> None:
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``)."""
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: sharded training over a device mesh is not ported yet "
            "(it comes with EP x DP); train on one device")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    device = resolve_device(args.device)
    print(f"[train] {cfg.arch_id} ({cfg.param_count()/1e6:.1f}M params) "
          f"steps={args.steps} batch={args.batch}x{args.seq} mesh=1x1")

    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps),
        optimizer=args.optimizer, num_microbatches=args.microbatches)
    corpus = SyntheticCorpus(SyntheticCorpusConfig(
        vocab_size=cfg.vocab_size))
    pipe = DataPipeline(corpus, batch=args.batch, seq=args.seq)

    params = init_params(cfg, seed=0, device=device)
    state = init_train_state(params, tcfg)
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume and mgr.latest_step() is not None:
            tree, manifest = mgr.restore(shardings=device)
            params, state = tree["params"], tree["opt"]
            pipe.restore(manifest["extra"]["pipe"])
            start = manifest["extra"]["step"]
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(build_model(cfg).loss_fn, tcfg)
    t0 = time.perf_counter()
    tokens = 0
    for step in range(start, args.steps):
        batch = batch_to(pipe.next_batch(), device)
        params, state, metrics = step_fn(params, state, batch)
        tokens += args.batch * args.seq
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"  step {step:5d} nll={float(metrics['nll']):.4f} "
                  f"gnorm={float(metrics.get('grad_norm', 0)):.2f} "
                  f"tok/s={tokens/max(dt, 1e-9):,.0f}")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": state},
                     extra={"pipe": pipe.state(), "step": step + 1})
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": state},
                 extra={"pipe": pipe.state(), "step": args.steps},
                 block=True)
        print(f"[train] final checkpoint at step {args.steps}")


if __name__ == "__main__":
    main()
