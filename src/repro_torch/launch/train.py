"""Training launcher (``repro.launch.train``), on the card unless
``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 100 --batch 8 --seq 128 [--smoke] [--ckpt-dir DIR] \\
        [--resume] [--microbatches 2] [--device cpu] \\
        [--mesh D,M --device DEV0,...,DEV(D*M-1)]

``--smoke`` (default on) reduces the config to the same-family smoke
scale; ``--no-smoke`` trains the full config. Fresh params are
``init_params(cfg, seed=0)``. Checkpoints have the reference's layout
(``repro_torch.ft.checkpoint``), so a run resumes from a checkpoint that
either package wrote. ``--mesh D,M`` trains over a (data, model) mesh of
D*M positions: params and optimizer state are sharded by
``dist.sharding`` (``param_specs``, ``opt_state_specs``) over the devices
``--device`` lists in order (an entry may repeat: ``cpu`` alone repeats,
``cuda`` alone takes distinct cards); a checkpoint saved on one mesh
resumes on another.
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
from repro_torch.dist import sharding as SH
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import build_model, init_params
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step,
                                             opt_state_specs)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card; 'cpu' runs on the CPU); with --mesh a "
                         "comma-separated list of D*M devices (may "
                         "repeat), a lone 'cpu' repeated, a lone 'cuda' "
                         "for distinct cards")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduce config to the smoke scale (default on)")
    ap.add_argument("--mesh", default=None,
                    help="comma data,model sizes of the device mesh, "
                         "e.g. 2,2")
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


def make_mesh(spec: str, devices):
    """``--mesh D,M`` over ``--device``: a comma list of D*M devices
    (entries may repeat), a lone ``cpu`` repeated, or ``None`` / a lone
    ``cuda`` for distinct cards."""
    d, m = (int(v) for v in spec.split(","))
    names = None if devices is None else \
        [n.strip() for n in devices.split(",") if n.strip()]
    if names == ["cuda"]:
        names = None
    elif names == ["cpu"]:
        names = names * (d * m)
    elif names is not None and len(names) != d * m:
        raise SystemExit(
            f"--device lists {len(names)} device(s) but --mesh {d},{m} "
            f"needs {d * m} (a device may repeat, e.g. "
            f"{','.join(['cuda:0'] * (d * m))})")
    return make_test_mesh((d, m), devices=names)


def main(argv=None) -> None:
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``)."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    mesh = make_mesh(args.mesh, args.device) if args.mesh else None
    device = mesh.devices[0] if mesh else resolve_device(args.device)
    shape = "x".join(map(str, mesh.shape)) if mesh else "1x1"
    print(f"[train] {cfg.arch_id} ({cfg.param_count()/1e6:.1f}M params) "
          f"steps={args.steps} batch={args.batch}x{args.seq} mesh={shape}")

    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps),
        optimizer=args.optimizer, num_microbatches=args.microbatches)
    corpus = SyntheticCorpus(SyntheticCorpusConfig(
        vocab_size=cfg.vocab_size))
    pipe = DataPipeline(corpus, batch=args.batch, seq=args.seq)

    params = init_params(cfg, seed=0, device=device)
    where = device
    if mesh is not None:
        specs = SH.param_specs(cfg, mesh, params)
        where = {"params": SH.shardings(mesh, specs),
                 "opt": SH.shardings(mesh, opt_state_specs(specs, tcfg,
                                                           params))}
        params = SH.shard_tree(params, where["params"])
    state = init_train_state(params, tcfg)
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume and mgr.latest_step() is not None:
            tree, manifest = mgr.restore(shardings=where)
            params, state = tree["params"], tree["opt"]
            pipe.restore(manifest["extra"]["pipe"])
            start = manifest["extra"]["step"]
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(build_model(cfg, mesh).loss_fn, tcfg)
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
