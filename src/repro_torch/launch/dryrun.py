"""Dry run of every (arch x shape x mesh) cell on ``meta`` tensors: the
port's counterpart of the reference's ``launch/dryrun.py``.

The reference lowers and compiles each cell's step against abstract
inputs with the production shardings and reads its memory, cost and
collectives from the compiled HLO. The port runs eagerly, so it runs the
step itself on ``meta`` tensors (shapes and dtypes, no storage) over the
reference's production mesh of ``meta`` positions
(``make_production_mesh(devices=["meta"] * n)``), under
``roofline.op_count.OpCounter``, which counts per mesh position what the
step issues. Nothing runs on a device and no memory is allocated: it
needs no card.

Per cell this script:
  1. builds the step (the train step with ``remat="full"``, ``prefill``
     or ``decode_step``) with ``build_model(cfg, mesh)`` and
     ``use_kernel=False``, as the reference's dry run does; its params
     are ``abstract_params``, placed by ``dist.sharding.shard_tree`` for
     training and by ``place_params`` for serving (a MoP-enabled MoE's
     converted by ``apply_precision_plan(..., mesh=)`` from a
     ``balanced_random_plan`` with half of each layer's experts at 4
     bits); a serving cell's inputs are placed by ``dist.sharding.
     input_specs`` and its cache made by ``Model.init_cache``, each data
     rank's rows at its positions; a train cell's batch is split over the
     data ranks inside the step (a scatter the count books), after the
     train step cut it into microbatches;
  2. runs it once under the counter;
  3. writes one record per cell to
     ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``: the
     reference's keys where they still mean something (``memory`` at the
     position with the largest footprint, and which position that is;
     ``cost`` and ``collectives`` from ``op_count``) and ``trace_s``, in
     place of the reference's lower and compile times: the host seconds
     the single controller takes to issue one step at that mesh, every
     position's share in turn, counter included. A meta op runs
     PyTorch's shape logic in place of a kernel launch and a copy, so
     this is the controller's own work per step, not a time of the card:
     ``chip_smoke.py`` phase 10 sets it beside a step timed on the H100.

A mesh of ``cpu`` or ``cuda`` devices (``build_cell``'s callers in the
tests and ``chip_smoke.py``) runs the same step on real tensors with
random params.

Usage (``PYTHONPATH=src``):
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \
      [--force]
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.precision_plan import balanced_random_plan
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import make_production_mesh, use_mesh
from repro_torch.models.model import (abstract_params, apply_precision_plan,
                                      build_model, init_params, place_params)
from repro_torch.roofline import op_count
from repro_torch.roofline.op_count import OpCounter
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# Serving cells for MoE archs run the paper's mixed-precision banks:
# half the experts 4-bit (per-layer balanced; EP needs multiples of 16).
MOP_FRACTION = 0.5


def _params(cfg: ModelConfig, device: torch.device):
    """The train-layout params: ``meta`` tensors on a meta mesh, else
    seeded random ones on ``device``."""
    if device.type == "meta":
        return abstract_params(cfg)
    return init_params(cfg, 0, device=device)


def _serve_params_struct(cfg: ModelConfig, mesh, params=None):
    """Serve-layout params on ``mesh`` (mixed banks for a MoP MoE,
    placed per position), every other leaf placed by ``place_params``:
    its ``param_specs`` shard at each position where the serving rules
    split the dense compute."""
    if params is None:
        params = _params(cfg, mesh.devices[0])
    if cfg.moe is None or not cfg.mop.enabled:
        return place_params(cfg, mesh, params)
    e = cfg.moe.num_experts
    per_layer = int(e * MOP_FRACTION)
    per_layer -= per_layer % 16 if e >= 16 else 0
    plan = balanced_random_plan(cfg.num_layers, e,
                                per_layer * cfg.num_layers,
                                bits=cfg.mop.bits,
                                group_size=cfg.mop.group_size)
    return apply_precision_plan(params, cfg, plan, mesh=mesh)


def pick_train_cfg(cfg: ModelConfig, shape: ShapeConfig, mesh) -> TrainConfig:
    dp = SH.batch_axes(mesh, shape.global_batch)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.sizes[a]
    b_loc = max(shape.global_batch // n_dp, 1)
    # one sequence per device per microstep bounds activation memory
    n_micro = b_loc
    opt = "adafactor" if cfg.param_count() > 2e11 else "adamw"
    return TrainConfig(opt=OptConfig(), optimizer=opt,
                       num_microbatches=n_micro)


def _like(tree, device: torch.device):
    """``meta`` specs as tensors on ``device``: themselves on a meta mesh,
    else zeros (token ids and positions 0)."""
    if device.type == "meta":
        return tree
    if isinstance(tree, dict):
        return {k: _like(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, params=None):
    """Returns (step, args): ``step(*args)`` runs the cell once, its
    params and state placed on ``mesh`` as the port places them.
    ``params``: the train-layout params to place (default: ``_params``;
    ``_like(abstract_params(cfg), device)`` gives a device the shapes
    ``meta`` counts with: ``init_params`` draws Mamba2's ``A_log`` with
    one value per layer, as the reference's init does)."""
    dev = mesh.devices[0]
    dp = SH.batch_axes(mesh, shape.global_batch)

    if shape.kind == "train":
        cfg_t = cfg.replace(remat="full")
        model_t = build_model(cfg_t, mesh, dp_axes=dp)
        tcfg = pick_train_cfg(cfg, shape, mesh)
        step = make_train_step(model_t.loss_fn, tcfg)
        params = _params(cfg, dev) if params is None else params
        params = SH.shard_tree(params,
                               SH.param_shardings(cfg, mesh, params))
        opt_state = init_train_state(params, tcfg)
        batch, _ = SH.input_specs(cfg, shape, mesh)
        return step, (params, opt_state, _like(batch, dev))

    model = build_model(cfg, mesh, dp_axes=dp)
    serve_params = _serve_params_struct(cfg, mesh, params)
    cache = model.init_cache(shape.global_batch, shape.seq_len, device=dev)
    inp, placed = SH.input_specs(cfg, shape, mesh)
    inp = _like(inp, dev)
    if SH.splits_dense(cfg, mesh):        # each data rank's rows in place
        inp = SH.shard_tree(inp, placed)
    if shape.kind == "prefill":
        return model.prefill, (serve_params, inp, cache)
    return model.decode_step, (serve_params, cache, inp["tokens"],
                               inp["positions"])


def count_step(step, args, positions: int):
    """Run ``step(*args)`` once under an :class:`OpCounter` of
    ``positions``; returns (counter, seconds)."""
    with OpCounter(positions) as counter:
        counter.place(args)
        t0 = time.perf_counter()
        out = step(*args)
        secs = time.perf_counter() - t0
        counter.outputs(out)
    return counter, secs


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, extra_tag: str = "") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * (512 if multi_pod else 256))
    n = len(mesh.devices)
    tag = "pod2x16x16" if multi_pod else "pod16x16"
    out = {"arch": arch, "shape": shape_name, "mesh": tag,
           "params_b": cfg.param_count() / 1e9,
           "active_params_b": cfg.active_param_count() / 1e9}
    t0 = time.perf_counter()
    try:
        with use_mesh(mesh):
            step, args = build_cell(cfg, shape, mesh)
            out["build_s"] = round(time.perf_counter() - t0, 2)
            counter, secs = count_step(step, args, n)
        out.update({"ok": True, "trace_s": round(secs, 2),
                    "memory": counter.memory(),
                    "cost": counter.cost_summary(),
                    "collectives": counter.collective_summary()})
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweep
        out.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    out["total_s"] = round(time.perf_counter() - t0, 2)
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{shape_name}__{tag}{extra_tag}.json"
        (RESULTS / name).write_text(json.dumps(out, indent=1))
    return out


def _heartbeat(label: str, stop: threading.Event, every_s: float) -> None:
    """Print the running cell's ops so far every ``every_s`` seconds (a
    production train cell runs for hours)."""
    t0 = time.perf_counter()
    while not stop.wait(every_s):
        print(f"[....] {label}: {op_count.issued()} ops counted, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for arch, shape_name in cells:
        for mp in meshes:
            tag = "pod2x16x16" if mp else "pod16x16"
            path = RESULTS / f"{arch}__{shape_name}__{tag}.json"
            if path.exists() and not args.force:
                prev = json.loads(path.read_text())
                if prev.get("ok"):
                    print(f"[skip] {arch} {shape_name} {tag} (cached ok)")
                    continue
            stop = threading.Event()
            beat = threading.Thread(target=_heartbeat, daemon=True, args=(
                f"{arch} {shape_name} {tag}", stop, 600.0))
            beat.start()
            try:
                r = run_cell(arch, shape_name, mp)
            finally:
                stop.set()
                beat.join()
            status = "OK " if r["ok"] else "FAIL"
            mem = r.get("memory", {}).get("peak_per_device_gib", "-")
            print(f"[{status}] {arch:22s} {shape_name:12s} {tag:10s} "
                  f"peak/dev={mem}GiB trace={r.get('trace_s', '-')}s "
                  f"t={r['total_s']}s"
                  + ("" if r["ok"] else f"  {r['error'][:120]}"),
                  flush=True)
            n_fail += 0 if r["ok"] else 1
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
