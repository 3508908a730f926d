#!/usr/bin/env python3
"""Same-card A/B of the serve phase's warm decode against an earlier
checkout:

    mkdir -p build/ab/parent
    git archive <commit> | tar -x -C build/ab/parent
    python3 tools/serve_ab.py --parent build/ab/parent --rounds 25

Two worker processes, one per checkout, each import their own
``chip_smoke.py`` and ``src/``, build the serve phase's engine (Mixtral
at full width, depth 2, seeded random weights, the default paged
``EngineConfig`` with the kernels on, ``chip_smoke.pick_point``'s
three-rung frontier point) and serve its four prompts once cold. Then
each round asks for one warm pass in the order parent, this, this,
parent, so drift of the shared host reaches both sides alike. A pass is
``chip_smoke.serve_pass`` of the worker's own checkout: its ms per decode
iteration (host time included: the serving path runs eager), its launches
per decode iteration and its tokens, which must be the same on both
sides. The script prints each side's median and quartiles and the
per-round difference (this minus parent: mean, standard error, rounds
where this is faster) and writes the passes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPLY = "@@serve "              # marks the worker's answers on its stdout


def worker(tree: Path, seed: int) -> None:
    """Build the serve phase's engine, serve cold, then answer each stdin
    line with one warm pass: ``{"decode_ms", "wall_s", "launches",
    "tokens"}``."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import EngineConfig, build_engine
    cfg = cs.serving_config()
    params = init_params(cfg, seed, device="cuda")
    engine = build_engine(cfg, params, EngineConfig(**cs.SERVE_CFG),
                          device="cuda")
    engine.apply_frontier_point(cs.pick_point(
        engine.frontier, cfg.num_layers * cfg.moe.num_experts))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=16) for _ in range(4)]

    def answer():
        r = cs.serve_pass(torch, engine, prompts)
        print(REPLY + json.dumps({
            "decode_ms": r["decode_ms_per_iter"], "wall_s": r["wall_s"],
            "launches": sum(r["launches_per_decode_iter"].values()),
            "tokens": r["tokens"]}), flush=True)

    answer()                                    # the cold pass
    for _ in sys.stdin:
        answer()
    engine.close()


class Worker:
    def __init__(self, tree: Path, seed: int):
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(tree), "--seed", str(seed)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)

    def read(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith(REPLY):
                return json.loads(line[len(REPLY):])
        raise RuntimeError(f"worker exited with {self.proc.wait()}")

    def ask(self) -> dict:
        self.proc.stdin.write("pass\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier checkout")
    ap.add_argument("--rounds", type=int, default=10,
                    help="rounds of parent, this, this, parent passes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "serve_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(Path(args.worker), args.seed)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_ab: no CUDA device; this script runs on the "
                         "card only")
    parent = Path(args.parent or "").resolve()
    if not args.parent or not (parent / "src" / "repro_torch").is_dir():
        raise SystemExit("serve_ab: --parent must be a checkout with "
                         "src/repro_torch")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    workers = {"parent": Worker(parent, args.seed),
               "this": Worker(ROOT, args.seed)}
    passes = {side: [] for side in workers}
    try:
        cold = {side: w.read() for side, w in workers.items()}
        for _ in range(args.rounds):
            for side in ("parent", "this", "this", "parent"):
                passes[side].append(workers[side].ask())
    finally:
        for w in workers.values():
            w.close()
    same_tokens = len({json.dumps(p["tokens"]) for p in [
        *cold.values(), *passes["parent"], *passes["this"]]}) == 1
    ms = {side: [p["decode_ms"] for p in ps] for side, ps in passes.items()}
    diff = [(ms["this"][2 * i] + ms["this"][2 * i + 1]
             - ms["parent"][2 * i] - ms["parent"][2 * i + 1]) / 2
            for i in range(args.rounds)]
    mean = statistics.fmean(diff)
    se = statistics.stdev(diff) / len(diff) ** 0.5 if len(diff) > 1 else 0.0
    launches = {side: sorted({p["launches"] for p in ps})
                for side, ps in passes.items()}
    print(f"{smi}; {args.rounds} rounds of parent, this, this, parent warm "
          "serve passes", flush=True)
    for side, v in ms.items():
        q1, _, q3 = statistics.quantiles(v, n=4)
        print(f"  {side}: ms per decode iteration median "
              f"{statistics.median(v):.3f}, quartiles {q1:.3f}-{q3:.3f}, "
              f"min {min(v):.3f}, max {max(v):.3f}; launches per decode "
              f"iteration {launches[side]}", flush=True)
    print(f"  this - parent per round: mean {mean:+.3f} ms, standard error "
          f"{se:.3f} ms, this faster in {sum(d < 0 for d in diff)} of "
          f"{len(diff)} rounds; tokens "
          f"{'equal' if same_tokens else 'DIFFER'}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "nvidia_smi": smi, "rounds": args.rounds, "cold": cold,
        "passes": passes, "diff_ms": diff, "mean_diff_ms": mean,
        "se_ms": se, "launches": launches,
        "tokens_equal": same_tokens}, indent=1))
    return 0 if same_tokens else 1


if __name__ == "__main__":
    sys.exit(main())
