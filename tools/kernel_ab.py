#!/usr/bin/env python3
"""Time the port's dequant-matmul kernels against those of another
checkout on one NVIDIA card, in turns, at ``chip_smoke.py``'s shapes.

    mkdir -p build/ab/parent                # build/ is ignored by git
    git archive <commit> | tar -x -C build/ab/parent
    python3 tools/kernel_ab.py --parent build/ab/parent

Two worker processes, one per checkout, each import their own
``repro_torch`` (so each builds its own kernels) and reach them through
the wrappers ``ops.q_matmul``, ``ops.grouped_q_matmul`` and
``ops.grouped_bf16_matmul``. For every kernel and shape the main process
asks parent, this, this, parent and reports the mean of each pair. Then, on
this checkout alone, it times the launch that ``launch_plan`` chooses
(its body: ``mma_sync`` up to 64 tokens, ``wgmma`` up to 128 and at
161-256, ``wgmma_wide`` at 129-160 and past 256) against the same launch
with another K split, in
turns (plan, other, other, plan): unsplit where the plan splits, two
splits where it does not; and, where C > 160 (two or more token tiles of
either wgmma body), against the same launch on the other wgmma token tile
(128 or 160) with the plan's K splits. Besides ``SHAPES`` it times the
int4 bank at Kimi-K2's 8192-token prefill bucket (``KIMI_ROWS``, G = 384).
Each checkout's wrappers choose the token count
they hand the kernels (this one the true C on the card) and the plan is
read from their own call.
Each worker holds every result against its plain version
(``chip_smoke._close``) before it times it, and answers with a SHA-256 of
the first input copy's output bytes: where parent and this checkout run
the same plan (body, tiles and K splits), the outputs must be byte-equal,
and so must the two wgmma tiles' on one set of splits; the script exits 1
after the table if any row is not. Times are
device times as in ``chip_smoke.py``: a CUDA graph of 20 launches cycling
through input copies that exceed twice the L2. Inputs come from a seed
per case, so both checkouts see the same bytes. The records go to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: kernel name -> (bits, grouped)
KERNELS = {"q4_matmul": (4, False), "q8_matmul": (8, False),
           "grouped_q4": (4, True), "grouped_q8": (8, True),
           "grouped_bf16": (16, True)}
#: experts per bank of each rung: the serve phase's layout in chip_smoke.py
SIZES = {4: 3, 8: 4, 16: 1}
#: rows of chip_smoke.KIMI_PREFILL_SHAPES timed for the int4 bank at G =
#: KIMI_G, after SHAPES (seeded by their place after it)
KIMI_ROWS = ("kimi_prefill216_up",)
REPS = 20
REPLY = "@@ab "                 # marks the worker's answers on its stdout


def rows_of(cs) -> list:
    """(kernel, shape) of every row, in order."""
    return ([(name, shape) for name in KERNELS for shape in cs.SHAPES]
            + [("grouped_q4", shape) for shape in KIMI_ROWS])


def worker(tree: Path) -> None:
    """Answer one JSON request per stdin line: ``{"kernel", "shape",
    "splits", "tile"}`` -> ``{"ms", "splits", "body", "plan", "sha256",
    "max_abs_err"}``; ``splits`` None times the plan, a number
    the plan with that many K splits; ``tile`` 128 or 160 runs the plan's
    splits on that wgmma token tile."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import hashlib

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import grouped_matmul as gk
    from repro_torch.kernels import ops
    from repro_torch.kernels import q4_matmul as qk
    torch.backends.cuda.matmul.allow_tf32 = False
    cached = {}

    def build(name, shape):
        bits, grouped = KERNELS[name]
        g = SIZES[bits] if grouped else 1
        place = (list(cs.SHAPES).index(shape) if shape in cs.SHAPES
                 else len(cs.SHAPES) + KIMI_ROWS.index(shape))
        gen = torch.Generator(device="cuda").manual_seed(
            list(KERNELS).index(name) * 100 + place)
        if shape in KIMI_ROWS:
            # one copy (the bank is past twice the L2), held against its
            # plain version on the first, a middle and the last expert
            g = cs.KIMI_G
            c, k, n = cs.KIMI_PREFILL_SHAPES[shape]
            qt, deq = cs._kimi_bank(torch, gen, g, k, n, bits)
            del deq
            x = torch.randn((g, c, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            sel = [0, g // 2, g - 1]
            return (bits, c, k, n), [
                (lambda: ops.grouped_q_matmul(x, qt),
                 lambda: gk.grouped_quantized_matmul_plain(
                     x[sel], qt.q[sel], qt.scales[sel], bits=bits,
                     group_size=cs.GROUP), sel)]
        c, k, n = cs.SHAPES[shape]
        nbytes = g * k * n * bits // 8 + (g * (k // cs.GROUP) * n * 2
                                          if bits < 16 else 0)
        cases = []
        for _ in range(cs._copies(torch, nbytes)):
            x, w = cs._make_bank(torch, gen, g, c, k, n, bits)
            if bits == 16:
                cases.append((lambda x=x, w=w: ops.grouped_bf16_matmul(x, w),
                              lambda x=x, w=w:
                              gk.grouped_bf16_matmul_plain(x, w)))
            elif grouped:
                cases.append((lambda x=x, w=w: ops.grouped_q_matmul(x, w),
                              lambda x=x, w=w, b=bits:
                              gk.grouped_quantized_matmul_plain(
                                  x, w.q, w.scales, bits=b,
                                  group_size=cs.GROUP)))
            else:
                x1, q1 = x[0], w.map(lambda t: t[0])
                cases.append((lambda x1=x1, q1=q1: ops.q_matmul(x1, q1),
                              lambda x1=x1, q1=q1, b=bits:
                              qk.quantized_matmul_plain(
                                  x1, q1.q, q1.scales, bits=b,
                                  group_size=cs.GROUP)))
        return (bits, c, k, n), cases

    for line in sys.stdin:
        req = json.loads(line)
        key = (req["kernel"], req["shape"])
        if key not in cached:
            cached.clear()
            torch.cuda.empty_cache()
            cached[key] = build(*key)
        (bits, c, k, n), cases = cached[key]
        plan_fn = getattr(qk, "launch_plan", None)
        tile = req.get("tile")
        if (req["splits"] is not None or tile) and plan_fn is None:
            raise SystemExit("splits: this checkout has no launch_plan")
        # the plan each checkout's wrapper asks for (for the C it hands the
        # kernel, padded or not), or it with req["splits"] K splits, or on
        # the wgmma token tile req["tile"]
        seen = {}

        def plan_of(c_, k_, n_, b_):
            plan = plan_fn(c_, k_, n_, b_)
            if req["splits"] is not None:
                grains = -(-k_ // qk.SPLIT_GRAIN)
                k_chunk = -(-grains // req["splits"]) * qk.SPLIT_GRAIN
                plan = plan._replace(k_chunk=k_chunk,
                                     splits=-(-k_ // k_chunk))
            if tile:
                plan = plan._replace(block_c=tile, body="wgmma_wide"
                                     if tile == qk.WIDE_BLOCK_C else "wgmma")
            seen["plan"] = plan
            return plan
        if plan_fn is not None:
            qk.launch_plan = plan_of
        try:
            got = cases[0][0]()
            sel = cases[0][2] if len(cases[0]) > 2 else slice(None)
            err, ok = cs._close(torch, got[sel], cases[0][1]())
            digest = hashlib.sha256(got.contiguous().view(torch.uint8).cpu()
                                    .numpy().tobytes()).hexdigest()
            plan = seen.get("plan")
            splits = plan.splits if plan else None
            body = getattr(plan, "body", "mma_sync")
            if not ok:
                raise AssertionError(f"{key} splits={splits} disagrees with "
                                     f"its plain version: max |diff| {err}")
            ms = cs._graph_ms(torch, [case[0] for case in cases], REPS)
        finally:
            if plan_fn is not None:
                qk.launch_plan = plan_fn
        print(REPLY + json.dumps({"ms": ms, "splits": splits, "body": body,
                                  "plan": list(plan) if plan else None,
                                  "sha256": digest, "max_abs_err": err}),
              flush=True)


class Worker:
    def __init__(self, tree: Path):
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(tree)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)

    def ask(self, kernel: str, shape: str, splits=None, tile=None) -> dict:
        self.proc.stdin.write(json.dumps({"kernel": kernel, "shape": shape,
                                          "splits": splits, "tile": tile})
                              + "\n")
        self.proc.stdin.flush()
        for line in self.proc.stdout:
            if line.startswith(REPLY):
                return json.loads(line[len(REPLY):])
        raise RuntimeError(f"worker exited with {self.proc.wait()}")

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
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "kernel_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(Path(args.worker))
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device; this script runs on the "
                         "card only")
    parent = Path(args.parent or "").resolve()
    if not args.parent or not (parent / "src" / "repro_torch").is_dir():
        raise SystemExit("kernel_ab: --parent must be a checkout with "
                         "src/repro_torch")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; bank layout {SIZES}; device ms, CUDA graph of {REPS} "
          "launches", flush=True)
    workers = {"parent": Worker(parent), "this": Worker(ROOT)}
    rows, differ = [], []
    try:
        for name, shape in rows_of(cs):
            ab = [workers[w].ask(name, shape)
                  for w in ("parent", "this", "this", "parent")]
            first = workers["this"].ask(name, shape)
            other = 1 if first["splits"] > 1 else 2
            split = [first, *(workers["this"].ask(name, shape, other)
                              for _ in range(2)),
                     workers["this"].ask(name, shape)]
            same_plan = ab[0]["plan"] == ab[1]["plan"]
            equal = {r["sha256"] for r in ab} == {ab[0]["sha256"]}
            if same_plan and not equal:
                differ.append(f"{name} {shape}")
            row = {"kernel": name, "shape": shape,
                   "same_plan": same_plan, "bytes_equal": equal,
                   "parent_ms": (ab[0]["ms"] + ab[3]["ms"]) / 2,
                   "ms": (ab[1]["ms"] + ab[2]["ms"]) / 2,
                   "splits": split[0]["splits"],
                   "body": split[0]["body"],
                   "plan_ms": (split[0]["ms"] + split[3]["ms"]) / 2,
                   "other_splits": split[1]["splits"],
                   "other_ms": (split[1]["ms"] + split[2]["ms"]) / 2,
                   "turns": {"ab": [r["ms"] for r in ab],
                             "split": [r["ms"] for r in split]},
                   "max_abs_err": max(r["max_abs_err"] for r in ab + split)}
            tiles = ""
            c = {**cs.SHAPES, **cs.KIMI_PREFILL_SHAPES}[shape][0]
            if c > 160:
                # two or more token tiles either way: the plan's against
                # the other wgmma tile on the plan's splits (bit-equal by
                # design)
                alt = 128 if first["plan"][1] == 160 else 160
                turns = [workers["this"].ask(name, shape, tile=t)
                         for t in (None, alt, alt, None)]
                row.update(
                    tile_ms=(turns[0]["ms"] + turns[3]["ms"]) / 2,
                    other_tile=alt,
                    other_tile_ms=(turns[1]["ms"] + turns[2]["ms"]) / 2,
                    tile_bytes_equal=len({r["sha256"] for r in turns}) == 1)
                row["turns"]["tile"] = [r["ms"] for r in turns]
                if not row["tile_bytes_equal"]:
                    differ.append(f"{name} {shape} on the {alt}-token tile")
                tiles = (f", {row['other_tile_ms']:.4f} ms on the {alt}-token"
                         f" tile ({row['tile_ms']:.4f} ms in its turns; "
                         + ("byte-equal" if row["tile_bytes_equal"]
                            else "DIFFER") + ")")
            rows.append(row)
            print(f"{name:13s} {shape:18s} parent {row['parent_ms']:.4f} "
                  f"ms, this {row['ms']:.4f} ms "
                  f"({row['parent_ms'] / row['ms']:.2f}x; turns "
                  f"{[round(t, 4) for t in row['turns']['ab']]}); "
                  f"{row['body']} plan "
                  f"({row['splits']} splits) {row['plan_ms']:.4f} ms, "
                  f"{row['other_splits']} splits {row['other_ms']:.4f} "
                  f"ms{tiles}; outputs "
                  f"{'byte-equal' if equal else 'DIFFER'} "
                  f"({'same' if same_plan else 'other'} plan)", flush=True)
    finally:
        for w in workers.values():
            w.close()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "sizes": SIZES,
                               "reps": REPS, "rows": rows,
                               "differ": differ}, indent=1))
    same = sum(r["same_plan"] for r in rows)
    if differ:
        print(f"kernel_ab: outputs differ from the parent's on the same "
              f"plan, or between the two wgmma tiles, at {differ}",
              flush=True)
        return 1
    print(f"kernel_ab: {same} of {len(rows)} rows ran the parent's plan, all "
          "byte-equal to the parent's output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
