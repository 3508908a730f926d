#!/usr/bin/env python3
"""Time the port's dequant-matmul kernels against those of another
checkout on one NVIDIA card, in turns, at ``chip_smoke.py``'s shapes, and
each split launch's two grids against each other.

    mkdir -p build/ab/parent                # build/ is ignored by git
    git archive <commit> | tar -x -C build/ab/parent
    python3 tools/kernel_ab.py --parent build/ab/parent

Two worker processes, one per checkout, each import their own
``repro_torch`` (so each builds its own kernels) and reach them through
the wrappers ``ops.q_matmul``, ``ops.grouped_q_matmul`` and
``ops.grouped_bf16_matmul``. For every kernel and row the main process
asks parent, this, this, parent and reports the mean of each pair. The
rows: ``SHAPES`` at the serve phase's bank sizes (``SIZES``), then the
int4 bank at Kimi-K2's 8192-token prefill bucket (``KIMI_ROWS``, G =
384), then the decode rows of the kernel table that ``SHAPES`` lacks
(``decode_rows``: the draft bank, Kimi-K2's decode banks, phase 9's
shards, phase 11's one-expert banks). Each checkout's wrappers choose the
token count they hand the kernels (this one the true C on the card) and
the plan is read from their own call.

Then, on this checkout alone, every row whose plan splits K (on a body
that can fold) runs in turns on the grid that ``fold_splits`` gives it and
on the other one (rule, other, other, rule; spread: a block a split,
folded: a tile's splits in one block), and the G sweep does the same for
the down-projection of the int8, int4 and bf16 banks at G = 1, 2, 3, 4
and C = 128, 160, 320, 640 (``SWEEP``). Each such row says which grid
was faster and whether the rule's grid is the faster one or within the
turns' spread (the larger gap between a grid's two turns). Where C > 160
(two or more token tiles of either wgmma body) the row also runs the
plan's splits on the other wgmma token tile (128 or 160), in turns.

Each worker holds every result against its plain version
(``chip_smoke._close``) before it times it, and answers with a SHA-256 of
the first input copy's output bytes: where parent and this checkout run
the same plan (body, tiles and K splits), the outputs must be byte-equal,
and so must the two grids' and the two wgmma tiles' on one set of splits;
the script exits 1 after the table if any row is not. Times are device
times as in ``chip_smoke.py``: a CUDA graph of 20 launches cycling
through input copies that exceed twice the L2 (one copy of a Kimi-K2
bank, past it alone). Inputs come from a seed per row, so both
checkouts see the same bytes. The records go to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parents[1]
#: kernel name -> (bits, grouped)
KERNELS = {"q4_matmul": (4, False), "q8_matmul": (8, False),
           "grouped_q4": (4, True), "grouped_q8": (8, True),
           "grouped_bf16": (16, True)}
GROUPED = {4: "grouped_q4", 8: "grouped_q8", 16: "grouped_bf16"}
#: experts per bank of each rung: the serve phase's layout in chip_smoke.py
SIZES = {4: 3, 8: 4, 16: 1}
#: rows of chip_smoke.KIMI_PREFILL_SHAPES timed for the int4 bank at G =
#: KIMI_G, after SHAPES (seeded by their place after it)
KIMI_ROWS = ("kimi_prefill216_up",)
#: the G sweep's banks, expert counts and token counts (the
#: down-projection: K = D_FF, N = D_MODEL)
SWEEP = {"bits": (8, 4, 16), "g": (1, 2, 3, 4), "c": (128, 160, 320, 640)}
REPS = 20
REPLY = "@@ab "                 # marks the worker's answers on its stdout


class Row(NamedTuple):
    kernel: str
    label: str
    g: int
    c: int
    k: int
    n: int
    seed: int
    parent: bool          # timed against the parent checkout too


def decode_rows(cs) -> list:
    """(kernel, label, G, (C, K, N)) of the kernel table's decode rows
    beyond ``SHAPES``: the G = 8 draft bank, Kimi-K2's int4 and int8 decode
    banks at G = 384, phase 9's token-gather and TP shards at G = bank / 2
    and bank, and phase 11's one-expert banks at C = 4 and 12."""
    rows = [("grouped_q4", lbl, cs.DRAFT_G, shp)
            for lbl, shp in cs.DRAFT_SHAPES.items()]
    rows += [(GROUPED[b], lbl, cs.KIMI_G, shp) for b in (4, 8)
             for lbl, shp in cs.KIMI_SHAPES.items()]
    rows += [(GROUPED[b], lbl, cs.MESH_BANKS[b] // (2 if lbl[:2] == "tg"
                                                    else 1), shp)
             for b in (4, 8, 16) for lbl, shp in cs.MESH_SHAPES.items()]
    for b in (4, 8, 16):
        for c in (cs.C_SERVE, cs.C_VERIFY):
            rows += [(GROUPED[b], f"11 C={c} up", 1,
                      (c, cs.D_MODEL, cs.D_FF // 2)),
                     (GROUPED[b], f"11 C={c} down", 1,
                      (c, cs.D_FF // 2, cs.D_MODEL))]
    return rows


def rows_of(cs) -> list:
    """Every row, in order: the parent A/B's rows, then the G sweep's."""
    rows = []
    for i, name in enumerate(KERNELS):
        bits, grouped = KERNELS[name]
        for place, (label, (c, k, n)) in enumerate(cs.SHAPES.items()):
            rows.append(Row(name, label, SIZES[bits] if grouped else 1, c,
                            k, n, i * 100 + place, True))
    kq4 = list(KERNELS).index("grouped_q4")
    for j, label in enumerate(KIMI_ROWS):
        c, k, n = cs.KIMI_PREFILL_SHAPES[label]
        rows.append(Row("grouped_q4", label, cs.KIMI_G, c, k, n,
                        kq4 * 100 + len(cs.SHAPES) + j, True))
    for j, (name, label, g, (c, k, n)) in enumerate(decode_rows(cs)):
        rows.append(Row(name, label, g, c, k, n, 10_000 + j, True))
    j = 0
    for bits in SWEEP["bits"]:
        for g in SWEEP["g"]:
            for c in SWEEP["c"]:
                rows.append(Row(GROUPED[bits], f"sweep down C={c}", g, c,
                                cs.D_FF, cs.D_MODEL, 20_000 + j, False))
                j += 1
    return rows


def worker(tree: Path) -> None:
    """Answer one JSON request per stdin line: a row (``Row``'s fields)
    with ``splits``, ``tile`` and ``fold`` -> ``{"ms", "splits", "body",
    "plan", "fold", "can_fold", "sha256", "max_abs_err"}``; ``splits``
    None times the plan, a number the plan with that many K splits;
    ``tile`` 128 or 160 runs the plan's splits on that wgmma token tile;
    ``fold`` None takes the checkout's own grid, True or False forces
    folded or spread (this checkout only)."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import hashlib

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import grouped_matmul as gk
    from repro_torch.kernels import ops
    from repro_torch.kernels import q4_matmul as qk
    torch.backends.cuda.matmul.allow_tf32 = False
    cached = {}

    def build(row: Row):
        bits, grouped = KERNELS[row.kernel]
        g, c, k, n = row.g, row.c, row.k, row.n
        gen = torch.Generator(device="cuda").manual_seed(row.seed)
        if g == cs.KIMI_G:
            # one copy (the bank is past twice the L2), held against its
            # plain version on the first, a middle and the last expert
            qt, deq = cs._kimi_bank(torch, gen, g, k, n, bits)
            del deq
            x = torch.randn((g, c, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            sel = [0, g // 2, g - 1]
            return [(lambda: ops.grouped_q_matmul(x, qt),
                     lambda: gk.grouped_quantized_matmul_plain(
                         x[sel], qt.q[sel], qt.scales[sel], bits=bits,
                         group_size=cs.GROUP), sel)]
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
        return cases

    for line in sys.stdin:
        req = json.loads(line)
        row = Row(*req["row"])
        if row not in cached:
            cached.clear()
            torch.cuda.empty_cache()
            cached[row] = build(row)
        cases = cached[row]
        plan_fn = getattr(qk, "launch_plan", None)
        fold_fn = getattr(qk, "fold_splits", None)
        tile, fold = req.get("tile"), req.get("fold")
        if (req["splits"] is not None or tile) and plan_fn is None:
            raise SystemExit("splits: this checkout has no launch_plan")
        if fold is not None and fold_fn is None:
            raise SystemExit("fold: this checkout has no fold_splits")
        # the plan each checkout's wrapper asks for (for the C it hands the
        # kernel, padded or not), or it with req["splits"] K splits, or on
        # the wgmma token tile req["tile"]; and its grid, or req["fold"]
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

        def grid_of(plan, g_, m_, n_, b_):
            folds = (fold_fn(plan, g_, m_, n_, b_) if fold is None
                     else fold and qk.can_fold(plan))
            seen["fold"] = folds
            return folds
        if plan_fn is not None:
            qk.launch_plan = plan_of
        if fold_fn is not None:
            qk.fold_splits = grid_of
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
                raise AssertionError(f"{row} splits={splits} fold={fold} "
                                     "disagrees with its plain version: "
                                     f"max |diff| {err}")
            ms = cs._graph_ms(torch, [case[0] for case in cases], REPS)
        finally:
            if plan_fn is not None:
                qk.launch_plan = plan_fn
            if fold_fn is not None:
                qk.fold_splits = fold_fn
        print(REPLY + json.dumps({
            "ms": ms, "splits": splits, "body": body,
            "plan": list(plan) if plan else None, "fold": seen.get("fold"),
            "can_fold": bool(fold_fn and plan and qk.can_fold(plan)),
            "sha256": digest, "max_abs_err": err}), flush=True)


class Worker:
    def __init__(self, tree: Path):
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(tree)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)

    def ask(self, row: Row, splits=None, tile=None,
            fold: Optional[bool] = None) -> dict:
        self.proc.stdin.write(json.dumps({"row": list(row), "splits": splits,
                                          "tile": tile, "fold": fold})
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


def in_turns(turns: list) -> dict:
    """Two settings timed a, b, b, a: each one's mean, the spread (the
    larger gap between a setting's two turns) and whether the first, the
    rule's, is the faster or within the spread of it."""
    a, b = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    spread = max(abs(turns[0] - turns[3]), abs(turns[1] - turns[2]))
    return {"ms": a, "other_ms": b, "spread_ms": spread,
            "rule_ok": a <= b + spread}


def grid_ab(this: Worker, row: Row, first: dict) -> dict:
    """The row on its rule's grid and on the other, in turns; the four
    outputs and ``first``'s must be byte-equal."""
    rule = bool(first["fold"])
    res = [this.ask(row, fold=f) for f in (rule, not rule, not rule, rule)]
    got = in_turns([r["ms"] for r in res])
    got.update(grid="folded" if rule else "spread",
               faster="folded" if (got["ms"] < got["other_ms"]) == rule
               else "spread",
               bytes_equal=len({r["sha256"] for r in res + [first]}) == 1,
               turns=[r["ms"] for r in res])
    return got


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
    this = workers["this"]
    rows, differ, slower = [], [], []
    try:
        for row in rows_of(cs):
            what = f"{row.kernel} {row.label} G={row.g}"
            rec = {"kernel": row.kernel, "shape": row.label, "G": row.g,
                   "C": row.c, "K": row.k, "N": row.n}
            line = f"{row.kernel:13s} {row.label:18s} G={row.g:<3d} "
            if row.parent:
                ab = [workers[w].ask(row)
                      for w in ("parent", "this", "this", "parent")]
                first = ab[1]
                same_plan = ab[0]["plan"] == ab[1]["plan"]
                equal = {r["sha256"] for r in ab} == {ab[0]["sha256"]}
                if same_plan and not equal:
                    differ.append(what)
                rec.update(same_plan=same_plan, bytes_equal=equal,
                           parent_ms=(ab[0]["ms"] + ab[3]["ms"]) / 2,
                           ms=(ab[1]["ms"] + ab[2]["ms"]) / 2,
                           turns={"ab": [r["ms"] for r in ab]})
                line += (f"parent {rec['parent_ms']:.4f} ms, this "
                         f"{rec['ms']:.4f} ms ({rec['parent_ms'] / rec['ms']:.3f}"
                         f"x; turns {[round(t, 4) for t in rec['turns']['ab']]}"
                         f"), bytes {'equal' if equal else 'DIFFER'} "
                         f"({'same' if same_plan else 'other'} plan); ")
            else:
                first = this.ask(row)
                rec["turns"] = {}
            rec.update(body=first["body"], splits=first["splits"],
                       max_abs_err=first["max_abs_err"])
            line += f"{first['body']} ({first['splits']} splits)"
            if first["can_fold"]:
                grid = grid_ab(this, row, first)
                rec["grid_ab"] = grid
                if not grid["bytes_equal"]:
                    differ.append(f"{what} across grids")
                if not grid["rule_ok"]:
                    slower.append(what)
                line += (f"; {grid['grid']} {grid['ms']:.4f} ms, other grid "
                         f"{grid['other_ms']:.4f} ms ({grid['other_ms'] / grid['ms']:.3f}"
                         f"x, spread {grid['spread_ms']:.4f}): "
                         f"{grid['faster']} faster, rule "
                         f"{'ok' if grid['rule_ok'] else 'SLOWER'}, bytes "
                         f"{'equal' if grid['bytes_equal'] else 'DIFFER'}")
            elif row.parent is False:
                line += f": {first['ms']:.4f} ms (no split)"
            if row.parent and row.c > 160 and first["body"] != "mma_sync":
                # two or more token tiles either way: the plan's against
                # the other wgmma tile on the plan's splits (bit-equal by
                # design)
                alt = 128 if first["plan"][1] == 160 else 160
                turns = [this.ask(row, tile=t)
                         for t in (None, alt, alt, None)]
                tile = in_turns([r["ms"] for r in turns])
                tile.update(other_tile=alt, bytes_equal=len(
                    {r["sha256"] for r in turns}) == 1)
                rec["tile_ab"] = tile
                if not tile["bytes_equal"]:
                    differ.append(f"{what} on the {alt}-token tile")
                line += (f"; {tile['other_ms']:.4f} ms on the {alt}-token "
                         f"tile ({tile['ms']:.4f} ms in its turns; "
                         + ("byte-equal" if tile["bytes_equal"]
                            else "DIFFER") + ")")
            rows.append(rec)
            print(line, flush=True)
    finally:
        for w in workers.values():
            w.close()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "sizes": SIZES,
                               "reps": REPS, "rows": rows,
                               "differ": differ, "rule_slower": slower},
                              indent=1))
    timed = [r for r in rows if "same_plan" in r]
    same = sum(r["same_plan"] for r in timed)
    graded = sum("grid_ab" in r for r in rows)
    print(f"kernel_ab: grids timed at {graded} rows; the rule's grid slower "
          f"than the other beyond the turns' spread at {len(slower)}: "
          f"{slower}", flush=True)
    if differ:
        print(f"kernel_ab: outputs differ from the parent's on the same "
              f"plan, between the two grids or between the two wgmma "
              f"tiles, at {differ}", flush=True)
        return 1
    print(f"kernel_ab: {same} of {len(timed)} rows ran the parent's plan, "
          "all byte-equal to the parent's output and across grids",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
