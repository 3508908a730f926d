"""Three-term roofline of each dry-run cell on the H100: the port's
counterpart of the reference's ``roofline/analysis.py``.

Per (arch × shape × mesh) cell, from ``results/dryrun_torch/*.json``
(``launch/dryrun.py``):

    compute term    = FLOPs_per_position / peak_FLOP/s          [s]
    memory term     = bytes_per_position / HBM_bw               [s]
    collective term = collective_bytes_per_position / link_bw   [s]

The FLOPs and bytes are ``roofline.op_count``'s count of what the port's
eager step issues, at the busiest position (``cost``: matmul FLOPs, and
each op's operands read and result written once); collective bytes are
the wire payloads of the port's transfers at the position that moves the
most. These are data-sheet arithmetic for the H100 SXM, not
measurements: the dry run runs on ``meta`` tensors and times only the
host (``trace_s``, the controller's seconds to issue one step at that
mesh).

MODEL_FLOPS (6·N·D train / 2·N_active·D inference, D = tokens processed
by the cell) and the usefulness ratio MODEL_FLOPS / FLOPs are the
reference's: remat recompute, redundant dense compute on the home
position, capacity padding and the one-hot embedding backward show up as
a ratio < 1.

The *bound* on step time is max(terms); the achievable MFU bound is
t_model / bound.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-card constants. :data:`H100` holds NVIDIA's H100 SXM data sheet
    figures."""
    name: str
    peak_flops: float               # dense bf16 FLOP/s
    hbm_bw: float                   # B/s
    link_bw: float                  # B/s a card sends (or receives)
    hbm_bytes: float


#: NVIDIA H100 SXM (data sheet, dense rates): 989 TFLOP/s bf16, 80 GB of
#: HBM3 at 3.35 TB/s (as ``core.cost_model.HardwareModel``), and NVLink 4
#: at 900 GB/s per card, which the data sheet states as the total of both
#: directions over its 18 links: 450 GB/s each way, the rate at which one
#: card's collective payload leaves (or arrives). NVLink joins the 8 cards
#: of one node; a 256- or 512-position mesh spans 32 or 64 such nodes,
#: whose traffic between nodes crosses the network, which the data sheet
#: does not rate and which is slower, so the collective term is a lower
#: bound there.
H100 = Hardware(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                link_bw=450e9, hbm_bytes=80e9)

MESH_CHIPS = {"pod16x16": 256, "pod2x16x16": 512}


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    tokens: float                # tokens processed per step (global)
    t_compute: float             # [s]
    t_memory: float
    t_collective: float
    t_model: float               # MODEL_FLOPS/(chips*peak): ideal step time
    model_flops: float           # global analytic FLOPs per step
    op_flops: float              # per position (the busiest)
    op_bytes: float              # per position (the busiest)
    coll_bytes: float
    useful_ratio: float          # model_flops/chips / op_flops
    peak_gib: float
    trace_s: float               # host seconds to issue the step

    @property
    def bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def mfu_bound(self) -> float:
        return self.t_model / self.bound if self.bound else 0.0

    def advice(self) -> str:
        d = self.dominant
        if d == "collective":
            return ("cut transfer volume: split the dense layers over the "
                    "data ranks instead of gathering their weights onto "
                    "devices[0] every call, and overlap the transfers with "
                    "compute on other streams")
        if d == "memory":
            if self.useful_ratio < 0.5:
                return ("HBM-bound with low useful ratio: stop repeating "
                        "the dense compute on devices[0] and the remat "
                        "recompute; int4/int8 banks through the dequant "
                        "kernels cut expert-weight bytes 4x/2x")
            return ("HBM-bound: raise arithmetic intensity (more tokens per "
                    "card, fused eager elementwise chains, KV-cache "
                    "layout)")
        if self.useful_ratio < 0.5:
            return ("compute-bound but <50% useful FLOPs: remove remat, "
                    "capacity padding or redundant compute first")
        return ("compute-bound near roofline: only kernel-level wins left "
                "(wgmma tiles fed by TMA on the tensor cores)")


def tokens_for(shape: str, rec: dict) -> float:
    """Tokens processed per step (decode: one per sequence)."""
    seq = {"train_4k": 4096, "prefill_32k": 32768,
           "decode_32k": 1, "long_500k": 1}[shape]
    batch = {"train_4k": 256, "prefill_32k": 32,
             "decode_32k": 128, "long_500k": 1}[shape]
    return float(seq * batch)


def model_flops_for(shape: str, rec: dict) -> float:
    """Analytic MODEL_FLOPS per step: 6·N·D (train) / 2·N_active·D (inf)."""
    n_active = rec["active_params_b"] * 1e9
    d = tokens_for(shape, rec)
    mult = 6.0 if shape.startswith("train") else 2.0
    return mult * n_active * d


def load_cell(path: Path, hw: Hardware = H100) -> Optional[CellRoofline]:
    rec = json.loads(path.read_text())
    if not rec.get("ok"):
        return None
    chips = MESH_CHIPS[rec["mesh"]]
    cost = rec.get("cost", {})
    flops = float(cost.get("flops", 0.0))
    moved = float(cost.get("bytes_accessed", 0.0))
    coll = float(rec.get("collectives", {}).get("total_bytes", 0.0))
    mf = model_flops_for(rec["shape"], rec)
    return CellRoofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        tokens=tokens_for(rec["shape"], rec),
        t_compute=flops / hw.peak_flops,
        t_memory=moved / hw.hbm_bw,
        t_collective=coll / hw.link_bw,
        t_model=mf / (chips * hw.peak_flops),
        model_flops=mf, op_flops=flops, op_bytes=moved, coll_bytes=coll,
        useful_ratio=(mf / chips) / flops if flops else 0.0,
        peak_gib=rec.get("memory", {}).get("peak_per_device_gib", 0.0),
        trace_s=float(rec.get("trace_s", 0.0)),
    )


def load_all(results: Optional[Path] = None, mesh: Optional[str] = None,
             tag: str = "", hw: Hardware = H100) -> List[CellRoofline]:
    """The cells under ``results`` (``None``: the module's ``RESULTS``,
    read when called)."""
    results = RESULTS if results is None else results
    cells = []
    for p in sorted(results.glob(f"*__*{tag}.json")):
        stem_parts = p.stem.split("__")
        if len(stem_parts) != 3 or (tag and not stem_parts[2].endswith(tag)):
            continue
        if tag == "" and stem_parts[2] not in MESH_CHIPS:
            continue  # skip tagged variant files in the baseline table
        c = load_cell(p, hw)
        if c and (mesh is None or c.mesh == mesh):
            cells.append(c)
    return cells


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.0f}us"


def markdown_table(cells: List[CellRoofline]) -> str:
    """The reference's table, with the host seconds of one step
    (``trace_s``) in a last column."""
    hdr = ("| arch | shape | mesh | t_comp | t_mem | t_coll | bound "
           "| dominant | MFU-bound | useful | peak GiB | host s |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for c in sorted(cells, key=lambda c: (c.arch, c.shape, c.mesh)):
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | {_fmt_s(c.t_compute)} "
            f"| {_fmt_s(c.t_memory)} | {_fmt_s(c.t_collective)} "
            f"| {_fmt_s(c.bound)} | {c.dominant} | {c.mfu_bound:.1%} "
            f"| {c.useful_ratio:.2f} | {c.peak_gib:.1f} | {c.trace_s:.2f} |")
    return hdr + "\n".join(rows) + "\n"


def pick_hillclimb_cells(cells: List[CellRoofline]) -> Dict[str, CellRoofline]:
    """The three targets: worst MFU-bound (train cells: a decode step's
    MFU-bound is ~0 by construction against one HBM pass of the weights),
    most collective-bound, and the paper-representative cell (mixtral
    decode — the paper's own serving workload)."""
    single = [c for c in cells if c.mesh == "pod16x16"]
    if not single:
        raise ValueError("no pod16x16 cell to pick from")
    train = [c for c in single if c.shape.startswith("train")] or single
    worst = min(train, key=lambda c: c.mfu_bound)
    coll = max(single, key=lambda c: (c.t_collective / c.bound
                                      if c.bound else 0.0))
    paper = next((c for c in single
                  if c.arch == "mixtral-8x7b" and c.shape == "decode_32k"),
                 single[0])
    return {"worst-mfu": worst, "most-collective": coll,
            "paper-representative": paper}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=list(MESH_CHIPS), default=None)
    ap.add_argument("--md", type=Path, default=None,
                    help="write markdown table here")
    ap.add_argument("--pick", action="store_true",
                    help="print the three hillclimb targets")
    args = ap.parse_args()
    cells = load_all(mesh=args.mesh)
    if args.pick and not cells:
        raise ValueError(f"no dry-run records under {RESULTS}: run "
                         "repro_torch.launch.dryrun first")
    table = markdown_table(cells)
    print(table)
    if args.md:
        args.md.write_text(table)
    if args.pick:
        for why, c in pick_hillclimb_cells(cells).items():
            print(f"{why:22s} {c.arch} {c.shape} dominant={c.dominant} "
                  f"mfu_bound={c.mfu_bound:.1%}")


if __name__ == "__main__":
    main()
