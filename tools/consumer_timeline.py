"""Where a wgmma consumer warpgroup's cycles go, per pipeline stage, for the
int4/int8 expert banks (``tools/chip_phases.py timeline``; the card only).

Two readings:

* SASS. ``cuobjdump -sass`` of the wrappers' library: in each int
  instantiation of the wgmma kernel (bits 4 and 8, the 128- and 160-token
  tiles), the consumer's K loops (the backward branches whose bodies hold
  the HGMMAs; one a consumer warpgroup, since each runs its own
  instantiation of the loop) are counted by class (HGMMA, FFMA, the
  conversion's PRMT, LOP3, SHF and half-precision ops, MOV, barriers and
  waits, loads, the rest) and divided by their stages (HGMMAs / 4: one
  64-K stage is four k16 steps). With ``parent`` the same text of an
  earlier checkout's sources, built by this checkout's compile command, is
  compared with it.
* A timeline. The sources built again with ``-D`` ``cuda_lib.STAMP_MACRO``
  into ``build/timeline/`` (never the wrappers' library; with
  ``lockstep`` also ``-D`` ``cuda_lib.LOCKSTEP_MACRO``, which compiles the
  consumers' turns out; with ``tree`` another checkout's sources that
  carry the stamps): the first thread of each warpgroup of the grid's
  first blocks stamps ``clock64()`` at each point of each stage
  (``StampPoint`` in ``wgmma_body.cuh``). One launch of each case, after a
  warm-up, is read back; per consumer warpgroup the median cycles of a
  steady stage and of each step between two points in their order, its
  issue window (turn taken to commit) and flush window (wait returned to
  flush done), the cycles from its issue to the other warpgroup's next
  issue, and the share of its flush window that the other warpgroup's
  wgmma window (its commit to its wait's return: an upper bound of the
  tensor core's work) covers; the skew between the two warpgroups'
  flushes, and the producer's period, beside the tensor core's floor for
  the stage's eight wgmmas (m64nNk16 at 2,048 FMA a cycle: 4 N cycles).
"""
from __future__ import annotations

import collections
import ctypes
import re
import statistics
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "timeline"
#: bank -> (bits, experts): the serve phase's layout (tools/kernel_ab.py)
BANKS = {"grouped_q4": (4, 3), "grouped_q8": (8, 4)}
#: the rows the timeline reads
ROWS = ("prefill320_up", "prefill320_down", "prefill256_up", "prefill640_up")
#: stamped threads a block: consumer warpgroups 0 and 1, the producer
ROLES = 3
#: StampPoint of wgmma_body.cuh, in its order
POINTS = ("full", "issued", "waited", "flushed", "converted", "released",
          "drained", "empty", "turn")
#: the producer's point; every other point is a consumer's
PRODUCER = ("empty",)
#: SASS classes, in the order they are printed
CLASSES = ("HGMMA", "FFMA", "conversion", "MOV", "sync", "loads", "rest")
CONVERSION = {"PRMT", "LOP3", "SHF", "HADD2", "HFMA2", "HMUL2"}
SYNC = ("WARPGROUP", "BAR", "WARPSYNC", "SYNCS", "DEPBAR")
LOADS = {"LDS", "LDSM", "LDG", "LD", "LDC", "ULDC", "LDL"}


def _cuobjdump() -> str:
    import shutil
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def sass(lib: Path) -> str:
    return subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def functions(text: str) -> dict:
    """SASS text by function name."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def _klass(op: str) -> str:
    base = op.split(".")[0]
    if base == "HGMMA":
        return "HGMMA"
    if base == "FFMA":
        return "FFMA"
    if base in CONVERSION:
        return "conversion"
    if base == "MOV" or op.startswith("IMAD.MOV"):
        return "MOV"
    if op.startswith(SYNC):
        return "sync"
    if base in LOADS:
        return "loads"
    return "rest"


def _instructions(body: str):
    """(address, opcode) of each instruction of one function's SASS."""
    out = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)(.*)", line)
        if m:
            out.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def consumer_loops(body: str) -> list:
    """The consumer K loops of one function, counted by class per stage
    (HGMMAs / 4 stages): the backward branches whose range holds HGMMAs,
    smallest first, each kept unless it overlaps one kept before (the
    retry stubs of the barrier waits past the function's end branch back
    into the loops from afar)."""
    ins = _instructions(body)
    loops = []
    for addr, op, rest in ins:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if not m or int(m.group(1), 16) > addr:
            continue
        lo = int(m.group(1), 16)
        inside = [(a, o) for a, o, _ in ins if lo <= a <= addr]
        if sum(o.startswith("HGMMA") for _, o in inside) >= 4:
            loops.append((lo, addr, inside))
    kept = []
    for lp in sorted(loops, key=lambda lp: lp[1] - lp[0]):
        if all(lp[1] < k[0] or k[1] < lp[0] for k in kept):
            kept.append(lp)
    out = []
    for lo, hi, inside in sorted(kept):
        counts = collections.Counter(_klass(o) for _, o in inside)
        rest = collections.Counter(o for _, o in inside
                                   if _klass(o) == "rest")
        shapes = sorted({o for _, o in inside if o.startswith("HGMMA")})
        stages = counts["HGMMA"] / 4
        out.append({"range": [hex(lo), hex(hi)], "hgmma": shapes,
                    "stages": stages,
                    "per_stage": {c: counts[c] / stages for c in CLASSES},
                    "rest_top": rest.most_common(8)})
    return out


def sass_counts(lib: Path) -> dict:
    """Per-stage SASS counts of the int consumer loops of the wgmma
    kernel's instantiations (BITS 4|8, group 64, not paired, not
    folded)."""
    out = {}
    for name, body in functions(sass(lib)).items():
        m = re.search(r"wg_matmul_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb0ELb0E",
                      name)
        if not m or m.group(1) == "16" or m.group(2) != "4":
            continue
        out[f"q{m.group(1)} BC={m.group(3)}"] = consumer_loops(body)
    return out


def floor(bits: int, hgmma: str) -> dict:
    """The issue floor of one stage: four HGMMA, one FFMA per accumulator
    register (N / 2), 1.5 (int4) or 2 (int8) instructions per code (32
    codes a thread)."""
    n = int(re.search(r"64x(\d+)x16", hgmma).group(1))
    return {"HGMMA": 4, "FFMA": n // 2,
            "conversion": 48 if bits == 4 else 64}


def build_tree(tree: Path, name: str, defines=()) -> Path:
    """The ``.cu`` files of another checkout built with this checkout's
    compile command (and ``-D`` each of ``defines``) into
    ``build/timeline/<name>/``."""
    from repro_torch.kernels import cuda_lib
    out = BUILD / name / "dequant_matmul.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    units = sorted((tree / "src" / "repro_torch" / "kernels" / "csrc")
                   .glob("*.cu"))
    subprocess.run(cuda_lib.compile_command(units, out, defines),
                   check=True, capture_output=True, text=True)
    return out


def _plain_name(name: str) -> str:
    """A function's name without the per-file hash of its anonymous
    namespace."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)


def compare(lib: Path, other: Path) -> dict:
    """Which functions' SASS differs between two libraries (names without
    their anonymous namespace's hash)."""
    mine = {_plain_name(k): v for k, v in functions(sass(lib)).items()}
    theirs = {_plain_name(k): v for k, v in functions(sass(other)).items()}
    differ = sorted(k for k in set(mine) | set(theirs)
                    if mine.get(k) != theirs.get(k))
    return {"functions": len(mine), "differ": [_short(k) for k in differ]}


def _short(name: str) -> str:
    """``wg_matmul_kernel<4,4,128,0,0>`` of a mangled kernel name."""
    m = re.search(r"(\w\w_matmul_kernel)I((?:L[a-z]\d+E)+)", name)
    if not m:
        return name
    return f"{m.group(1)}<{','.join(re.findall(r'L[a-z](\d+)E', m.group(2)))}>"


def dump(lib: Path, where: Path) -> list:
    """The SASS of the int wgmma instantiations at group 64 into
    ``where``, one file each."""
    where.mkdir(parents=True, exist_ok=True)
    names = []
    for name, body in functions(sass(lib)).items():
        m = re.search(r"wg_matmul_kernelILi(\d+)ELi4ELi(\d+)ELb0ELb(\d)E",
                      name)
        if m and m.group(1) != "16":
            path = where / (f"q{m.group(1)}_bc{m.group(2)}"
                            f"{'_fold' if m.group(3) == '1' else ''}.sass")
            path.write_text(body)
            names.append(path.name)
    return names


def _median(xs):
    return statistics.median(xs) if xs else None


def _covered(lo: int, hi: int, spans) -> int:
    """Cycles of [lo, hi) inside the union of ``spans``."""
    cut = sorted((max(a, lo), min(b, hi)) for a, b in spans
                 if min(b, hi) > max(a, lo))
    got, end = 0, lo
    for a, b in cut:
        a = max(a, end)
        if b > a:
            got += b - a
            end = b
    return got


def analyse(stamps, blocks: int, stages: int, nst: int) -> dict:
    """Median cycles per steady stage (2 .. nst - 3) for each consumer
    warpgroup: the stage's period (issue to issue), each point's offset
    from the stage's issue, the steps into each point in their order (the
    first one from the previous stage's last point), the issue window
    (turn to issued), the flush window (waited to flushed), the cycles
    from its issue to the other warpgroup's next issue, and the share of
    its flush window inside the other warpgroup's wgmma windows (issued to
    the wait's return: ``drained`` in the 128-token body, ``waited`` in
    the wide one); the warpgroups' flush skew; the producer's period and
    how long before a consumer's full wait for a stage returned the
    producer was free to load it."""
    P = len(POINTS)
    ix = {name: i for i, name in enumerate(POINTS)}

    def t(b, role, it, p):
        return stamps[((b * ROLES + role) * stages + it) * P + ix[p]]

    steady = range(2, min(nst, stages) - 2)

    def done(b, role, it):
        return t(b, role, it, "drained") or t(b, role, it, "waited")

    out = {}
    for role in (0, 1):
        other = 1 - role
        seen = [b for b in range(blocks) if t(b, role, 2, "issued")]
        period = [t(b, role, it + 1, "issued") - t(b, role, it, "issued")
                  for b in seen for it in steady]
        offs = {}
        for name in POINTS:
            if name in PRODUCER:
                continue
            vals = [t(b, role, it, name) - t(b, role, it, "issued")
                    for b in seen for it in steady if t(b, role, it, name)]
            if vals:
                offs[name] = _median(vals)
        order = sorted(offs, key=offs.get)
        steps = [(order[0], _median(period) - (offs[order[-1]]
                                               - offs[order[0]]))]
        steps += [(b, offs[b] - offs[a]) for a, b in zip(order, order[1:])]
        issue = [t(b, role, it, "issued") - t(b, role, it, "turn")
                 for b in seen for it in steady if t(b, role, it, "turn")]
        flush = [t(b, role, it, "flushed") - t(b, role, it, "waited")
                 for b in seen for it in steady
                 if t(b, role, it, "flushed") and t(b, role, it, "waited")]
        # the other warpgroup's next issue: its stage it (warpgroup 0) or
        # it + 1 (warpgroup 1), the stage that follows in turn
        to_other = [t(b, other, it + role, "issued")
                    - t(b, role, it, "issued")
                    for b in seen for it in steady
                    if t(b, other, it + role, "issued")]
        overlap = []
        for b in seen:
            spans = [(t(b, other, j, "issued"), done(b, other, j))
                     for j in range(max(0, steady.start - 2),
                                    min(nst, stages))
                     if t(b, other, j, "issued") and done(b, other, j)]
            for it in steady:
                lo, hi = t(b, role, it, "waited"), t(b, role, it, "flushed")
                if lo and hi > lo:
                    overlap.append(_covered(lo, hi, spans) / (hi - lo))
        out[f"wg{role}"] = {"period": _median(period), "offsets": offs,
                            "steps": steps, "blocks": len(seen),
                            "issue_window": _median(issue),
                            "flush_window": _median(flush),
                            "to_other_issue": _median(to_other),
                            "flush_overlap": _median(overlap)}
    skew = [abs(t(b, 0, it, "flushed") - t(b, 1, it, "flushed"))
            for b in range(blocks) for it in steady
            if t(b, 0, it, "flushed") and t(b, 1, it, "flushed")]
    prod = [t(b, 2, it + 1, "empty") - t(b, 2, it, "empty")
            for b in range(blocks) for it in steady
            if t(b, 2, it + 1, "empty") and t(b, 2, it, "empty")]
    # the consumers stamp "full" for stage it + 1 in stage it's iteration
    lead = [t(b, 0, it, "full") - t(b, 2, it + 1, "empty")
            for b in range(blocks) for it in steady
            if t(b, 0, it, "full") and t(b, 2, it + 1, "empty")]
    out["flush_skew"] = _median(skew)
    out["producer_period"] = _median(prod)
    out["producer_lead"] = _median(lead)
    return out


def _stamped_lib(tree, lockstep: bool) -> Path:
    """The stamped library: this checkout's sources, or ``tree``'s, with
    the turns compiled out if ``lockstep``."""
    from repro_torch.kernels import cuda_lib
    defines = (cuda_lib.STAMP_MACRO,) + ((cuda_lib.LOCKSTEP_MACRO,)
                                         if lockstep else ())
    if tree is None:
        return cuda_lib.build(defines=defines, build_dir=BUILD)
    name = Path(tree).resolve().name + ("-lockstep" if lockstep else "")
    return build_tree(Path(tree), name, defines)


def timeline(torch, cs, tile=None, tree=None, lockstep=False) -> dict:
    """Run each (bank, row) of ``BANKS`` x ``ROWS`` once on the stamped
    library and analyse its stamps; the wrappers' library is loaded again
    after. ``tile`` (128 or 160) runs the plan's splits on that wgmma
    token tile."""
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.kernels import q4_matmul as qk
    lib = cuda_lib.load(_stamped_lib(tree, lockstep))
    dims = (ctypes.c_int * 4)()
    lib.repro_stamps_layout(dims)
    blocks, roles, stages, points = list(dims)
    assert roles == ROLES and points == len(POINTS), (roles, points)
    buf = (ctypes.c_ulonglong * (blocks * roles * stages * points))()
    plan_fn, out = qk.launch_plan, {}
    if tile:
        qk.launch_plan = lambda *a: plan_fn(*a)._replace(
            block_c=tile, body="wgmma_wide" if tile == 160 else "wgmma")
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        for bank, (bits, g) in BANKS.items():
            for row in ROWS:
                c, k, n = cs.SHAPES[row]
                x, w = cs._make_bank(torch, gen, g, c, k, n, bits)
                ops.grouped_q_matmul(x, w)
                torch.cuda.synchronize()
                cuda_lib.check(lib.repro_stamps_clear(), "stamps clear")
                ops.grouped_q_matmul(x, w)
                torch.cuda.synchronize()
                cuda_lib.check(lib.repro_stamps_read(buf), "stamps read")
                plan = qk.launch_plan(c, k, n, bits)
                folded = qk.fold_splits(plan, g, c, n, bits)
                nst = -(-(k if folded else min(k, plan.k_chunk))
                        // qk.SPLIT_GRAIN)
                res = analyse(list(buf), blocks, stages, nst)
                res.update(plan=list(plan), folded=folded, stages=nst,
                           tensor_floor=4 * min(plan.block_c, c))
                out[f"{bank} {row}"] = res
                del x, w
    finally:
        qk.launch_plan = plan_fn
        cuda_lib.load(cuda_lib.build())
    return out


def _cycles(v) -> str:
    return "-" if v is None else f"{v:.0f}"


def report(log, counts: dict, lines: dict) -> None:
    for kern, loops in counts.items():
        bits = int(kern[1])
        for lp in loops:
            fl = floor(bits, lp["hgmma"][0])
            per = ", ".join(f"{c} {lp['per_stage'][c]:.1f}"
                            + (f" (floor {fl[c]})" if c in fl else "")
                            for c in CLASSES)
            log(f"  sass {kern} {'/'.join(lp['hgmma'])}: {lp['stages']:g} "
                f"stages a trip; per stage {per}; rest "
                f"{lp['rest_top']}")
    for case, r in lines.items():
        for wg in ("wg0", "wg1"):
            w = r[wg]
            steps = ", ".join(f"{name} +{v:.0f}" for name, v in w["steps"])
            share = ("-" if w["flush_overlap"] is None
                     else f"{100 * w['flush_overlap']:.0f}%")
            log(f"  timeline {case} {wg} (plan {r['plan']}, "
                f"{'folded, ' if r['folded'] else ''}{r['stages']} stages, "
                f"{w['blocks']} blocks): {_cycles(w['period'])} cycles a "
                f"stage (tensor floor {r['tensor_floor']}); issue window "
                f"{_cycles(w['issue_window'])}, flush window "
                f"{_cycles(w['flush_window'])}, to the other's issue "
                f"{_cycles(w['to_other_issue'])}, flush under the other's "
                f"wgmmas {share}; {steps}")
        log(f"  timeline {case}: flush skew between the warpgroups "
            f"{_cycles(r['flush_skew'])} cycles, producer period "
            f"{_cycles(r['producer_period'])} cycles, a stage free to load "
            f"{_cycles(r['producer_lead'])} cycles before its full wait "
            "returned")


def run(torch, cs, parent=None, tile=None, tree=None,
        lockstep=False) -> dict:
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    what = (f"{tree or 'this checkout'}"
            + (", turns compiled out" if lockstep else ""))
    cs.log(f"timeline of {what} on {smi}")
    out = {"nvidia_smi": smi, "sources": what, "sass": sass_counts(lib),
           "dumped": dump(lib, ROOT / "chiprun_out" / "timeline_sass")}
    if parent is not None:
        plib = build_tree(Path(parent), "parent")
        out["parent"] = compare(lib, plib)
        out["parent_sass"] = sass_counts(plib)
        cs.log(f"  sass against {parent}: {out['parent']['functions']} "
               f"functions, differ: {out['parent']['differ']}")
        cs.log(f"  the parent's consumer loops ({parent}):")
        report(cs.log, out["parent_sass"], {})
        cs.log("  this checkout's:")
    out["timeline"] = timeline(torch, cs, tile, tree, lockstep)
    report(cs.log, out["sass"], out["timeline"])
    return out
