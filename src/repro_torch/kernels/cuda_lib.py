"""Build, load and launch the port's CUDA kernels.

The ``.cu`` files of ``csrc/`` (``dequant_matmul.cu``, which includes the
wgmma body ``wgmma_body.cuh`` and its wide-token consumers
``wgmma_wide.cuh``) are compiled by hand with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The build
happens at first use, from the sources in the checkout, into
``build/kernels/`` at the repo root (listed in ``.gitignore``); the
library's file name carries a digest of every file under ``csrc/`` and the
flags, so a changed source or header never loads a stale library. There
is no fallback: a missing ``nvcc``, a failed build or a refused launch
raises.

``LAUNCHES`` holds one plain integer per kernel wrapper; a wrapper adds one
where it launches its kernel and nowhere else. ``GROUP_LAUNCHES`` splits
the grouped wrappers' launches by the bank's expert count G, and
``BODY_LAUNCHES`` every dequant-matmul launch by (wrapper, body): the
``mma_sync`` body serves token tiles up to 64, the ``wgmma`` body the
128-token tile and the ``wgmma_wide`` body the 160-token tile
(``q4_matmul.launch_plan``). ``SPLIT_LAUNCHES`` books, the same way, the
launches whose plan splits K, and ``FOLDED_LAUNCHES`` those of them that
ran folded (``q4_matmul.fold_splits``: one block a tile runs the splits in
turn); each of the others, spread over a block a split, reduces its split
partials in its own epilogue, with no second kernel.

The wgmma bodies can stamp ``clock64()`` at the points of a pipeline
stage into a device buffer when compiled with ``-D`` :data:`STAMP_MACRO`,
and run their int consumers without turns (both consumer warpgroups
issuing at will) with ``-D`` :data:`LOCKSTEP_MACRO`. Only
``tools/consumer_timeline.py`` builds such a library (``build(defines=
(STAMP_MACRO,), build_dir=...)``, into a directory of its own); the
library the wrappers build and load defines neither.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_STEM = "dequant_matmul"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {
    "q4_matmul": 0,       # B1: quantized_matmul(bits=4)
    "q8_matmul": 0,       # B2: quantized_matmul(bits=8)
    "grouped_q4": 0,      # B3: grouped_quantized_matmul(bits=4)
    "grouped_q8": 0,      # B3: grouped_quantized_matmul(bits=8)
    "grouped_bf16": 0,    # B4: grouped_bf16_matmul
}

#: launches of the grouped wrappers by (wrapper, G), e.g. the 8-expert
#: int4 bank of the speculative draft: ("grouped_q4", 8)
GROUP_LAUNCHES: "collections.Counter[Tuple[str, int]]" = collections.Counter()

#: launches of every matmul wrapper by (wrapper, body), e.g. the int4 bank
#: of a prefill: ("grouped_q4", "wgmma")
BODY_LAUNCHES: "collections.Counter[Tuple[str, str]]" = collections.Counter()

#: the launches of BODY_LAUNCHES whose plan splits K, by (wrapper, body)
SPLIT_LAUNCHES: "collections.Counter[Tuple[str, str]]" = collections.Counter()

#: the launches of SPLIT_LAUNCHES that ran folded, by (wrapper, body)
FOLDED_LAUNCHES: "collections.Counter[Tuple[str, str]]" = \
    collections.Counter()

#: the preprocessor macro that compiles the wgmma bodies' stage stamps in
STAMP_MACRO = "REPRO_STAMPS"
#: the macro that compiles the int consumers' turns out (the timeline's
#: baseline: both consumer warpgroups issue at will)
LOCKSTEP_MACRO = "REPRO_LOCKSTEP"

#: nvcc's output (ptxas registers, shared memory, spills) of the library
#: in use: set by the build, or read back from the log kept beside it
BUILD_LOG = ""

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    GROUP_LAUNCHES.clear()
    BODY_LAUNCHES.clear()
    SPLIT_LAUNCHES.clear()
    FOLDED_LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ at first use and need the CUDA toolkit")
    return path


def _sources() -> List[Path]:
    """Every file under ``csrc/``, in name order."""
    return sorted(p for p in CSRC.iterdir() if p.is_file())


def _lib_path(defines=(), build_dir: Optional[Path] = None) -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    for d in defines:
        h.update(b"\0-D" + d.encode())
    return (build_dir or BUILD_DIR) / f"{LIB_STEM}-{h.hexdigest()[:16]}.so"


def compile_command(units, out: Path, defines=()) -> List[str]:
    """The nvcc command that compiles ``units`` into the library ``out``,
    with ``-D`` for each of ``defines``."""
    return [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
            str(out), *map(str, units)]


def build(defines=(), build_dir: Optional[Path] = None) -> Path:
    """Compile the ``.cu`` files of ``csrc/`` unless an up-to-date library
    exists; returns the library's path. ``defines`` and ``build_dir`` are
    for a tool's own build (the stamped timeline); the wrappers' library
    takes neither."""
    global BUILD_LOG
    lib = _lib_path(defines, build_dir)
    log = lib.with_suffix(".log")
    if lib.exists():
        BUILD_LOG = log.read_text() if log.exists() else ""
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    units = [p for p in _sources() if p.suffix == ".cu"]
    cmd = compile_command(units, tmp, defines)
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    BUILD_LOG = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {units}:\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, lib)
    return lib


def load(path: Path) -> ctypes.CDLL:
    """Load the library at ``path``, bind its entry points and make it the
    one the wrappers launch."""
    global _LIB
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    plan = [i32] * 5          # block_n, block_c, k_chunk, splits, fold
    # ..., out, ws, counters, G, M, K, N, [group,] plan, stream
    lib.repro_dequant_matmul.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, *plan, vp]
    lib.repro_dequant_matmul.restype = i32
    lib.repro_bf16_matmul.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, *plan, vp]
    lib.repro_bf16_matmul.restype = i32
    lib.repro_error_string.argtypes = [i32]
    lib.repro_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def dequant_lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    return _LIB if _LIB is not None else load(build())


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        msg = dequant_lib().repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

