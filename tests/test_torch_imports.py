"""The PyTorch port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py`` or a script in ``tools/``) imports JAX, ml_dtypes,
msgpack or the JAX package ``repro``, and every module imports on a host
without nvcc or a GPU. The card's host has no msgpack, zstandard or
ml_dtypes wheel: the only import of ``zstandard`` is the checkpoint
reader's one optional import, inside a function, guarded by an
``except ImportError``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "msgpack", "repro")
OPTIONAL = "zstandard"          # read zstd checkpoint frames if present


def sources():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


def module_names():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = [name for name in imported(ast.parse(path.read_text()))
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _guarded_by_import_error(node: ast.Try) -> bool:
    return any(isinstance(h.type, ast.Name) and h.type.id in (
        "ImportError", "ModuleNotFoundError") for h in node.handlers)


def test_zstandard_only_as_one_guarded_optional_import():
    """One import in all, in the checkpoint reader, under a ``try`` that
    catches ``ImportError``; that it runs only inside a function shows in
    the next test (importing every module leaves ``zstandard`` out of
    ``sys.modules``)."""
    guarded, total = [], 0
    for path in sources():
        tree = ast.parse(path.read_text())
        total += sum(n.split(".")[0] == OPTIONAL for n in imported(tree))
        for node in ast.walk(tree):
            if isinstance(node, ast.Try) and _guarded_by_import_error(node):
                guarded += [path.name for stmt in node.body
                            for n in imported(stmt)
                            if n.split(".")[0] == OPTIONAL]
    assert guarded == ["checkpoint.py"] and total == 1


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {module_names()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + (OPTIONAL,)!r}]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(module_names()) >= 20
