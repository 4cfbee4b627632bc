"""The port stands alone: no module of rtmm_tpu_torch, nor chip_smoke.py
or the port's tools, imports JAX or the JAX package, and importing the
port's entry points leaves JAX unloaded."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "rtmm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "rtmm_tpu")


def _imported_roots(path: Path) -> set[str]:
    """Top-level names of every absolute import in the file."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


# Modules the scan must reach by name: the main path's kernel wrapper,
# the multi-device path, whose ranks run outside the test process, and
# the benchmark, which runs where JAX is not installed.
NAMED = ("rtmm_tpu_torch/ops/tile_trace.py", "chip_smoke.py",
         "rtmm_tpu_torch/bench.py",
         "rtmm_tpu_torch/parallel/sharding.py",
         "rtmm_tpu_torch/parallel/launch.py",
         "rtmm_tpu_torch/parallel/entry.py")


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert set(NAMED) <= names
    assert len(names) >= 28


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_or_reference_import(path):
    # Exact top-level names: "rtmm_tpu_torch" is allowed, "rtmm_tpu" not.
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_entry_points_leave_jax_unloaded():
    code = ("import sys, rtmm_tpu_torch.app, rtmm_tpu_torch.render.renderer, "
            "rtmm_tpu_torch.parallel.entry, rtmm_tpu_torch.bench; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.') or m == 'rtmm_tpu' "
            "or m.startswith('rtmm_tpu.')))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
