"""Build and load the port's CUDA kernels (nvcc -> .so -> ctypes).

Each csrc/<name>.cu has a plain C interface and is compiled on first use
by nvcc into build/kernels/ at the root of the checkout (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -Xptxas -v

-fmad=false keeps every a*b+c as two rounded operations, as PyTorch's
eager ops round them, so a kernel and its plain PyTorch version agree
bit for bit where they do the same operations in the same order. No
--use_fast_math: divisions and square roots stay correctly rounded.

The file name carries a hash of the source and the flags, so an edited
source is rebuilt; ptxas's register/shared-memory/spill report is kept
beside the library (ptxas_report). Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("tile_trace", "group_trace", "path_shade", "prologue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels are "
                           "built on the machine with the card")
    return str(path)


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    return src, lib, lib.with_suffix(".ptxas.txt")


def _tmp(lib: Path) -> Path:
    return lib.with_name(f"{lib.name}.{os.getpid()}.tmp")


def _start(name: str) -> subprocess.Popen | None:
    """Start nvcc for `name` unless its library is built; None if built."""
    src, lib, _ = _paths(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(_tmp(lib)), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    _, lib, report = _paths(name)
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    report.write_text(out)
    os.replace(_tmp(lib), lib)


def build_all(names=SOURCES) -> None:
    """Build every named kernel library, one nvcc process per source, all
    started together."""
    procs = {n: _start(n) for n in names}
    for n, p in procs.items():
        if p is not None:
            _finish(n, p)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """ptxas's -v output (registers, shared memory, spills) of the last
    build of csrc/<name>.cu."""
    report = _paths(name)[2]
    return report.read_text() if report.exists() else "(not built)"
