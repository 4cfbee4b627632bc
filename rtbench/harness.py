"""What every cell shares: BENCHMARK.json, the files a cell is made of
(found by name), the seed's streams, the clock and the result line.

A cell (an entry of BENCHMARK.json's "workloads") names a configuration
and a traffic mix. Its files:

  configs/<file of the configuration's entry>   the scene recipe (JSON)
  bases/<the recipe's "base">.py                its base mesh's arrays
  traffic/<traffic>.json                        the mix's parameters
  drivers/<the mix's "entry">.py                the loop that drives it
  metrics/<metric>.py, or metrics/<metric's name up to its first dot>.py
                                                one reader per metric
  checks/<workload>.json                        the limits of `correct`

A later cell adds files; it edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names the benchmark's process may never hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "rtmm_tpu")


class Cell:
    """One workload of BENCHMARK.json with its files read; `root` holds
    BENCHMARK.json and rtbench/ (the checkout's root by default)."""

    def __init__(self, name: str, root: Path | None = None):
        self.root = Path(root or ROOT)
        self.dir = self.root / "rtbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; one "
                           f"of {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = json.loads(
            (self.root / configs[self.workload["config"]]["file"])
            .read_text())
        self.traffic = json.loads(
            (self.dir / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.chips = int(self.workload["chips"])
        check = self.dir / "checks" / f"{name}.json"
        self.limits = (json.loads(check.read_text())["limits"]
                       if check.exists() else None)

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: the end-to-end ones untraced,
        the per-layer ones traced; a metric with a "workloads" key only
        in the cells it lists."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def base(self) -> dict:
        return base_arrays(self.config["recipe"], self.dir)

    def driver(self):
        """The Driver class of the traffic's entry."""
        entry = self.traffic["entry"]
        return _load(self.dir / "drivers" / f"{entry}.py",
                     f"rtbench_driver_{entry}").Driver

    def reader(self, metric: str):
        """metrics/<metric>.py, else metrics/<metric up to its first
        dot>.py."""
        for stem in (metric, metric.split(".", 1)[0]):
            path = self.dir / "metrics" / f"{stem}.py"
            if path.exists():
                return _load(path, "rtbench_metric_" + stem.replace(
                    ".", "_").replace("-", "_"))
        raise FileNotFoundError(f"no reader for metric {metric!r} under "
                                f"{self.dir / 'metrics'}")


def base_arrays(recipe: dict, rtbench_dir: Path | None = None) -> dict:
    """The base mesh's arrays from bases/<recipe["base"]>.py."""
    name = recipe["base"]
    path = Path(rtbench_dir or ROOT / "rtbench") / "bases" / f"{name}.py"
    return _load(path, f"rtbench_base_{name}").arrays(recipe)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's independent stream `stream`: 1 the cameras, 2 the
    pixel pools, 3 the path tracer's draws, 4 the check's sample."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def seconds_since_process_start() -> float:
    """Seconds since this process started, on the boot clock the kernel
    stamps a process's start with (/proc/self/stat field 22)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


class SetupMarks:
    """The ends of a run's set-up phases: per phase the seconds since the
    process started, the process's CPU seconds and its major page faults
    (pages read from disk, as a cold file cache shows) so far."""

    def __init__(self):
        self.marks: list[tuple[str, float, float, int]] = []

    def __call__(self, phase: str) -> None:
        use = resource.getrusage(resource.RUSAGE_SELF)
        self.marks.append((phase, seconds_since_process_start(),
                           use.ru_utime + use.ru_stime, use.ru_majflt))

    def log(self) -> None:
        log("[setup] at the end of each phase: seconds since the process "
            "started / CPU seconds / major page faults: " + ", ".join(
                f"{k} {t:.3f}/{c:.3f}/{f}" for k, t, c, f in self.marks))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
