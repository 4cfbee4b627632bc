"""Run rows of the port's benchmark on one NVIDIA card, one process each.

    python3 tools/bench_rows.py [--out DIR] [ROW ...]

A ROW is a bench config number, 1-11, or one of the environment variants
5c (config 5 with RTMM_PT_COMPRESSED=1), 8b and 10b (configs 8 and 10
with RTMM_INSTANCE_BAKED=1); with none given, all fourteen run, config 7
last. Every kernel is built first, so each row loads the built library.
Each row is `python3 -m rtmm_tpu_torch.bench --config N` in a process of
its own; its stdout and stderr go to DIR/<row>.out and DIR/<row>.err
(default build/bench_rows). The script prints, per row, its exit code,
its wall seconds, its stage seconds and launches and its row (JSON);
then the card as nvidia-smi reports it. Exits non-zero without a card or
when a row fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("3", "1", "2", "11", "6", "9", "4", "8", "10", "5", "5c", "8b",
         "10b", "7")
VARIANTS = {"5c": ("5", "RTMM_PT_COMPRESSED"),
            "8b": ("8", "RTMM_INSTANCE_BAKED"),
            "10b": ("10", "RTMM_INSTANCE_BAKED")}
ROW_TIMEOUT_S = 900


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(ROOT / "build" / "bench_rows"))
    parser.add_argument("rows", nargs="*", metavar="ROW",
                        help=f"rows to run, of {' '.join(ORDER)} (all)")
    args = parser.parse_args()
    rows = args.rows or list(ORDER)
    if set(rows) - set(ORDER):
        parser.error(f"unknown rows {sorted(set(rows) - set(ORDER))}")
    import torch
    if not torch.cuda.is_available():
        print("bench_rows: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from rtmm_tpu_torch.ops import _build
    _build.build_all()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failed = []
    for row in rows:
        n, var = VARIANTS.get(row, (row, None))
        env = dict(os.environ)
        for name in ("RTMM_PT_COMPRESSED", "RTMM_INSTANCE_BAKED"):
            env.pop(name, None)
        if var:
            env[var] = "1"
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "rtmm_tpu_torch.bench", "--config",
                 n], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=ROW_TIMEOUT_S)
            rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as exc:
            rc, stdout, stderr = "timeout", exc.stdout or "", exc.stderr or ""
            stdout, stderr = (x.decode() if isinstance(x, bytes) else x
                              for x in (stdout, stderr))
        seconds = time.perf_counter() - t0
        (out / f"{row}.out").write_text(stdout)
        (out / f"{row}.err").write_text(stderr)
        lines = stdout.strip().splitlines()
        info = [line for line in stderr.splitlines()
                if line.startswith(("[bench stages]", "[bench launches]",
                                    "[bench orbit]", "pt live"))]
        print(f"[row {row}] rc {rc}, {seconds:.1f} s", flush=True)
        for line in info:
            print(f"  {line}", flush=True)
        print(f"  {lines[-1] if lines else '(no row)'}", flush=True)
        if rc != 0:
            failed.append(row)
            print(f"  stderr tail: {stderr[-1500:]}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"failed": failed}))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
