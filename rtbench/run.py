"""The benchmark of rtmm_tpu_torch on NVIDIA cards: one run of one cell.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
"workloads"; rtbench/harness.py says which files make it up. The last
line on stdout is the result as one JSON object: "correct", "attempted",
"failed", "metrics" (the cell's end-to-end metrics untraced, its
per-layer ones with --trace 1), "device", with --trace 1 "breakdown",
and last "check", each number compared beside its limit (also the last
lines on stderr).

Exit codes: 0 a result was printed; 2 no card, or fewer than the cell
asks for; 3 the process held jax, jaxlib, flax or rtmm_tpu after the
window; 1 any other failure. Every cache of the program lives under
build/ in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 rtbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from rtbench import harness
    mark = harness.SetupMarks()
    mark("python")
    import torch
    mark("torch")
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"torch sees {torch.cuda.device_count()}")
        return 2
    mark("cuda-init")
    from rtbench import runner
    mark("harness")
    torch.set_num_threads(4)
    result = runner.run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", mark)
    held = harness.forbidden_modules()
    if held:
        harness.log(f"the process holds {held}: no result")
        return 3
    line = {k: v for k, v in result.items() if not k.startswith("_")}
    for name, c in line["check"].items():
        harness.log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
