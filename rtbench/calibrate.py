"""Readings the limits of `correct` are set from: for each seed, a run of
the cell at its own sizes and load (a short window) with the numbers the
check compares, then the control on the same pixels, the reference in
bfloat16 put in the renderer's place; and, on the fault seeds, a run with
each fault the cell can have planted (rtbench/faults.py). One process
for all seeds.

    python3 rtbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 3]

Prints a JSON line per seed: {"seed", "sound": {number: value},
"subsets": {name: pixels in it}, "pixels", "worst": up to five [x, y,
renderer's u8, reference's u8] of pixels off by more than two levels,
"correct", "control": {number: value} and "control_correct" (control
seeds only), "frames", "mrays_s"}; then a line per fault seed and fault:
{"seed", "fault", "numbers", "correct"}. Not run by the benchmark's own
runs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 rtbench/calibrate.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from rtbench import check, faults, harness, runner, scene
    cell = harness.Cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    for seed in (int(s) for s in args.seeds.split(",") if s):
        res = runner.run_cell(cell, seed, args.seconds, False, args.device)
        run = res["_run"]
        got = res["_drawn"]["values"].astype("int32")
        want = res["_want"].cpu().numpy().astype("int32")
        bad = (abs(got - want).max(-1) > 2).nonzero()[0][:5]
        line = {"seed": seed,
                "sound": {k: v["value"] for k, v in res["check"].items()},
                "subsets": {k: int(m.sum())
                            for k, m in res["_subsets"].items()},
                "pixels": int(len(got)),
                "worst": [[int(res["_drawn"]["px"][i]),
                           int(res["_drawn"]["py"][i]), got[i].tolist(),
                           want[i].tolist()] for i in bad],
                "correct": res["correct"],
                "frames": run.frames,
                "mrays_s": run.rays / run.window_s / 1e6}
        if seed in controls:
            arrays = scene.reference_arrays(cell)
            line["control"], line["control_correct"] = check.control(
                run.driver, res["_drawn"], arrays, args.device,
                res["_want"], res["_subsets"], cell.limits)
        print(json.dumps(line), flush=True)
        del res, run
        if args.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    for seed in fault_seeds:
        for fault in faults.for_entry(cell.traffic["entry"]):
            patcher = faults.Patcher()
            faults.plant(fault, cell.traffic["entry"], patcher)
            try:
                res = runner.run_cell(cell, seed, args.seconds, False,
                                      args.device)
            finally:
                patcher.undo()
            print(json.dumps({
                "seed": seed, "fault": fault,
                "numbers": {k: v["value"] for k, v in res["check"].items()},
                "correct": res["correct"]}), flush=True)
            del res
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
