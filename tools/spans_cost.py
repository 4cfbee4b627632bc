"""What the port's spans and counters (rtmm_tpu_torch/utils/spans.py) cost
on the host, off and on.

    python3 tools/spans_cost.py loop [--n 100000]
    python3 tools/spans_cost.py cell --workload <cell> --seed <n>
                                     [--seconds 51]

loop: microseconds per empty `with spans.span(...)` and per
`spans.sync(site, x)` of a 0-d CPU tensor (against `int(x)` alone), each
over n calls, with spans off and on (on: records taken and dropped every
10,000 calls), the median of 5 rounds, and the bare loop's own
microseconds ("loop_us", which each of the others includes); one JSON
line.

cell: one untraced run of the benchmark (rtbench/run.py) with spans on
from the start of the process to its end, so that its end-to-end metrics
set against spans-off runs of the same cell give the cost of the spans
where the work happens. The records are dropped after every step of the
cell's driver, as a consumer of them would take them (--keep holds them
all to the end instead). Its last stdout line is rtbench/run.py's
result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _per_call_us(fn, n: int) -> float:
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(n)
        rounds.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(rounds)


def loop(n: int) -> dict:
    import torch
    from rtmm_tpu_torch.utils import spans
    x = torch.tensor(3)

    def empty(k):
        for i in range(k):
            with spans.span("rtmm.cost"):
                pass
            if not i % 10000:
                spans.take()

    def synced(k):
        for i in range(k):
            spans.sync("cost", x)
            if not i % 10000:
                spans.take()

    def plain(k):
        for i in range(k):
            int(x)
            if not i % 10000:
                pass

    def bare(k):
        for i in range(k):
            if not i % 10000:
                pass

    out = {"n": n, "loop_us": _per_call_us(bare, n),
           "int_us": _per_call_us(plain, n)}
    for state in ("off", "on"):
        with spans.on() if state == "on" else contextlib.nullcontext():
            out[f"span_{state}_us"] = _per_call_us(empty, n)
            out[f"sync_{state}_us"] = _per_call_us(synced, n)
    spans.take()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 tools/spans_cost.py")
    parser.add_argument("mode", choices=("loop", "cell"))
    parser.add_argument("--n", type=int, default=100000)
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--keep", action="store_true")
    args = parser.parse_args(argv)
    if args.mode == "loop":
        print(json.dumps(loop(args.n)), flush=True)
        return 0
    from rtbench import harness, run as bench_run
    from rtmm_tpu_torch.utils import spans
    if not args.keep:
        driver = harness.Cell.driver

        def dropping(cell):
            class Driver(driver(cell)):
                def step(self):
                    super().step()
                    spans.take()
            return Driver

        harness.Cell.driver = dropping
    with spans.on():
        return bench_run.main(["--workload", args.workload, "--seed",
                               str(args.seed), "--seconds",
                               str(args.seconds), "--trace", "0"])


if __name__ == "__main__":
    sys.exit(main())
