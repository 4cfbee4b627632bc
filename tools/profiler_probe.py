"""Where does torch.profiler lose the port's kernels in a long process?

Runs chip_smoke.py's phases in order, in this one process, up to its
phase 17 (the stats path). After each phase it profiles two canaries,
each alone: one launch of a hand-written kernel (ops/path_shade.py's
pt_bounce on 64 lanes) and one PyTorch op. In place of phase 17 it
profiles config 3's 32-frame orbit (render_frames) in this process, as
phase 17 did before it moved to a process of its own, counts the
trace's kernel events by name, and stops.

    python3 tools/profiler_probe.py [--route kernels|plain|loaded]
    python3 tools/profiler_probe.py --drift SECONDS

--route kernels   the port as it is (the default).
--route plain     the prologue wrappers (ops/prologue.py: tile_frusta,
                  cluster_select) replaced by their plain versions on the
                  card everywhere, so that the prologue's kernel library
                  is never loaded: the kernel-against-plain cases of
                  the two (phases 6c, 7c, 8, 14) are skipped and no
                  launch of the two is expected.
--route loaded    as plain, with the prologue's library built and loaded
                  (ctypes) before the first phase, and never launched.

--drift SECONDS runs no phase: every 20 s for SECONDS, with the card kept
busy in between, it profiles a 100 ms window that holds one PyTorch op
and one pt_bounce launch in its middle, and prints how far each traced
kernel starts from its launch call on the host's clock (the runtime
event of the same correlation id; normally a few microseconds after
it), or that the kernel is missing from the trace.

The spin-queued timings of chip_smoke.py do not raise here when the card
reaches the queued calls early (several routes may share one card); the
probe does not read times. A launch expectation of chip_smoke.py that
fails is printed, and the run goes on. Prints one JSON line per profiled session,
prefixed "[probe]", then the card as nvidia-smi reports it. Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


class _Done(Exception):
    """Raised in place of phase 17 to end chip_smoke.main."""


def _trace(fn) -> dict:
    """One call of fn under utils/stats.py's profiler_trace: its kernel
    events by name (first 48 characters) and the device busy share."""
    from rtmm_tpu_torch.utils import stats
    with tempfile.TemporaryDirectory() as logdir:
        with stats.profiler_trace(logdir):
            fn()
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        busy = stats.device_busy(logdir)
    names = collections.Counter(e["name"][:48] for e in events
                                if e.get("cat") == "kernel")
    return {"kernels": busy["kernels"], "share": busy["share"],
            "by_name": dict(names)}


def _canary():
    """One pt_bounce launch on 64 random lanes, as a function."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.ops import path_shade
    n = 64
    f3 = [torch.randn(n, 3, device="cuda") for _ in range(4)]
    t = torch.rand(n, device="cuda")
    alive = torch.rand(n, device="cuda") < 0.5
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    sc = path_shade.shading_consts(RenderConfig())
    return lambda: path_shade.bounce(0, 1, n, f3[0], f3[1], f3[2], t, alive,
                                     f3[3], idx, sc)


def _drift(seconds: float) -> None:
    """Kernel start minus launch call start, per traced kernel, every 20 s
    of a busy process (see the module docstring)."""
    from rtmm_tpu_torch.utils import stats
    canary = _canary()
    y = torch.randn(64, 3, device="cuda")
    x = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while True:
        with tempfile.TemporaryDirectory() as logdir:
            with stats.profiler_trace(logdir):
                time.sleep(0.05)
                y * 2.0
                canary()
                torch.cuda.synchronize()
                time.sleep(0.05)
            with open(os.path.join(logdir, "trace.json")) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X" and "dur" in e]
        launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
                  if e.get("cat") == "cuda_runtime"
                  and "correlation" in e.get("args", {})}
        kernels = [e for e in events if e.get("cat") == "kernel"]
        lo = min(float(e["ts"]) for e in events)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
        print("[drift] " + json.dumps({
            "s": round(time.perf_counter() - t0, 1),
            "window_us": round(hi - lo, 1),
            "launch_calls": len(launch),
            "kernels": [{"name": e["name"][:40],
                         "start_minus_launch_us": round(
                             float(e["ts"]) - launch[e["args"][
                                 "correlation"]], 1)
                         if e.get("args", {}).get("correlation") in launch
                         else None}
                        for e in kernels]}), flush=True)
        if time.perf_counter() - t0 >= seconds:
            return
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 20.0:
            x = (x @ x) * 1e-3
            torch.cuda.synchronize()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--route", choices=("kernels", "plain", "loaded"),
                        default="kernels")
    parser.add_argument("--drift", type=float)
    args = parser.parse_args()
    route = args.route
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if args.drift is not None:
        _drift(args.drift)
        return 0
    import chip_smoke
    from rtmm_tpu_torch.ops import path_shade, prologue, tile_trace
    from rtmm_tpu_torch.utils import spans

    t_start = time.perf_counter()

    def report(at: str, **fields) -> None:
        print("[probe] " + json.dumps({
            "route": route, "after": at,
            "s": round(time.perf_counter() - t_start, 1), **fields}),
            flush=True)

    bounce_once = _canary()
    y = torch.randn(64, 3, device="cuda")

    def canary(at: str) -> None:
        saved = dict(path_shade.LAUNCHES)
        bounce = _trace(bounce_once)
        path_shade.LAUNCHES.update(saved)
        op = _trace(lambda: y * 2.0)
        report(at, pt_bounce=bounce["kernels"], torch_op=op["kernels"])

    queued = chip_smoke._queued_ms

    def queued_ms(fn, *args, **kwargs):
        try:
            return queued(fn, *args, **kwargs)
        except RuntimeError:
            return float("nan")

    chip_smoke._queued_ms = queued_ms
    expect = chip_smoke._expect_launches

    def expect_launches(what, expected):
        if route != "kernels":
            expected = {k: v for k, v in expected.items()
                        if k not in prologue.KERNELS}
        try:
            return expect(what, expected)
        except RuntimeError as exc:
            report(what, expectation_failed=str(exc))
            got = spans.launches()
            return {**dict.fromkeys(expected, 0), **got}

    chip_smoke._expect_launches = expect_launches
    if route != "kernels":
        def select(apex, planes, aabb_min, aabb_max, valid, kc, **kw):
            return prologue.cluster_select_plain(
                apex, planes, aabb_min, aabb_max, valid,
                min(kc, aabb_min.shape[0]), **kw)

        prologue.tile_frusta = prologue.tile_frusta_plain
        prologue.cluster_select = select
        chip_smoke._prologue_case = lambda *a, **k: {}
        if route == "loaded":
            prologue._lib()

    def after(name, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            canary(name)
            return out
        return run

    for name in [k for k in vars(chip_smoke) if k.startswith("phase_")]:
        if name != "phase_stats":
            setattr(chip_smoke, name, after(name, getattr(chip_smoke, name)))

    def stats_probe(card, scene, ivp, ivps, cfg):
        chip_smoke._reset_all()
        tile_trace.render_frames(scene, ivps, cfg)
        torch.cuda.synchronize()
        orbit = _trace(lambda: tile_trace.render_frames(scene, ivps, cfg))
        report("phase 17 orbit", orbit=orbit,
               launches={k: v for k, v in spans.launches().items() if v})
        canary("phase 17 orbit")
        raise _Done

    chip_smoke.phase_stats = stats_probe
    canary("start")
    try:
        chip_smoke.main()
    except _Done:
        pass
    else:
        raise RuntimeError("chip_smoke.main ended before phase 17")
    print(chip_smoke._card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
