"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the check against the reference.

run_cell is the whole run but its printing; rtbench/run.py is the
command. Set-up builds the kernels, the scene from the seed and the
cell's driver, and warms up the cell's own shapes. The window steps the
driver until `seconds` have passed, then waits for the device; nothing
builds or compiles inside it. A traced run then profiles a slice of the
same loop (and a second, labelled one for the idle gaps' names) and
reads the per-layer metrics. Last, the program's state is
freed and the reference judges the pixels the window produced.
"""
from __future__ import annotations

import time

import torch

from . import check, harness, scene as scene_mod, trace as trace_mod

PROFILE_SECONDS = 1.5


def _launches() -> dict:
    from rtmm_tpu_torch.ops import group_trace, path_shade, prologue, \
        tile_trace
    out = {}
    for mod in (tile_trace, group_trace, path_shade, prologue):
        out.update(mod.LAUNCHES)
    return dict(out)


class Run:
    """What a run measured, for the metric readers."""

    def __init__(self, device, driver, scene):
        self.device = torch.device(device)
        self.driver, self.scene = driver, scene
        self.window_s = self.setup_s = 0.0
        self.frames = self.rays = 0
        self.peak_bytes = 0
        self.launches: dict = {}
        self.slice: dict | None = None


def window(drv, seconds: float) -> tuple[float, dict, dict]:
    """Step the driver for `seconds` (at least once) and wait for the
    device. Returns (seconds taken, mark before, mark after)."""
    before = drv.mark()
    drv.in_window = True
    t0 = time.perf_counter()
    while True:
        drv.step()
        if time.perf_counter() - t0 >= seconds:
            break
    drv.finish()
    taken = time.perf_counter() - t0
    drv.in_window = False
    return taken, before, drv.mark()


def run_cell(cell, seed: int, seconds: float, traced: bool,
             device="cuda", mark=None) -> dict:
    """The result of one run (the contract's keys and "check"), with the
    Run, the drawn pixels, the reference's and its subsets under "_run",
    "_drawn", "_want" and "_subsets". `mark`: the SetupMarks that the
    set-up's phases are noted in (a new one by default)."""
    mark = mark or harness.SetupMarks()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.empty(1, device=dev)
        mark("context")
        from rtmm_tpu_torch.ops import _build
        _build.build_all()
        mark("kernels")
    scene = scene_mod.device_scene(cell, seed, device)
    mark("scene")
    drv = cell.driver()(cell, seed, scene, device)
    run = Run(device, drv, scene)
    drv.warm_up()
    drv.finish()
    mark("warm-up")
    if traced and hasattr(drv, "instrument"):
        drv.instrument()
    start = _launches()
    run.setup_s = harness.seconds_since_process_start()
    mark.log()
    run.window_s, a, b = window(drv, seconds)
    run.launches = {k: v - start[k] for k, v in _launches().items()
                    if v != start[k]}
    run.frames = b["frames"] - a["frames"]
    run.rays = drv.rays(a, b)
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    if traced and on_card:
        run.slice = trace_mod.profile(drv.step, PROFILE_SECONDS, drv.finish)
        run.slice["idle_gaps"] = trace_mod.profile(
            drv.step, PROFILE_SECONDS, drv.finish, labels=True)["idle_gaps"]
        harness.log(f"[trace] slice {run.slice['window_s']:.4f} s, device "
                    f"busy {run.slice['busy_s']:.4f} s, "
                    f"{run.slice['kernels']} kernel events against "
                    f"{run.slice['launch_calls']} kernel launch calls")
    metrics = {}
    for m in cell.metrics(traced):
        value = cell.reader(m["name"]).read(run, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # The program's state goes before the reference runs.
    drawn = drv.samples.draw(seed, int(cell.traffic["check_pixels"]),
                             drv.width)
    drv.release()
    run.scene = None
    del scene
    if on_card:
        torch.cuda.empty_cache()
    arrays = scene_mod.reference_arrays(cell)
    correct, table, want, subsets = check.judge(drv, drawn, arrays,
                                                 device, cell.limits)
    for name, mask in subsets.items():
        harness.log(f"[subset] {name}: {int(mask.sum())} of "
                    f"{int(mask.shape[0])} sampled pixels")
    result = {
        "correct": bool(correct),
        "attempted": run.frames,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(run.peak_bytes)},
    }
    if run.slice is not None:
        result["device"].update(busy_s=run.slice["busy_s"],
                                window_s=run.slice["window_s"])
        result["breakdown"] = {"device_ops": run.slice["device_ops"],
                               "idle_gaps": run.slice["idle_gaps"]}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in table.items()}
    result["_run"], result["_drawn"] = run, drawn
    result["_want"], result["_subsets"] = want, subsets
    return result

