"""The device's side of a traced run: a torch.profiler slice of the cell's
own loop, read in memory (nothing is written to disk).

From the slice: busy seconds (the union of the device's kernel, copy and
fill intervals), the slice's length, the kernel events against the
kernel launch calls the host made (a trace that lost kernel events shows
fewer of the first), the device operations that took most time, and the
idle gaps between device work summed by the innermost host range open at
the gap's middle. In a labelled slice the renderer's entry points and
stages (LABELLED) run inside profiler ranges named after them, so a gap
spent in their Python between two operations is named by the function.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import heapq
import time
from collections import defaultdict

import torch

TOP = 10
STEP = "rtbench.step"
# module -> functions (or "Class.method") run inside a profiler range of
# their own name during the slice.
LABELLED = {
    "rtmm_tpu_torch.ops.tile_trace": (
        "render_frames", "render_frame", "frames_inputs", "frame_inputs",
        "ray_frame_inputs", "cluster_lists", "trace_fused", "trace_raw",
        "trace_windowed"),
    "rtmm_tpu_torch.ops.prologue": ("tile_frusta", "cluster_select"),
    "rtmm_tpu_torch.ops.group_trace": ("trace_sorted", "trace_group",
                                       "group_inputs"),
    "rtmm_tpu_torch.ops.path_shade": ("primary", "bounce"),
    "rtmm_tpu_torch.render.pathtrace": ("path_trace", "_trace_primary",
                                        "_sort_state"),
    "rtmm_tpu_torch.render.renderer": ("render_image",
                                       "FramePipeline.submit",
                                       "FramePipeline._pop"),
}


@contextlib.contextmanager
def labelled():
    """LABELLED's functions wrapped in profiler ranges; restored after."""
    import importlib
    from torch.profiler import record_function
    saved = []

    def wrap(fn, name):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return inner

    for modname, names in LABELLED.items():
        mod = importlib.import_module(modname)
        for name in names:
            owner, attr = mod, name
            if "." in name:
                cls, attr = name.split(".")
                owner = getattr(mod, cls)
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrap(fn, f"{modname.rsplit('.', 1)[1]}."
                                          f"{name}"))
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def profile(step, seconds: float, finish, labels: bool = False) -> dict:
    """Run step() under the profiler for at least `seconds`, then
    finish(); returns the slice's reading (see module docstring). With
    labels, LABELLED's functions open ranges: their cost shows in the
    busy share, so a run reads busy seconds from a slice without them and
    the idle gaps' names from one with them."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with (labelled() if labels else contextlib.nullcontext()), \
            tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with torch.profiler.record_function(STEP):
                step()
        finish()
    return read(prof.profiler.kineto_results.events())


def label_names() -> set[str]:
    """The names of the ranges the slice opens (STEP and LABELLED's)."""
    return {STEP} | {f"{m.rsplit('.', 1)[1]}.{n}"
                     for m, names in LABELLED.items() for n in names}


def read(events) -> dict:
    """The slice's reading from kineto events (name, device_type,
    start_ns, duration_ns, start_thread_id); the ranges the slice opened
    count on the host only."""
    device, host, launches = [], [], []
    labels = label_names()
    for e in events:
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # A range the slice opened is mirrored on the device's
            # timeline; it is no work of the device.
            if name not in labels:
                device.append((start, start + dur, name))
        else:
            host.append((start, start + dur, name))
            if "LaunchKernel" in name:
                # cudaLaunchKernel* is the runtime's, cuLaunchKernel* the
                # driver's.
                launches.append((start, start + dur, name.startswith("cuda"),
                                 e.start_thread_id()))
    if not device and not host:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": 0,
                "launch_calls": 0, "device_ops": [], "idle_gaps": []}
    lo = min(s for s, *_ in device + host)
    hi = max(e for _, e, *_ in device + host)
    spans = sorted((s, e) for s, e, *_ in device)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    by_name = defaultdict(int)
    for s, e, name in device:
        by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # A driver launch inside a runtime launch on the same thread is one.
    runtime = defaultdict(list)
    for s, e, is_runtime, tid in sorted(launches):
        if is_runtime:
            runtime[tid].append((s, e))
    calls = 0
    for s, e, is_runtime, tid in launches:
        if is_runtime:
            calls += 1
            continue
        spans_t = runtime.get(tid, [])
        k = bisect.bisect_right(spans_t, (s, float("inf"))) - 1
        calls += not (k >= 0 and spans_t[k][1] >= s)
    kernels = sum(1 for *_, name in device
                  if not name.startswith(("Memcpy", "Memset")))
    # Sweep the gaps' middles in order; the open range that started last
    # is the innermost of nested ranges.
    gaps = defaultdict(int)
    host_sorted = sorted(host)
    open_ranges: list = []
    i = 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) // 2
        while i < len(host_sorted) and host_sorted[i][0] <= mid:
            s, e, name = host_sorted[i]
            heapq.heappush(open_ranges, (-s, e, name))
            i += 1
        while open_ranges and open_ranges[0][1] < mid:
            heapq.heappop(open_ranges)
        label = open_ranges[0][2] if open_ranges else "no host range"
        gaps[label] += s1 - e0
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9,
            "kernels": kernels, "launch_calls": calls,
            "device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in idle]}
