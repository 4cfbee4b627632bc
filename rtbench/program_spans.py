"""The program's own spans and counters in a traced run
(rtmm_tpu_torch/utils/spans.py), read once per run by the metrics that
need them.

After the run's profiler slices, collect() steps the cell's driver for
SECONDS (and at least MIN_STEPS steps) with spans on and no profiler,
then waits for the device, and keeps the records, the frames rendered and
the counters' growth on the run; stderr's "[spans]" lines give the
loop's counters, the wrappers' host us a call and the host self ms and
stage device ms a frame by span. On the card a second loop of the same
length runs under torch.profiler with spans on; its device-idle time,
summed by the innermost program span open at each gap's middle (program
spans and profiler events share time.time_ns()'s clock), and the host's
waits in the CUDA runtime by span follow as "[spans]" lines. A program
without the spans module gives None, so its metrics are left out.
"""
from __future__ import annotations

import heapq
import statistics
import time

from . import harness, trace as trace_mod

SECONDS = 1.5
MIN_STEPS = 10
TOP = 14
# The CUDA runtime's calls that block the host on the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")
# The kernel wrappers' spans: one per launch on the card.
WRAPPERS = ("rtmm.prologue.tile_frusta", "rtmm.prologue.cluster_select",
            "rtmm.tile_trace.trace_fused", "rtmm.tile_trace.trace_raw",
            "rtmm.tile_trace.trace_windowed", "rtmm.group_trace.trace_group",
            "rtmm.path_shade.primary", "rtmm.path_shade.bounce")


def _loop(drv, spans, seconds: float) -> None:
    steps = 0
    t0 = time.perf_counter()
    with spans.on():
        while steps < MIN_STEPS or time.perf_counter() - t0 < seconds:
            drv.step()
            steps += 1
        drv.finish()


def collect(run) -> dict | None:
    """{"records": the spans' records, "frames": frames rendered,
    "counters": the launches and syncs counted in the loop (spans.since)},
    once per run; None where the program has no spans."""
    if hasattr(run, "program_spans"):
        return run.program_spans
    run.program_spans = None
    try:
        from rtmm_tpu_torch.utils import spans
    except ImportError:
        return None
    drv = run.driver
    spans.take()
    a, before = drv.mark(), spans.counters()
    _loop(drv, spans, SECONDS)
    got = run.program_spans = {
        "records": spans.take(), "frames": drv.mark()["frames"] - a["frames"],
        "counters": spans.since(before)}
    harness.log(f"[spans] loop: {got['frames']} frames, syncs "
                f"{got['counters']['syncs']}, launches "
                f"{got['counters']['launches']}")
    calls: dict[str, list[int]] = {}
    for r in got["records"]:
        if r.name in WRAPPERS:
            calls.setdefault(r.name, []).append(r.ns)
    harness.log("[spans] wrapper calls, mean host us: " + ", ".join(
        f"{k} {len(v)} x {sum(v) / len(v) / 1e3:.1f}"
        for k, v in calls.items()))
    if got["frames"]:
        s = spans.summary(got["records"])
        for kind in ("host_self_ms", "device_ms"):
            top = sorted(s[kind].items(), key=lambda kv: -kv[1])[:TOP]
            harness.log(f"[spans] {kind} per frame: " + ", ".join(
                f"{k} {v / got['frames']:.4f}" for k, v in top))
    if run.device.type == "cuda":
        _log_idle(drv, spans)
    return run.program_spans


class _Event:
    """A program span or a profiler event in the form trace.read takes."""

    def __init__(self, name, on_device, start, dur, tid=0):
        self._name, self._dev, self._start, self._dur = (name, on_device,
                                                         start, dur)
        self._tid = tid

    def name(self):
        return self._name

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._tid


def _log_idle(drv, spans) -> None:
    """The second loop under the profiler: its idle gaps by program span,
    and the offset of the program's clock from the profiler's ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _loop(drv, spans, SECONDS)
    records = spans.take()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    # The device-side mirrors of the spans' ranges are no device work.
    merged = [_Event(e.name(), True, e.start_ns(), e.duration_ns())
              for e in events if e.device_type() == cuda
              and not e.name().startswith("rtmm.")]
    merged += [_Event(r.name, False, r.start_ns, r.ns) for r in records]
    got = trace_mod.read(merged)
    ranges: dict[str, list[int]] = {}
    for e in events:
        if e.device_type() != cuda and e.name().startswith("rtmm."):
            ranges.setdefault(e.name(), []).append(e.start_ns())
    starts: dict[str, list[int]] = {}
    for r in records:
        starts.setdefault(r.name, []).append(r.start_ns)
    offsets = [s - p for name, ss in starts.items()
               for s, p in zip(sorted(ss), sorted(ranges.get(name, [])))]
    offset = (f"{statistics.median(offsets) / 1e3:.1f} us over "
              f"{len(offsets)} spans" if offsets else "no range matched")
    harness.log(f"[spans] slice {got['window_s']:.4f} s, device busy "
                f"{got['busy_s']:.4f} s, {len(records)} spans; program "
                f"span start - its profiler range's start: median {offset}")
    for name, idle in got["idle_gaps"]:
        harness.log(f"[spans] idle {idle:.6f} s in {name}")
    # Where the host waits on the device, named or not (a pageable upload
    # waits in cudaStreamSynchronize): the runtime's waits by span.
    waits = sorted((e.start_ns(), e.duration_ns(), e.name()) for e in events
                   if e.device_type() != cuda
                   and e.name() in SYNC_CALLS)
    blocked: dict[tuple, int] = {}
    for (start, dur, call), span in zip(waits, _innermost(
            records, [w[0] for w in waits])):
        blocked[span, call] = blocked.get((span, call), 0) + dur
    for (span, call), ns in sorted(blocked.items(), key=lambda kv: -kv[1]):
        harness.log(f"[spans] host blocked {ns * 1e-9:.6f} s in {call} "
                    f"under {span}")


def _innermost(records, points) -> list[str]:
    """For each time of the sorted `points`, the name of the innermost
    record open at it ("no span" where none is)."""
    order = sorted(records, key=lambda r: r.start_ns)
    open_: list = []
    out, i = [], 0
    for t in points:
        while i < len(order) and order[i].start_ns <= t:
            r = order[i]
            heapq.heappush(open_, (-r.start_ns, r.end_ns, r.name))
            i += 1
        while open_ and open_[0][1] < t:
            heapq.heappop(open_)
        out.append(open_[0][2] if open_ else "no span")
    return out


def records(run, name: str) -> list | None:
    """The collected records named `name`; None without spans."""
    got = collect(run)
    if got is None:
        return None
    return [r for r in got["records"] if r.name == name]


def per_submit_ms(run, name: str, inside_submit: bool = False):
    """Milliseconds of the spans `name` per FramePipeline.submit call
    (only those whose parent is a submit span with inside_submit)."""
    submits = records(run, "rtmm.submit")
    if not submits:
        return None
    ids = {r.id for r in submits}
    spans_ = [r for r in records(run, name)
              if not inside_submit or r.parent in ids]
    return sum(r.ns for r in spans_) / len(submits) / 1e6
