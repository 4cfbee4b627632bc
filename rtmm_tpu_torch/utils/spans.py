"""Spans and counters of the port: where the host spends a frame, where it
waits on the device, and which kernels it launches.

A leaf module: it imports no other module of the package, so every module
can import it.

Spans. ``with span(name):`` marks a piece of work. While spans are on
(``with on():``) each span records a Record: its name (every name starts
with "rtmm."), the frame id that every span under one root span shares
(a render, submit or render_frames call), its parent span, its host
start and end in time.time_ns() nanoseconds (torch.profiler stamps its
events on that clock, so program spans lay over a device trace) and, for
a span given a device (stage spans, never a launch), a CUDA event pair
for its device time. Each also opens a profiler range of its name (as
torch.profiler.record_function does), so a profiled or exported trace
carries the program's structure. Records stay in memory until take()
hands them over.

Spans are off by default. Then span() tests one module-global boolean and
returns a shared no-op context: it reads no clock, records no event,
opens no range and allocates nothing. A span given ``timings`` (a dict,
path_trace's timings=) appends its CUDA event pair there whether spans
are on or not.

Counters count always, a dict increment each:

  launches  kernel launches per kernel (launch()); each ops module's
            LAUNCHES is a LaunchView of its own kernels.
  syncs     host syncs per site: sync(site, x, read) is the one place the
            hot paths make the host wait on a device value. While spans
            are on, a sync is a span too, named "rtmm." + site, so the
            time blocked there is known.
  uploads   host-to-device copies from pinned memory that wait for
            nothing, per site (upload()).

The open spans form one stack per process: spans are for one thread.
"""
from __future__ import annotations

import contextlib
import time
from collections.abc import MutableMapping

import torch

# The profiler range a span opens: the C++ RecordFunction without the
# dispatcher's round trip where this PyTorch has it (~1 us a range, against
# ~15 for torch.profiler.record_function).
_Range = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.profiler.record_function)
_on = False
_stack: list["Record"] = []
_records: list["Record"] = []
_ids = 0
_frames = 0
_launches: dict[str, int] = {}
_syncs: dict[str, int] = {}
_uploads: dict[str, int] = {}


class Record:
    """One finished span. start_ns / end_ns on time.time_ns()'s clock;
    parent the id of the enclosing span (None for a root); events the
    (start, end) CUDA event pair or None; sync whether the span is a host
    sync."""

    __slots__ = ("id", "name", "frame", "parent", "start_ns", "end_ns",
                 "events", "sync")

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def device_ms(self) -> float | None:
        """Device milliseconds between the span's events (waits for the
        end event), None without events."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "device", "timings", "key", "is_sync", "rec",
                 "range", "events")

    def __init__(self, name, device, timings, key, is_sync):
        self.name, self.device, self.timings = name, device, timings
        self.key, self.is_sync = key, is_sync
        self.rec = self.range = self.events = None

    def __enter__(self):
        global _ids, _frames
        if self.timings is not None or (
                _on and self.device is not None
                and self.device.type == "cuda"):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events = start
        if not _on:
            return None
        rec = Record()
        _ids += 1
        rec.id, rec.name, rec.sync, rec.events = _ids, self.name, \
            self.is_sync, None
        if _stack:
            rec.parent, rec.frame = _stack[-1].id, _stack[-1].frame
        else:
            _frames += 1
            rec.parent, rec.frame = None, _frames
        _stack.append(rec)
        self.rec = rec
        self.range = _Range(self.name)
        self.range.__enter__()
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            rec.end_ns = time.time_ns()
            self.range.__exit__(None, None, None)
            _stack.pop()
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            pair = (self.events, end)
            if self.timings is not None:
                self.timings.setdefault(self.key, []).append(pair)
            if rec is not None:
                rec.events = pair
        if rec is not None:
            _records.append(rec)
        return False


def span(name: str, device: torch.device | None = None,
         timings: dict | None = None, key: str | None = None):
    """A context marking one piece of work as the span `name` (see the
    module docstring). device: a CUDA device adds a CUDA event pair while
    spans are on; timings: a dict that the span's event pair is appended
    to under `key`, spans on or off."""
    if not _on and timings is None:
        return _NULL
    return _Span(name, device, timings, key, False)


def sync(site: str, x, read=int):
    """read(x), counted as a host sync at `site`; a span "rtmm." + site
    while spans are on."""
    _syncs[site] = _syncs.get(site, 0) + 1
    if not _on:
        return read(x)
    with _Span("rtmm." + site, None, None, None, True):
        return read(x)


def launch(kernel: str) -> None:
    """Count one launch of `kernel`."""
    _launches[kernel] += 1


def upload(site: str) -> None:
    """Count one asynchronous pinned upload at `site`."""
    _uploads[site] = _uploads.get(site, 0) + 1


@contextlib.contextmanager
def on():
    """Spans on for the block (off again after it, or as they were)."""
    global _on
    was = _on
    _on = True
    try:
        yield
    finally:
        _on = was


def take() -> list[Record]:
    """The finished spans' records, oldest first; the buffer is emptied."""
    out = list(_records)
    _records.clear()
    return out


def launches() -> dict[str, int]:
    """Every kernel's launches so far."""
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


def syncs() -> dict[str, int]:
    """Host syncs so far, per site."""
    return dict(_syncs)


def uploads() -> dict[str, int]:
    """Asynchronous pinned uploads so far, per site."""
    return dict(_uploads)


def counters() -> dict:
    """A snapshot of every counter, for since()."""
    return {"launches": launches(), "syncs": syncs(), "uploads": uploads()}


def since(before: dict) -> dict:
    """Each counter's non-zero growth since the snapshot `before`."""
    now = counters()
    return {kind: {k: n - before[kind].get(k, 0)
                   for k, n in now[kind].items()
                   if n != before[kind].get(k, 0)}
            for kind in now}


def self_ns(records: list[Record]) -> dict[int, int]:
    """Per record id, its duration less what its child spans among
    `records` cover."""
    out = {r.id: r.ns for r in records}
    for r in records:
        if r.parent in out:
            out[r.parent] -= r.ns
    return out


def summary(records: list[Record], before: dict | None = None) -> dict:
    """Host self milliseconds per span name, device milliseconds per
    stage span name (the spans with events), and, given a counters()
    snapshot, the syncs and uploads per site and launches per kernel
    since it."""
    own = self_ns(records)
    host: dict[str, float] = {}
    device: dict[str, float] = {}
    for r in records:
        host[r.name] = host.get(r.name, 0.0) + own[r.id] * 1e-6
        ms = r.device_ms()
        if ms is not None:
            device[r.name] = device.get(r.name, 0.0) + ms
    out = {"host_self_ms": host, "device_ms": device}
    if before is not None:
        out.update(since(before))
    return out


class LaunchView(MutableMapping):
    """One module's kernels' launch counters, read and written in the
    registry: the module's LAUNCHES."""

    def __init__(self, kernels):
        self.kernels = tuple(kernels)
        for name in self.kernels:
            _launches.setdefault(name, 0)

    def __getitem__(self, name):
        if name not in self.kernels:
            raise KeyError(name)
        return _launches[name]

    def __setitem__(self, name, value):
        if name not in self.kernels:
            raise KeyError(name)
        _launches[name] = value

    def __delitem__(self, name):
        raise TypeError("a kernel's counter cannot be removed")

    def __iter__(self):
        return iter(self.kernels)

    def __len__(self):
        return len(self.kernels)

    def __repr__(self):
        return repr(dict(self))

    def reset(self) -> None:
        for name in self.kernels:
            _launches[name] = 0
