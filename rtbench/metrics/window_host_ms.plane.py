"""The host's own time in a frame's cluster-window loop: the median over
the frames of rtbench/program_spans.py's loop of the
"rtmm.tile_trace.trace_windows" span's host duration less the sync spans
nested inside it (the time blocked on the device there, one
"tiled.cluster_window" a window). None where the program has no such
span."""
import statistics

from rtbench import program_spans


def read(run, name):
    got = program_spans.collect(run)
    if not got:
        return None
    return own_ms(got["records"])


def own_ms(records):
    """The median over the loop spans among `records` of their host ms
    less their nested syncs' ms; None without a loop span."""
    by_id = {r.id: r for r in records}
    blocked: dict = {}
    for r in records:
        if not r.sync:
            continue
        up = by_id.get(r.parent)
        while up is not None:
            if up.name == "rtmm.tile_trace.trace_windows":
                blocked[up.id] = blocked.get(up.id, 0) + r.ns
                break
            up = by_id.get(up.parent)
    own = [(r.ns - blocked.get(r.id, 0)) / 1e6 for r in records
           if r.name == "rtmm.tile_trace.trace_windows"]
    return statistics.median(own) if own else None
