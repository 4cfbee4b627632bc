"""The host's own time in a path-traced frame: the median over the frames
of rtbench/program_spans.py's loop of the frame span's ("rtmm.path_trace")
host duration less the sync spans inside it (the time blocked on the
device there)."""
import statistics

from rtbench import program_spans


def read(run, name):
    got = program_spans.collect(run)
    if not got:
        return None
    blocked: dict = {}
    for r in got["records"]:
        if r.sync:
            blocked[r.frame] = blocked.get(r.frame, 0) + r.ns
    own = [(r.ns - blocked.get(r.frame, 0)) / 1e6 for r in got["records"]
           if r.name == "rtmm.path_trace"]
    return statistics.median(own) if own else None
