"""Host microseconds per kernel-wrapper call: the mean duration of the
wrapper spans (rtbench/program_spans.py's WRAPPERS, one per launch on the
card) over every call in rtbench/program_spans.py's loop."""
from rtbench import program_spans


def read(run, name):
    got = program_spans.collect(run)
    if not got:
        return None
    ns = [r.ns for r in got["records"] if r.name in program_spans.WRAPPERS]
    return sum(ns) / len(ns) / 1e3 if ns else None
