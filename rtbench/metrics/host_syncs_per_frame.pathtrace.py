"""Host syncs per frame: the growth of the program's sync counter (every
site of utils/spans.sync: the lane-cap reads, each bounce's window loop)
over the frames of rtbench/program_spans.py's loop."""
from rtbench import program_spans


def read(run, name):
    got = program_spans.collect(run)
    if not got or not got["frames"]:
        return None
    return sum(got["counters"]["syncs"].values()) / got["frames"]
