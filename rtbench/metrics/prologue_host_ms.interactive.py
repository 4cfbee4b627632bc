"""Host milliseconds of a viewer frame's prologue: the "rtmm.tile_trace.
frames_inputs" span (its tile_frusta and cluster_select launches
included), mean per FramePipeline.submit of rtbench/program_spans.py's
loop."""
from rtbench import program_spans


def read(run, name):
    return program_spans.per_submit_ms(run, "rtmm.tile_trace.frames_inputs")
