"""Host milliseconds per FramePipeline.submit spent issuing the frame (its
"rtmm.submit.issue" span: render, quantise, pinned copy, event record),
mean over the submits of rtbench/program_spans.py's loop."""
from rtbench import program_spans


def read(run, name):
    return program_spans.per_submit_ms(run, "rtmm.submit.issue")
