"""Host milliseconds per FramePipeline.submit blocked on the fence of the
frame `depth` back (its "rtmm.submit.fence_wait" sync span), mean over
the submits of rtbench/program_spans.py's loop."""
from rtbench import program_spans


def read(run, name):
    return program_spans.per_submit_ms(run, "rtmm.submit.fence_wait",
                                       inside_submit=True)
