"""The 95th percentile over the window's frames of a frame's span, CUDA
events around PathTracer.render and the u8 quantisation."""
import numpy as np


def read(run, name):
    ev = getattr(run.driver, "frame_events", None)
    if not ev:
        return None
    return float(np.percentile([s.elapsed_time(e) for s, e in ev], 95))
