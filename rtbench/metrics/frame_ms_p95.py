"""The 95th percentile of the window's frame latencies, submit of a
frame's camera to its u8 frame on the host (the driver's clock)."""
import numpy as np


def read(run, name):
    lat = getattr(run.driver, "latency_ms", None)
    return float(np.percentile(lat, 95)) if lat else None
