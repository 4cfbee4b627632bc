"""The share of the traced slice in which no operation ran on the
device: 1 - busy seconds / slice seconds, from the profiler's events."""


def read(run, name):
    s = run.slice
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 1.0 - s["busy_s"] / s["window_s"]
