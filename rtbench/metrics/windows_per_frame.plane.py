"""Cluster windows a frame: the window's tile_trace_windowed_compressed
launches (the ops modules' LAUNCHES counters) per frame rendered; None
where the window launched none."""


def read(run, name):
    n = run.launches.get("tile_trace_windowed_compressed", 0)
    return n / run.frames if n and run.frames else None
