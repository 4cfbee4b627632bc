"""Rays traced in the window over the window's seconds, in millions: an
orbit or a viewer frame counts W x H, a path-traced frame its primaries
plus each bounce's live rays (the driver's count)."""


def read(run, name):
    return run.rays / run.window_s / 1e6
