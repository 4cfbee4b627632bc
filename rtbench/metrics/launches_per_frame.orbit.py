"""Kernel launches of the window (the ops modules' LAUNCHES counters)
per frame rendered."""


def read(run, name):
    return sum(run.launches.values()) / run.frames if run.frames else None
