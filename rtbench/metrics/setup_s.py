"""Seconds from the start of the process to the first timed frame:
imports, the kernels' build, the scene from the seed, the warm-up."""


def read(run, name):
    return run.setup_s
