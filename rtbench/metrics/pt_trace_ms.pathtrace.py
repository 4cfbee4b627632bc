"""Device-timed milliseconds of the secondary traces per frame: the sum of
the "trace 1".."trace B" spans of PathTracer.render's timings= (CUDA
events) over the window, per frame."""


def read(run, name):
    timings = getattr(run.driver, "timings", None)
    if not timings or not run.frames:
        return None
    return sum(s.elapsed_time(e) for k, spans in timings.items()
               if k.startswith("trace ") for s, e in spans) / run.frames
