"""Device-timed milliseconds of the bounce sorts per frame: the sum of the
"sort 1".."sort B" spans of PathTracer.render's timings= over the window,
per frame."""


def read(run, name):
    timings = getattr(run.driver, "timings", None)
    if not timings or not run.frames:
        return None
    return sum(s.elapsed_time(e) for k, spans in timings.items()
               if k.startswith("sort ") for s, e in spans) / run.frames
