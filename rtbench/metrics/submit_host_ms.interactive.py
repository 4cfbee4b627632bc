"""Host milliseconds inside FramePipeline.submit, mean over the window's
frames (the host clock around each call)."""


def read(run, name):
    ms = getattr(run.driver, "submit_ms", None)
    return sum(ms) / len(ms) if ms else None
