"""K2's share of its roofline on the bounce-1 launch of one frame of the
cell's traffic: the frame rendered again with group_trace.trace_group
recorded, the first launch of bounce 1 launched again 20 times queued
behind a spin per round, timed with CUDA events; the least time from its
own tested (lane, unit) pairs (fp32 operations over 67 TFLOP/s) or its
bytes (over 3.35 TB/s), the larger. None off the card or where the
frame made no K2 launch."""
from rtbench import harness, roofline


def read(run, name):
    if run.device.type != "cuda" or run.driver.tracer is None:
        return None
    from rtmm_tpu_torch.ops import group_trace
    drv = run.driver
    orig_group, orig_sorted = group_trace.trace_group, group_trace.trace_sorted
    bounce, launches = [0], []

    def trace_sorted(*args, **kwargs):
        bounce[0] += 1
        return orig_sorted(*args, **kwargs)

    def trace_group(*args, **kwargs):
        launches.append((bounce[0], args, kwargs))
        return orig_group(*args, **kwargs)

    group_trace.trace_group, group_trace.trace_sorted = (trace_group,
                                                         trace_sorted)
    try:
        drv.tracer.render(drv.camera(drv.rendered))
    finally:
        group_trace.trace_group, group_trace.trace_sorted = (orig_group,
                                                             orig_sorted)
    first = [(a, k) for b, a, k in launches if b == 1]
    if not first:
        return None
    args, kwargs = first[0]

    def launch():
        return orig_group(*args, **kwargs)

    out = launch()
    visits, tests = int(out[2].sum()), int(out[4].sum())
    moved = roofline.nbytes(*args, *kwargs.values(), *out)
    bound, by = roofline.k2_bound(tests, visits, moved,
                                  derive=bool(kwargs.get("compressed")))
    del out
    ms = roofline.queued_ms(launch, reps=20, rounds=3)
    harness.log(f"[{name}] {roofline.card_line()}: {visits} visits, {tests} "
                f"tests, {moved / 1e6:.2f} MB; bound {bound:.4f} ms ({by}); "
                f"K2 {ms:.4f} ms queued")
    return 100.0 * bound / ms
