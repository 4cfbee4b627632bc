"""The port's spans and counters (utils/spans.py) on the CPU: off, they
record nothing and touch no clock, event or profiler range; on, they nest
by frame, lie on the profiler's clock and leave the images as they were;
the sync counter follows the path tracer's code; timings= keeps its
CUDA-event stages; the ops modules' LAUNCHES stay views of the registry."""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import group_trace, path_shade, prologue, tile_trace
from rtmm_tpu_torch.render import pathtrace
from rtmm_tpu_torch.render.renderer import FramePipeline, Renderer
from rtmm_tpu_torch.utils import camera, spans

torch.set_num_threads(1)

W, H = 48, 32
CFG = RenderConfig(width=W, height=H)
BOUNCES, SPP = 3, 2


@pytest.fixture(scope="module")
def scene():
    mesh = procedural.make_icosphere(subdivisions=0, level=2, amplitude=0.2)
    return scene_mod.build_device_scene(mesh, device="cpu")


@pytest.fixture(scope="module")
def plane():
    """A plane of two clusters or more: windows of one cluster walk it in
    several passes."""
    mesh = procedural.make_plane(grid=(12, 12), level=2, amplitude=0.2)
    return scene_mod.build_device_scene(mesh, device="cpu")


def _ivp(yaw=20.0):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30), np.radians(yaw), 0.0], 2.5)
    return camera.inv_view_proj(tb, W, H)


def _tracer(scene, cfg=CFG):
    return pathtrace.PathTracer(scene, cfg, pathtrace.PathTraceConfig(
        bounces=BOUNCES, samples_per_pixel=SPP, engine="pallas"))


def _path_trace(scene):
    return [_tracer(scene).render(_ivp())[0]]


def _pipeline(scene):
    pipe = FramePipeline(Renderer(scene, CFG))
    frames = [pipe.submit(_ivp(yaw)) for yaw in (10.0, 20.0, 30.0)]
    return [torch.from_numpy(f) for f in frames + list(pipe.drain())
            if f is not None]


RUNS = {"path_trace": _path_trace, "pipeline": _pipeline}


def _rtmm_ranges(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("rtmm.")]


class _Refuse:
    def __getattr__(self, name):
        raise AssertionError(f"spans off read time.{name}")


def _refuse(*args, **kwargs):
    raise AssertionError("spans off made a CUDA event or a profiler range")


@pytest.mark.parametrize("run", RUNS)
def test_off_records_nothing_and_on_changes_no_pixel(scene, run,
                                                     monkeypatch):
    spans.take()
    with monkeypatch.context() as m:
        m.setattr(spans, "time", _Refuse())
        m.setattr(torch.cuda, "Event", _refuse)
        m.setattr(spans, "_Range", _refuse)
        assert spans.span("rtmm.a") is spans.span("rtmm.b")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            off = RUNS[run](scene)
    assert spans.take() == [] and _rtmm_ranges(prof) == []
    with spans.on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        on = RUNS[run](scene)
    assert not spans._on
    recs = spans.take()
    assert recs and len(_rtmm_ranges(prof)) == len(recs)
    assert all(r.name.startswith("rtmm.") for r in recs)
    assert len(on) == len(off) and all(torch.equal(a, b)
                                       for a, b in zip(off, on))


@pytest.mark.parametrize("run", RUNS)
def test_spans_nest_by_frame(scene, run):
    spans.take()
    with spans.on():
        RUNS[run](scene)
        RUNS[run](scene)
    recs = spans.take()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    root = {"path_trace": "rtmm.path_trace", "pipeline": "rtmm.submit"}[run]
    assert {r.name for r in roots} <= {root, "rtmm.submit.fence_wait"}
    assert len({r.frame for r in roots}) == len(roots)
    assert len([r for r in roots if r.name == root]) == (
        2 if run == "path_trace" else 6)
    for r in recs:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.frame == r.frame
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    own = spans.self_ns(recs)
    for r in recs:
        kids = sum(k.ns for k in recs if k.parent == r.id)
        assert own[r.id] == r.ns - kids and own[r.id] >= 0
    if run == "pipeline":
        issue = {r.parent for r in recs if r.name == "rtmm.submit.issue"}
        assert issue == {r.id for r in roots if r.name == root}


def test_spans_share_the_profilers_clock(scene):
    spans.take()
    with spans.on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _path_trace(scene)
    recs = spans.take()
    ranges: dict = {}
    for e in _rtmm_ranges(prof):
        ranges.setdefault(e.name(), []).append(e.start_ns())
    gaps = []
    for name in {r.name for r in recs}:
        mine = sorted(r.start_ns for r in recs if r.name == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs)
        gaps += [a - b for a, b in zip(mine, theirs)]
    assert len(gaps) == len(recs)
    assert abs(float(np.median(gaps))) < 0.2e6


def _derived_syncs(recs, live, mtotal, windowed):
    """The syncs the path tracer's code makes for a frame: in a windowed
    primary trace one test of the window loop per window plus the last; a
    lane-cap read where a cap lies under the state's size (the state then
    shrinks to it when the live lanes fit); and per bounce one test of
    the window loop per window plus the last, and one count of the
    windows left."""
    stage = {r.id: r for r in recs if r.name == "rtmm.pathtrace.trace"}
    windows = [sum(1 for r in recs if r.name == "rtmm.group_trace.trace_group"
                   and r.parent == s.id) for s in
               sorted(stage.values(), key=lambda s: s.start_ns)]
    caps = pathtrace._cap_schedule(mtotal, "pallas", BOUNCES)
    size, reads = mtotal, 0
    for b, cap in enumerate(caps):
        if 0 < cap < size:
            reads += 1
            if round(float(live[b]) * SPP) <= cap:
                size = cap
    primary = sum(r.name == "rtmm.tile_trace.trace_windowed" for r in recs)
    want = {"tiled.cluster_window": primary + 1 if windowed else 0,
            "pathtrace.lane_cap": reads,
            "group_trace.window_any": sum(windows) + BOUNCES,
            "group_trace.window_extra": sum(windows)}
    return {k: n for k, n in want.items() if n}, windows


@pytest.mark.parametrize("name, kc", [("scene", 256), ("plane", 1)])
def test_sync_counter_follows_the_code(request, name, kc):
    scene = request.getfixturevalue(name)
    cfg = RenderConfig(width=W, height=H, kernel_clusters_per_window=kc)
    tracer = _tracer(scene, cfg)
    spans.take()
    before = spans.counters()
    with spans.on():
        _, stats = tracer.render(_ivp())
    got = spans.since(before)["syncs"]
    recs = spans.take()
    total = W * H + (-(W * H)) % pathtrace.GROUP
    want, windows = _derived_syncs(recs, stats["live_rays_per_bounce"],
                                   SPP * total, scene.num_clusters > kc)
    assert got == want
    assert sum(r.sync for r in recs) == sum(got.values())
    assert windows[0] >= (2 if name == "plane" else 1)


class _FakeEvent:
    def __init__(self, enable_timing=False):
        self.recorded = False

    def record(self, stream=None):
        self.recorded = True


@pytest.mark.parametrize("on", [False, True])
def test_timings_keep_their_stages(scene, on, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    timings = {}
    spans.take()
    with spans.on() if on else contextlib.nullcontext():
        _tracer(scene).render(_ivp(), timings=timings)
    want = {"primary": 1, "shade+spawn": BOUNCES + 1}
    want.update({f"{k} {b}": 1 for k in ("sort", "trace")
                 for b in range(1, BOUNCES + 1)})
    assert {k: len(v) for k, v in timings.items()} == want
    assert all(s.recorded and e.recorded for v in timings.values()
               for s, e in v)
    recs = spans.take()
    staged = [r for r in recs if r.events is not None]
    assert len(staged) == (sum(want.values()) if on else 0)
    assert {r.name for r in staged} <= {
        "rtmm.pathtrace.primary", "rtmm.pathtrace.sort",
        "rtmm.pathtrace.trace", "rtmm.pathtrace.shade+spawn"}


@pytest.mark.parametrize("mod", [tile_trace, group_trace, path_shade,
                                 prologue],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_launch_views_read_and_zero_the_registry(mod):
    spans.reset_launches()
    first, *rest = mod.KERNELS
    spans.launch(first)
    spans.launch(first)
    assert mod.LAUNCHES[first] == 2 and spans.launches()[first] == 2
    assert mod.LAUNCHES == {first: 2, **dict.fromkeys(rest, 0)}
    assert sum(mod.LAUNCHES.values()) == 2 and list(mod.LAUNCHES) == list(
        mod.KERNELS)
    other = next(k for k in spans.launches() if k not in mod.KERNELS)
    spans.launch(other)
    mod.reset_launches()
    assert not any(mod.LAUNCHES.values())
    assert spans.launches()[other] == 1
    mod.LAUNCHES[first] = 5
    assert spans.launches()[first] == 5
    with pytest.raises(KeyError):
        mod.LAUNCHES[other]
    spans.reset_launches()
    assert not any(spans.launches().values())
