"""The frame prologue's camera upload (ops/tile_trace.py::upload).

On the CPU: the helper gives torch.as_tensor(x, dtype=torch.float32)'s
values for every input form, pins nothing and counts no upload; the
prologue builders give what they gave before; the counters carry the
`uploads` kind. Marked `gpu` (skipped without a card): a viewer frame
waits for nothing on the host (sync debug mode "error"), a pipeline of
two frames in flight returns the frames of the same cameras while the
callers overwrite their arrays, an unpinnable camera is a counted sync,
and each builder counts its uploads.

On a machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_upload.py
"""
import numpy as np
import pytest
import torch

from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import tile_trace
from rtmm_tpu_torch.render import pathtrace
from rtmm_tpu_torch.render.renderer import FramePipeline, Renderer
from rtmm_tpu_torch.utils import camera, spans

torch.set_num_threads(1)

W, H = 48, 32
CFG = RenderConfig(width=W, height=H)


def _ivp(yaw=20.0, w=W, h=H):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30), np.radians(yaw), 0.0], 2.5)
    return camera.inv_view_proj(tb, w, h)


def _mesh():
    return procedural.make_icosphere(subdivisions=0, level=2, amplitude=0.2)


@pytest.fixture(scope="module")
def scene():
    return scene_mod.build_device_scene(_mesh(), device="cpu")


@pytest.fixture
def no_pinning(monkeypatch):
    def refuse(self, *args, **kwargs):
        raise AssertionError("pin_memory called for a CPU scene")
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)


INPUTS = {
    "numpy_f64": lambda: np.asarray(_ivp(), dtype=np.float64),
    "numpy_f32": lambda: np.asarray(_ivp(), dtype=np.float32),
    "tensor_f64": lambda: torch.from_numpy(np.asarray(_ivp(),
                                                      dtype=np.float64)),
    "batch": lambda: np.stack([_ivp(y) for y in (10.0, 20.0, 30.0)]),
}


@pytest.mark.parametrize("form", INPUTS)
def test_upload_is_as_tensor_on_cpu(form, no_pinning):
    x = INPUTS[form]()
    before = spans.counters()
    got = tile_trace.upload(x, torch.device("cpu"))
    want = torch.as_tensor(x, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert spans.since(before) == {"launches": {}, "syncs": {},
                                   "uploads": {}}


BUILDERS = {
    "frame_inputs": lambda s, x: tile_trace.frame_inputs(s, x, CFG, 256),
    "frames_inputs": lambda s, x: tile_trace.frames_inputs(s, x[None], CFG,
                                                           256),
    "ray_frame_inputs": lambda s, x: tile_trace.ray_frame_inputs(s, x,
                                                                 CFG)[1:],
    "render_frames": lambda s, x: (tile_trace.render_frames(s, x[None],
                                                            CFG),),
}


def _flat(out):
    return [t for t in out if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("builder", BUILDERS)
def test_builders_keep_their_bits_on_cpu(scene, builder, no_pinning):
    """Each builder gives for a float64 numpy camera exactly what it gives
    for that camera rounded to float32 by torch.as_tensor (what it was
    given before the helper), and counts no upload or sync."""
    ivp = np.asarray(_ivp(), dtype=np.float64)
    build = BUILDERS[builder]
    before = spans.counters()
    got = _flat(build(scene, ivp))
    counted = spans.since(before)
    want = _flat(build(scene, torch.as_tensor(ivp, dtype=torch.float32)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert counted["uploads"] == {} and counted["syncs"] == {}


def test_counters_carry_uploads():
    before = spans.counters()
    assert set(before) == {"launches", "syncs", "uploads"}
    spans.upload("test.site")
    spans.upload("test.site")
    assert spans.since(before)["uploads"] == {"test.site": 2}
    assert spans.uploads()["test.site"] >= 2
    s = spans.summary([], before)
    assert s["uploads"] == {"test.site": 2}


# -- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CPU pins and uploads nothing")
    return torch.device("cuda")


def _card_scene(cuda):
    return scene_mod.build_device_scene(_mesh(), device=cuda)


@pytest.mark.gpu
def test_viewer_frame_waits_for_nothing(cuda):
    """After the warm-up a frame's issue makes no host sync: no
    cudaStreamSynchronize behind the camera's upload, none anywhere in
    render_u8_device or a submit that pops no frame."""
    renderer = Renderer(_card_scene(cuda), CFG)
    renderer.render_u8_device(_ivp(5.0))
    torch.cuda.synchronize()
    pipe = FramePipeline(renderer, depth=2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        renderer.render_u8_device(_ivp(15.0))
        assert pipe.submit(_ivp(25.0)) is None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(list(pipe.drain())) == 1


# The caller's camera: a numpy array (torch.as_tensor shares its memory)
# or a tensor already in pinned memory (pin_memory hands it back as is).
CALLER = {"numpy_f32": lambda m: np.asarray(m, dtype=np.float32),
          "pinned": lambda m: torch.as_tensor(m, dtype=torch.float32)
          .pin_memory()}


@pytest.mark.gpu
@pytest.mark.parametrize("form", CALLER)
def test_pipeline_frames_survive_overwritten_cameras(cuda, form):
    """Two frames in flight behind a ~50 ms spin, each caller array
    overwritten right after its submit: every frame byte-equal to
    render_u8 of its camera, so no staging block was read after the
    caller's array changed or reused before its copy ran."""
    renderer = Renderer(_card_scene(cuda), CFG)
    yaws = [10.0 * k for k in range(8)]
    want = [renderer.render_u8(_ivp(y)) for y in yaws]
    pipe = FramePipeline(renderer, depth=2)
    got = []
    torch.cuda._sleep(100_000_000)
    for y in yaws:
        ivp = CALLER[form](_ivp(y))
        out = pipe.submit(ivp)
        ivp[...] = float("nan")
        if out is not None:
            got.append(out)
    got.extend(pipe.drain())
    assert len(got) == len(yaws)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.gpu
def test_unpinnable_camera_is_a_counted_sync(cuda, monkeypatch):
    """Where no memory can be pinned the camera still arrives, by a
    pageable copy counted as the sync "tile_trace.camera_pageable"."""
    def refuse(self, *args, **kwargs):
        raise RuntimeError("no pinned memory")
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    x = np.asarray(_ivp(), dtype=np.float64)
    before = spans.counters()
    got = tile_trace.upload(x, cuda)
    counted = spans.since(before)
    assert torch.equal(got.cpu(), torch.as_tensor(x, dtype=torch.float32))
    assert counted["syncs"] == {"tile_trace.camera_pageable": 1}
    assert counted["uploads"] == {}


def _viewer(scene, n):
    pipe = FramePipeline(Renderer(scene, CFG), depth=2)
    for k in range(n):
        pipe.submit(_ivp(10.0 * k))
    list(pipe.drain())


def _orbit(scene, n):
    ivps = torch.as_tensor(np.stack([_ivp(10.0 * k) for k in range(n)]),
                           dtype=torch.float32, device=scene.device)
    tile_trace.render_frames(scene, ivps, CFG)


def _path_tracer(scene, n):
    tracer = pathtrace.PathTracer(scene, CFG, pathtrace.PathTraceConfig(
        bounces=2, samples_per_pixel=1))
    for k in range(n):
        tracer.render(_ivp(10.0 * k))


# Per frame: the viewer's and the path tracer's camera is one upload; the
# orbit's cameras arrive on the card and pass through.
RUNS = {"viewer": (_viewer, 1), "orbit": (_orbit, 0),
        "path_tracer": (_path_tracer, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("run", RUNS)
def test_uploads_counted_per_frame(cuda, run):
    scene = _card_scene(cuda)
    go, per_frame = RUNS[run]
    go(scene, 2)
    torch.cuda.synchronize()
    before = spans.counters()
    go(scene, 4)
    torch.cuda.synchronize()
    got = spans.since(before)
    want = {"tile_trace.camera": 4 * per_frame} if per_frame else {}
    assert got["uploads"] == want
    assert "tile_trace.camera_pageable" not in got["syncs"]
