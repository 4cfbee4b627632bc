"""The port's path tracer (render/pathtrace.py) against the JAX package's.

Scene and camera are those of the JAX package's tests/test_pathtrace.py
(a 2x2 level-2 plane, 48x32). The randoms are bit-equal (threefry), so
the engines must render the same image: at most 5 pixels may differ by
more than 1e-4 (a bounce hit that flips at a leaf edge repaints its
pixel), the criterion of the JAX package's own engine comparison, and the
live counts per bounce must be equal. The port's engines run their plain
versions here: `grouped` (kernel-free) and `pallas` (the tile kernel's
raw mode and the grouped trace kernel, as plain PyTorch). The reference
is the JAX `grouped` engine, which the JAX package's own tests hold to
its `pallas` engine. The port's `pallas` engine is also held, end to
end, against one render of JAX's `pallas` engine (the tile kernel's raw
mode and `pallas_grouped` in interpret mode, ~60 s on the CPU: so one
bounce and one sample); the grouped trace kernel's plain version is held
against JAX's `pallas_grouped` kernel itself, launch by launch, in
tests/test_torch_group_trace.py.

Compaction: the lane cuts after each sort must be exact — bit-equal
images and live counts against RTMM_PT_CAP=0 — and the test asserts that
the schedule it runs is non-zero and under the buffer size (a cap at or
over the buffer would cut nothing).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.render import pathtrace as jpt
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import group_trace, tile_trace
from rtmm_tpu_torch.render import pathtrace
from rtmm_tpu_torch.utils import camera

torch.set_num_threads(1)

W, H = 48, 32
CFG = RenderConfig(width=W, height=H)
JCFG = JaxConfig(width=W, height=H, max_candidates=4, ray_chunk=1536)
PLANE = dict(grid=(2, 2), level=2, amplitude=0.2)


def _ivp():
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30), np.radians(20), 0.0], 3.0)
    return camera.inv_view_proj(tb, W, H)


@pytest.fixture(scope="module")
def scenes():
    return (jscene.build_device_scene(jproc.make_plane(**PLANE)),
            scene_mod.build_device_scene(procedural.make_plane(**PLANE),
                                         device="cpu"))


@pytest.fixture(scope="module")
def jax_grouped(scenes):
    """JAX grouped-engine renders: (bounces, spp) -> (image, live)."""
    out = {}
    for bounces, spp in ((2, 2), (3, 1)):
        img, st = jpt.PathTracer(scenes[0], JCFG, jpt.PathTraceConfig(
            bounces=bounces, samples_per_pixel=spp, ray_chunk=1536,
            engine="grouped")).render(_ivp())
        out[bounces, spp] = (np.asarray(img),
                             np.asarray(st["live_rays_per_bounce"]))
    return out


@pytest.fixture(scope="module")
def jax_pallas(scenes):
    """One JAX pallas-engine render at 1 bounce, 1 sample: (image, live,
    extra window passes)."""
    img, st = jpt.PathTracer(scenes[0], JCFG, jpt.PathTraceConfig(
        bounces=1, samples_per_pixel=1, ray_chunk=1536,
        engine="pallas")).render(_ivp())
    return (np.asarray(img), np.asarray(st["live_rays_per_bounce"]),
            np.asarray(st["extra_window_passes_per_bounce"]))


def _port(scene, engine, bounces, spp, **kw):
    img, st = pathtrace.PathTracer(scene, CFG, pathtrace.PathTraceConfig(
        bounces=bounces, samples_per_pixel=spp, engine=engine,
        **kw)).render(_ivp())
    return img.numpy(), st


def _hold(img, live, ref_img, ref_live):
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    npix = int((np.abs(img - ref_img).max(-1) > 1e-4).sum())
    print(f"{npix} pixels over 1e-4; live {live.tolist()} vs "
          f"{ref_live.tolist()}")
    assert npix <= 5, f"{npix} pixels diverge"
    np.testing.assert_array_equal(live.numpy(), ref_live)


@pytest.mark.parametrize("engine", ["grouped", "pallas"])
@pytest.mark.parametrize("bounces,spp", [(2, 2), (3, 1)])
def test_engine_matches_jax_grouped(scenes, jax_grouped, engine, bounces,
                                    spp):
    tile_trace.reset_launches()
    group_trace.reset_launches()
    img, st = _port(scenes[1], engine, bounces, spp)
    _hold(img, st["live_rays_per_bounce"], *jax_grouped[bounces, spp])
    # CPU scenes run the plain versions: no kernel launches.
    assert not any(tile_trace.LAUNCHES.values())
    assert not any(group_trace.LAUNCHES.values())
    live = st["live_rays_per_bounce"]
    assert live[0] > 0 and bool((live[1:] <= live[:-1]).all())


def test_pallas_engine_matches_jax_pallas(scenes, jax_pallas):
    """The port's pallas engine (plain versions of the raw tile trace and
    the grouped trace) against JAX's pallas engine, whose products are
    3-pass bf16: the same pixel and live-count criteria, and the same
    window passes."""
    img, st = _port(scenes[1], "pallas", 1, 1)
    ref_img, ref_live, ref_extra = jax_pallas
    _hold(img, st["live_rays_per_bounce"], ref_img, ref_live)
    np.testing.assert_array_equal(
        st["extra_window_passes_per_bounce"].numpy(), ref_extra)


@pytest.mark.parametrize("env", [
    {"RTMM_PT_CAPS": "1024"}, {"RTMM_PT_CAP": "512"}, {"RTMM_PT_CAP": "64"},
    {"RTMM_PT_CAPS": "1024", "spp": 8}])
@pytest.mark.parametrize("engine", ["grouped", "pallas"])
def test_compaction_is_exact(scenes, monkeypatch, env, engine):
    """spp 4: an 8,192-lane buffer with ~600 live lanes entering bounce 1,
    so every cap below cuts; spp 8 with 1,024-lane caps: the live lanes
    overflow the bounce-1 cap (a full-size bounce) and fit the bounce-2
    cap."""
    env = dict(env)
    spp = env.pop("spp", 4)
    mtotal = spp * 2048
    monkeypatch.setenv("RTMM_PT_CAP", "0")
    a, sa = _port(scenes[1], engine, 2, spp)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "RTMM_PT_CAP" not in env:
        monkeypatch.delenv("RTMM_PT_CAP")
    caps = pathtrace._cap_schedule(mtotal, engine, 2)
    assert all(0 < c < mtotal for c in caps), caps
    b, sb = _port(scenes[1], engine, 2, spp)
    print(f"caps {caps}, live {sb['live_rays_per_bounce'].tolist()}")
    np.testing.assert_array_equal(a, b)
    assert torch.equal(sa["live_rays_per_bounce"], sb["live_rays_per_bounce"])


def test_cap_schedule_matches_jax(monkeypatch):
    for env in ({}, {"RTMM_PT_CAP": "0"}, {"RTMM_PT_CAP": "5000"},
                {"RTMM_PT_CAPS": "3000,1"}):
        for k in ("RTMM_PT_CAP", "RTMM_PT_CAPS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for mtotal, engine, nb in ((524288, "pallas", 3), (8192, "grouped", 2),
                                   (2048, "pallas", 1), (4096, "grouped", 0)):
            assert (pathtrace._cap_schedule(mtotal, engine, nb)
                    == jpt._cap_schedule(mtotal, engine, nb))


@pytest.mark.parametrize("engine", ["grouped", "pallas"])
def test_zero_bounces_and_stat_keys(scenes, engine):
    img, st = _port(scenes[1], engine, 0, 1)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    live = st["live_rays_per_bounce"]
    assert live.shape == (1,) and live[0] > 0
    key = pathtrace._overflow_stat_key(engine)
    assert key == jpt._overflow_stat_key(engine)
    other = ({"extra_window_passes_per_bounce", "overflow_groups_per_bounce"}
             - {key}).pop()
    assert key in st and other not in st
    _, st1 = _port(scenes[1], engine, 1, 1)
    assert st1[key].dtype == torch.int32 and st1[key].shape == (2,)
    assert int(st1[key][0]) == 0


def test_miss_collects_background():
    scene = scene_mod.build_device_scene(
        procedural.make_plane(grid=(1, 1), level=0, amplitude=0.0),
        device="cpu")
    tb = camera.Trackball()
    tb.set_camera([0, 0, -5.0], [0.0, np.pi, 0.0], 1.0)     # looking away
    img, st = pathtrace.PathTracer(scene, CFG, pathtrace.PathTraceConfig(
        bounces=1, samples_per_pixel=1)).render(
            camera.inv_view_proj(tb, W, H))
    np.testing.assert_allclose(
        img.numpy(), np.broadcast_to(np.asarray(CFG.background, np.float32),
                                     (H, W, 3)), atol=1e-6)
    assert int(st["live_rays_per_bounce"][0]) == 0


@pytest.mark.parametrize("engine", ["grouped", "pallas"])
def test_compressed_matches_standard(engine):
    mesh = procedural.make_plane(**PLANE, mixed_levels=True)
    std = scene_mod.build_device_scene(mesh, device="cpu")
    comp = scene_mod.build_device_scene(mesh, compressed=True, device="cpu")
    assert comp.indexed
    pt = pathtrace.PathTraceConfig(bounces=2, samples_per_pixel=1,
                                   engine=engine)
    a, sa = pathtrace.PathTracer(std, CFG, pt).render(_ivp())
    b, sb = pathtrace.PathTracer(comp, CFG, pt).render(_ivp())
    npix = int(((a - b).abs().amax(-1) > 1e-3).sum())
    assert npix <= 5, f"{npix} pixels diverge"


def test_engines_and_defaults(scenes):
    """perray runs and compressed + perray raises, as in the JAX package;
    auto is grouped on a CPU scene; bounce_t_max comes from the cluster
    bounds as in the JAX package."""
    hier = scene_mod.build_device_scene(procedural.make_plane(**PLANE),
                                        hierarchy=True, device="cpu")
    img, st = pathtrace.PathTracer(hier, CFG, pathtrace.PathTraceConfig(
        bounces=1, samples_per_pixel=1, engine="perray")).render(_ivp())
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    assert float(st["live_rays_per_bounce"][0]) > 0
    comp = scene_mod.build_device_scene(procedural.make_plane(**PLANE),
                                        compressed=True, device="cpu")
    with pytest.raises(ValueError, match="compressed scenes"):
        pathtrace.PathTracer(comp, CFG,
                             pathtrace.PathTraceConfig(engine="perray"))
    with pytest.raises(ValueError):
        pathtrace.PathTracer(scenes[1], CFG,
                             pathtrace.PathTraceConfig(engine="xla"))
    assert pathtrace._resolve_engine(scenes[1], "auto") == "grouped"
    port = pathtrace.PathTracer(scenes[1], CFG).pt
    ref = jpt.PathTracer(scenes[0], JCFG).pt
    assert port.bounce_t_max == ref.bounce_t_max
    assert dataclasses.replace(port, bounce_t_max=None) == \
        pathtrace.PathTraceConfig()
