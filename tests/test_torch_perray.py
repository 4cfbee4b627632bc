"""The path tracer's per-ray engine ("perray", render/pathtrace.py) against
the JAX package's, and against the port's grouped engine.

Scene and camera are those of the JAX package's tests/test_pathtrace.py (a
2x2 level-2 plane at 48x32, 4 candidates per ray, 1,536-ray chunks). The
randoms are threefry bit for bit, so the criteria are the JAX package's
engine comparison (tests/test_pathtrace.py:129-145): at most 5 pixels
over 1e-4 and live counts per bounce within 4. Against JAX's own perray
both are held tighter: live counts equal.

Perray sorts the live lanes to the front before each bounce and traces
only that prefix. Tracing every lane instead must give the same frame and
stats bit for bit, and the same t, normals and hits on the live lanes.
"""
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.render import pathtrace as jpt
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.render import pathtrace
from rtmm_tpu_torch.utils import camera

torch.set_num_threads(1)

W, H = 48, 32
CFG = RenderConfig(width=W, height=H, max_candidates=4)
JCFG = JaxConfig(width=W, height=H, max_candidates=4, ray_chunk=1536)
PLANE = dict(grid=(2, 2), level=2, amplitude=0.2)


def _ivp():
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30), np.radians(20), 0.0], 3.0)
    return camera.inv_view_proj(tb, W, H)


@pytest.fixture(scope="module")
def scene():
    return scene_mod.build_device_scene(procedural.make_plane(**PLANE),
                                        hierarchy=True, device="cpu")


def _perray(scene, bounces, spp, **kw):
    img, st = pathtrace.PathTracer(scene, CFG, pathtrace.PathTraceConfig(
        bounces=bounces, samples_per_pixel=spp, ray_chunk=1536,
        engine="perray", **kw)).render(_ivp())
    return img.numpy(), st


def _npix(a, b):
    return int((np.abs(a - b).max(-1) > 1e-4).sum())


def test_perray_matches_jax_perray(scene):
    jscn = jscene.build_device_scene(jproc.make_plane(**PLANE))
    ref, rst = jpt.PathTracer(jscn, JCFG, jpt.PathTraceConfig(
        bounces=2, samples_per_pixel=2, ray_chunk=1536,
        engine="perray")).render(_ivp())
    img, st = _perray(scene, 2, 2)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    npix = _npix(img, np.asarray(ref))
    print(f"{npix} pixels over 1e-4; live "
          f"{st['live_rays_per_bounce'].tolist()}")
    assert npix <= 5, f"{npix} pixels diverge"
    np.testing.assert_array_equal(st["live_rays_per_bounce"].numpy(),
                                  np.asarray(rst["live_rays_per_bounce"]))
    np.testing.assert_array_equal(
        st["overflow_groups_per_bounce"].numpy(),
        np.asarray(rst["overflow_groups_per_bounce"]))


@pytest.mark.parametrize("bounces,spp", [(2, 2), (3, 1)])
def test_perray_matches_grouped_engine(scene, bounces, spp):
    a, sa = _perray(scene, bounces, spp)
    b, sb = pathtrace.PathTracer(scene, CFG, pathtrace.PathTraceConfig(
        bounces=bounces, samples_per_pixel=spp,
        engine="grouped")).render(_ivp())
    npix = _npix(a, b.numpy())
    assert npix <= 5, f"{npix} pixels diverge between engines"
    dlive = (sa["live_rays_per_bounce"] - sb["live_rays_per_bounce"]).abs()
    assert float(dlive.max()) <= 4
    # Exact and uncapped: nothing overflows, at any bounce.
    ovf = sa["overflow_groups_per_bounce"]
    assert ovf.dtype == torch.int32 and ovf.shape == (bounces + 1,)
    assert not bool(ovf.any())


def _trace_every_lane(scene, o, d, alive, cfg, pt):
    bt, bn3, hit = pathtrace._trace_chunked(scene, o, d, cfg, pt.ray_chunk)
    return bt, bn3, hit & alive


@pytest.mark.parametrize("bounces,spp", [(2, 4), (3, 2)])
def test_live_prefix_equals_every_lane(scene, monkeypatch, bounces, spp):
    a, sa = _perray(scene, bounces, spp)
    monkeypatch.setattr(pathtrace, "_trace_perray", _trace_every_lane)
    b, sb = _perray(scene, bounces, spp)
    np.testing.assert_array_equal(a, b)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    live = sa["live_rays_per_bounce"]
    # Most lanes are dead at every bounce, so the prefix is short.
    assert 0 < float(live[1]) < W * H / 4
    assert pathtrace._cap_schedule(spp * W * H, "perray", bounces) == \
        [0] * bounces


@pytest.mark.parametrize("live_share", [0.0, 0.3, 1.0])
def test_trace_perray_live_prefix(scene, live_share):
    """One bounce's trace after the live-first sort: the prefix trace
    equals the every-lane trace on the live lanes, and no dead lane
    hits. The lanes are the camera rays, live in a random pattern."""
    from rtmm_tpu_torch.ops import raygen
    o, d = raygen.generate_rays(_ivp(), W, H, device="cpu")
    rng = np.random.default_rng(7)
    alive = torch.from_numpy(rng.random(W * H) < live_share)
    rad = torch.zeros((W * H, 3))
    idx = torch.arange(W * H, dtype=torch.int32)
    o, d, alive, _rad, idx = pathtrace._sort_state(scene, o, d, alive, rad,
                                                   idx, "perray")
    n_live = int(alive.sum())
    assert bool(alive[:n_live].all()) and not bool(alive[n_live:].any())
    # Stable: each part keeps the lanes' original order.
    assert bool((idx[:n_live].diff() > 0).all())
    assert bool((idx[n_live:].diff() > 0).all())
    pt = pathtrace.PathTraceConfig(ray_chunk=256, engine="perray")
    t, n, hit = pathtrace._trace_perray(scene, o, d, alive, CFG, pt)
    t_all, n_all, hit_all = _trace_every_lane(scene, o, d, alive, CFG, pt)
    assert torch.equal(hit, hit_all)
    assert not bool(hit[n_live:].any())
    assert torch.equal(t[:n_live], t_all[:n_live])
    assert torch.equal(n[:n_live], n_all[:n_live])
    if live_share:
        assert int(hit.sum()) > 0


def test_perray_zero_bounces(scene):
    img, st = _perray(scene, 0, 1)
    assert img.shape == (H, W, 3)
    assert st["live_rays_per_bounce"].shape == (1,)
    assert "overflow_groups_per_bounce" in st
