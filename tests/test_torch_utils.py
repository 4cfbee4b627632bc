"""Stats, scene cache and debug render of the port (utils/stats.py,
utils/cache.py, utils/debug.py) against the JAX package's.

* FrameStats: the candidate-count fields and traversal_steps_total equal
  JAX's collect_frame_stats on the same scene and camera (the scene and
  camera of the JAX package's tests/test_utils.py); the step heatmap
  equal to JAX's traversal_heatmap, pixel for pixel, and its PNG too.
* Cache: the key function and the .npz format are the JAX package's: the
  same file gives the same key, and a file JAX's save_scene wrote loads
  through the port's load_scene equal to the port's own build.
* Debug: a clean scene renders; a NaN planted in a table the frame reads
  raises FloatingPointError where JAX's checkified render raises too.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.utils import cache as jcache
from rtmm_tpu.utils import stats as jstats
from rtmm_tpu.utils.debug import debug_render as jdebug_render
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.io import image as image_io
from rtmm_tpu_torch.io import loader
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.render.renderer import render_image
from rtmm_tpu_torch.utils import cache, camera, debug, stats

torch.set_num_threads(1)

W, H = 64, 32
PLANE = dict(grid=(2, 2), level=2, amplitude=0.2)


def _ivp():
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30), np.radians(20), 0], 3.0)
    return camera.inv_view_proj(tb, W, H)


@pytest.fixture(scope="module")
def scenes():
    return (jscene.build_device_scene(jproc.make_plane(**PLANE)),
            scene_mod.build_device_scene(procedural.make_plane(**PLANE),
                                         hierarchy=True, device="cpu"))


def test_frame_stats_and_heatmap_match_jax(scenes, tmp_path):
    ref, port = scenes
    jcfg = JaxConfig(width=W, height=H, pipeline="tile")
    cfg = RenderConfig(width=W, height=H, pipeline="tile")
    jhm = jstats.traversal_heatmap(ref, _ivp(), jcfg)
    hm = stats.traversal_heatmap(port, _ivp(), cfg)
    assert hm.shape == (H, W) and hm.dtype == np.int32 and hm.max() > 0
    np.testing.assert_array_equal(hm, jhm)
    jfs = jstats.collect_frame_stats(ref, _ivp(), jcfg, heatmap=jhm)
    fs = stats.collect_frame_stats(port, _ivp(), cfg)
    for key in ("tiles", "candidates_mean", "candidates_p90",
                "candidates_max", "empty_tiles", "traversal_steps_total"):
        assert getattr(fs, key) == getattr(jfs, key), key
    assert fs.traversal_steps_total == int(hm.sum())
    assert abs(fs.hit_fraction - jfs.hit_fraction) <= 5 / (W * H)
    assert fs.frame_ms > 0 and fs.mrays_per_s > 0
    assert set(fs.as_dict()) == set(jfs.as_dict())
    stats.heatmap_to_png(str(tmp_path / "port.png"), hm)
    jstats.heatmap_to_png(str(tmp_path / "jax.png"), jhm)
    back = image_io.read_png(str(tmp_path / "port.png"))
    np.testing.assert_array_equal(
        back, image_io.read_png(str(tmp_path / "jax.png")))
    # Hottest pixel maps to the bright end of the gradient.
    y, x = np.unravel_index(hm.argmax(), hm.shape)
    assert back[y, x].sum() > back[hm == 0].sum(-1).min()


def test_heatmap_chunks_and_stats_on_the_kernel_path(scenes):
    """The heatmap does not depend on the chunk; collect_frame_stats on
    the default pipeline (the tile kernel's plain version here) counts
    the same steps."""
    port = scenes[1]
    cfg = RenderConfig(width=W, height=H, ray_chunk=300)
    hm = stats.traversal_heatmap(port, _ivp(), cfg)
    np.testing.assert_array_equal(hm, stats.traversal_heatmap(
        port, _ivp(), dataclasses.replace(cfg, ray_chunk=1 << 20)))
    fs = stats.collect_frame_stats(port, _ivp(), cfg)
    assert fs.traversal_steps_total == int(hm.sum())
    assert 0.0 < fs.hit_fraction < 1.0 and fs.candidates_max >= 1


def test_profiler_trace_on_the_cpu(scenes, tmp_path):
    """The trace is written; without a card it holds no device event, so
    there is no busy share to read."""
    with stats.profiler_trace(str(tmp_path)):
        stats.traversal_heatmap(scenes[1], _ivp(),
                                RenderConfig(width=W, height=H))
    assert os.path.getsize(tmp_path / "trace.json") > 0
    busy = stats.device_busy(str(tmp_path))
    assert busy["window_us"] > 0 and busy["kernels"] == 0
    assert busy["share"] is None


def _save_asset(tmp_path, name, **kw):
    path = str(tmp_path / f"{name}.gltf")
    loader.save_gltf_bary(procedural.make_plane(**{**PLANE, **kw}), path)
    return path


def _assert_same_scene(s1, s2):
    """Every field equal: tensors bit for bit, meta fields by value."""
    for f in dataclasses.fields(s1):
        a, b = getattr(s1, f.name), getattr(s2, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_scene_cache_roundtrip(tmp_path):
    asset = _save_asset(tmp_path, "a", mixed_levels=True)
    cdir = str(tmp_path / "cache")
    ds1 = cache.build_device_scene_cached(asset, cache_dir=cdir,
                                          device="cpu")
    ds2 = cache.build_device_scene_cached(asset, cache_dir=cdir,
                                          device="cpu")
    assert ds1.max_level == ds2.max_level and ds2.node_verts is not None
    _assert_same_scene(ds1, ds2)
    files = [f for f in os.listdir(cdir) if f.endswith(".npz")]
    assert len(files) == 1     # one cache file, produced and reused
    comp = cache.build_device_scene_cached(asset, cache_dir=cdir,
                                           compressed=True, device="cpu")
    assert comp.compressed and comp.indexed
    again = cache.load_scene(os.path.join(
        cdir, cache.asset_cache_key(asset, False, True, True) + ".npz"),
        device="cpu")
    assert again.indexed and torch.equal(again.unit_grid, comp.unit_grid)


def test_cache_key_changes_and_matches_jax(tmp_path):
    a1 = _save_asset(tmp_path, "a1", level=1)
    a2 = _save_asset(tmp_path, "a2", level=1, amplitude=0.3)
    keys = {cache.asset_cache_key(a1, False), cache.asset_cache_key(a2, False),
            cache.asset_cache_key(a1, True),
            cache.asset_cache_key(a1, False, hierarchy=False),
            cache.asset_cache_key(a1, False, compressed=True)}
    assert len(keys) == 5
    assert cache.FORMAT_VERSION == jcache.FORMAT_VERSION
    for args in ((a1, False), (a2, True), (a1, False, False, True)):
        assert cache.asset_cache_key(*args) == jcache.asset_cache_key(*args)


def test_jax_cache_file_loads_into_the_port(tmp_path):
    asset = _save_asset(tmp_path, "j")
    jdir = str(tmp_path / "jax")
    jcache.build_device_scene_cached(asset, cache_dir=jdir)
    key = cache.asset_cache_key(asset, False)
    assert os.listdir(jdir) == [f"{key}.npz"]
    loaded = cache.load_scene(os.path.join(jdir, f"{key}.npz"),
                              device="cpu")
    own = scene_mod.build_device_scene(loader.load_micromesh(asset),
                                       hierarchy=True, device="cpu")
    _assert_same_scene(own, loaded)
    # The port's cached build finds the JAX package's file under its key.
    hit = cache.build_device_scene_cached(asset, cache_dir=jdir,
                                          device="cpu")
    assert torch.equal(hit.unit_qn, own.unit_qn)
    assert os.listdir(jdir) == [f"{key}.npz"]


def _plant_nan(scene, field):
    t = getattr(scene, field).clone()
    flat = t.reshape(-1)
    flat[int(torch.nonzero(flat)[5])] = float("nan")
    return dataclasses.replace(scene, **{field: t})


def test_debug_render_clean_scene_passes(scenes):
    port = scenes[1]
    for pipeline in ("auto", "ray"):
        img = debug.debug_render(port, _ivp(), RenderConfig(
            width=W, height=H, pipeline=pipeline))
        assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    # The guards change no pixel of a clean frame.
    cfg = RenderConfig(width=W, height=H, pipeline="tile")
    np.testing.assert_array_equal(
        debug.debug_render(port, _ivp(), cfg).numpy(),
        render_image(port, _ivp(), cfg).numpy())


def test_debug_render_raises_where_jax_raises(scenes):
    """unit_qn is read by the tile backend on both sides: JAX's checkify
    and the port's checks both fire."""
    from jax.experimental import checkify

    ref, port = scenes
    jbad = dataclasses.replace(ref, unit_qn=jnp.asarray(
        _plant_nan(port, "unit_qn").unit_qn.numpy()))
    with pytest.raises(checkify.JaxRuntimeError, match="nan"):
        jdebug_render(jbad, _ivp(), JaxConfig(width=W, height=H))
    with pytest.raises(FloatingPointError, match="unit_qn"):
        debug.debug_render(_plant_nan(port, "unit_qn"), _ivp(),
                           RenderConfig(width=W, height=H))


@pytest.mark.parametrize("pipeline,field", [
    ("auto", "leaf_verts"), ("auto", "unit_nrm"), ("ray", "node_verts"),
    ("ray", "leaf_verts")])
def test_debug_render_names_the_bad_table(scenes, pipeline, field):
    with pytest.raises(FloatingPointError, match=field):
        debug.debug_render(_plant_nan(scenes[1], field), _ivp(),
                           RenderConfig(width=W, height=H,
                                        pipeline=pipeline))


def test_debug_checks_stages():
    """A non-finite camera fails at the prologue; an index out of range
    raises IndexError."""
    scene = scene_mod.build_device_scene(procedural.make_plane(**PLANE),
                                         device="cpu")
    bad = _ivp().copy()
    bad[0, 0] = np.nan
    with pytest.raises(FloatingPointError, match="prologue"):
        debug.debug_render(scene, bad, RenderConfig(width=W, height=H))
    debug.check("units", torch.tensor([0, 3]), 4)
    with pytest.raises(IndexError, match="units"):
        debug.check("units", torch.tensor([0, 4]), 4)
    with pytest.raises(IndexError):
        debug.check("units", torch.tensor([-1, 2]), 4)
