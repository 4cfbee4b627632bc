"""The slice as a whole: the port's frame against the JAX Pallas kernel.

The JAX scene goes into the port through scene_from_arrays, so both
trace the very same tables. The JAX reference is render_pallas in
interpret mode at mt_precision="highest" (float32 products), rendered
once per scene for the module; the port runs its plain PyTorch walk (the
CPU path of trace_fused).

Per-tile visit and eligible counts must be equal. Images pass the
two-tier gate of bench.py (budgets max(64, W*H/2000) pixels over 4/255,
max(16, W*H/50000) over 0.25); away from exact t-ties they differ only in
the last bits, because XLA's CPU compiler fuses multiply-adds that the
port rounds separately.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops.pallas_tiled import render_pallas
from rtmm_tpu.utils import cache as jcache
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import tile_trace
from rtmm_tpu_torch.render.renderer import FramePipeline, Renderer
from rtmm_tpu_torch.utils import camera
from rtmm_tpu_torch.utils.gate import image_gate

# One intra-op thread: the suite runs several pytest workers on one shared
# CPU, and with JAX in the same process the first multi-threaded PyTorch
# op after a JAX computation was seen to compute part of its range wrong
# (about one process in twenty; never single-threaded).
torch.set_num_threads(1)

# name -> (icosphere subdivisions, level, width, height)
SCENES = {
    "icosphere0_level2": (0, 2, 128, 64),
    "icosphere1_level3": (1, 3, 256, 64),     # 2 clusters: the cluster walk
}


def _ivp(w, h, pitch=-30.0, yaw=25.0, dist=3.0):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(pitch), np.radians(yaw), 0.0], dist)
    return camera.inv_view_proj(tb, w, h)


def _arrays(ds):
    """The keys rtmm_tpu.utils.cache.save_scene writes."""
    out = {f.name: np.asarray(getattr(ds, f.name))
           for f in dataclasses.fields(ds)
           if f.name not in jcache._META_FIELDS
           and getattr(ds, f.name) is not None}
    out.update(jcache._meta_arrays(ds))
    return out


def _render_reference(sub, level, w, h, kc=256):
    """(port scene, JAX image, JAX visits, JAX eligible)."""
    ds = jscene.build_device_scene(
        jproc.make_icosphere(subdivisions=sub, level=level, amplitude=0.1),
        hierarchy=False)
    cfg = dataclasses.replace(JaxConfig(width=w, height=h),
                              mt_precision="highest",
                              kernel_clusters_per_window=kc)
    img, st = render_pallas(ds, jnp.asarray(_ivp(w, h)), cfg,
                            interpret=True, with_stats=True)
    return (scene_mod.scene_from_arrays(_arrays(ds), device="cpu"),
            np.array(img), np.asarray(st["kernel_unit_visits"]),
            np.asarray(st["kernel_unit_eligible"]))


@pytest.fixture(scope="module")
def reference():
    """name -> (port scene, JAX image, JAX visits, JAX eligible)."""
    return {name: _render_reference(*args) for name, args in SCENES.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frame_matches_pallas_kernel(reference, name):
    scene, img0, vis0, elig0 = reference[name]
    _, _, w, h = SCENES[name]
    img, st = tile_trace.render_frame(scene, _ivp(w, h),
                                      RenderConfig(width=w, height=h),
                                      with_stats=True)
    vis = st["kernel_unit_visits"].numpy()
    print(f"{name}: visits {vis.tolist()}")
    np.testing.assert_array_equal(vis, vis0)
    np.testing.assert_array_equal(st["kernel_unit_eligible"].numpy(), elig0)
    assert vis.sum() > 0
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    gate = image_gate(img, torch.from_numpy(img0))
    print(f"{name}: {gate}")
    assert gate["ok"], gate
    assert gate["maxdiff"] <= 1e-5, gate


def test_cluster_walk_visit_counts(reference):
    """The two-cluster scene's per-tile counts, as the JAX kernel gives
    them at this camera."""
    _, _, vis0, _ = reference["icosphere1_level3"]
    assert vis0.tolist() == [[0, 0, 0, 35, 43, 0, 0, 0],
                             [0, 0, 0, 41, 45, 0, 0, 0]]


def test_render_frames_equals_single_frames(reference):
    scene = reference["icosphere1_level3"][0]
    cfg = RenderConfig(width=256, height=64)
    ivps = np.stack([_ivp(256, 64, yaw=y) for y in (10.0, 25.0, 40.0)])
    batch = tile_trace.render_frames(scene, ivps, cfg)
    assert batch.shape == (3, 64, 256, 3)
    for k in range(3):
        single = tile_trace.render_frame(scene, ivps[k], cfg)
        assert torch.equal(batch[k], single)


def test_micromesh_matches_tessellated():
    """The repo's oracle: the micro-mesh render equals the -T render of the
    same asset (RMSE <= 1e-3)."""
    mesh = procedural.make_icosphere(subdivisions=0, level=2, amplitude=0.1)
    cfg = RenderConfig(width=128, height=64)
    ivp = _ivp(128, 64)
    mm = Renderer(scene_mod.build_device_scene(mesh, device="cpu"),
                  cfg).render(ivp)
    ts = Renderer(scene_mod.build_device_scene(mesh, tessellated=True,
                                               device="cpu"),
                  cfg).render(ivp)
    rmse = float(torch.sqrt(((mm - ts) ** 2).mean()))
    assert rmse <= 1e-3, rmse


def test_renderer_u8_and_pipeline(reference):
    scene = reference["icosphere0_level2"][0]
    cfg = RenderConfig(width=128, height=64)
    r = Renderer(scene, cfg)
    ivps = [_ivp(128, 64, yaw=y) for y in (10.0, 20.0, 30.0)]
    u8 = r.render_u8(ivps[0])
    assert u8.shape == (64, 128, 3) and u8.dtype == np.uint8
    img = r.render(ivps[0]).numpy()
    np.testing.assert_array_equal(
        u8, (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    pipe = FramePipeline(r)
    out = [f for f in (pipe.submit(m) for m in ivps) if f is not None]
    out += list(pipe.drain())
    assert len(out) == 3
    np.testing.assert_array_equal(out[0], u8)
    r.resize(64, 32)
    assert r.render_u8(ivps[0]).shape == (32, 64, 3)


def test_windowed_scenes_are_a_later_slice(reference):
    """A scene over the window capacity renders in windows whose walk
    equals the single fused launch's, visit for visit."""
    scene = reference["icosphere1_level3"][0]
    fused, st1 = tile_trace.render_frame(
        scene, _ivp(64, 64), RenderConfig(width=64, height=64),
        with_stats=True)
    img, st = tile_trace.render_frame(
        scene, _ivp(64, 64),
        RenderConfig(width=64, height=64, kernel_clusters_per_window=1),
        with_stats=True)
    assert st1["windows"] == 1 and st["windows"] == 2
    assert torch.equal(st["kernel_unit_visits"], st1["kernel_unit_visits"])
    gate = image_gate(img, fused)
    assert gate["ok"] and gate["maxdiff"] <= 1e-5, gate


def test_render_frames_windowed_equals_single_frames(reference):
    scene = reference["icosphere1_level3"][0]
    cfg = RenderConfig(width=64, height=64, kernel_clusters_per_window=1)
    ivps = np.stack([_ivp(64, 64, yaw=y) for y in (10.0, 40.0)])
    batch = tile_trace.render_frames(scene, ivps, cfg)
    for k in range(2):
        assert torch.equal(batch[k], tile_trace.render_frame(scene, ivps[k],
                                                             cfg))


def test_ray_matrix_input_matches_raygen(reference):
    """kernel_raygen=False: the fused launch reads a ray matrix
    (build_frame_inputs' rays) instead of generating the rays."""
    scene = reference["icosphere1_level3"][0]
    cfg = RenderConfig(width=256, height=64)
    a, sa = tile_trace.render_frame(scene, _ivp(256, 64), cfg,
                                    with_stats=True)
    b, sb = tile_trace.render_frame(
        scene, _ivp(256, 64), dataclasses.replace(cfg, kernel_raygen=False),
        with_stats=True)
    assert torch.equal(sa["kernel_unit_visits"], sb["kernel_unit_visits"])
    gate = image_gate(a, b)
    assert gate["ok"] and gate["maxdiff"] <= 1e-5, gate
