"""The XLA tile backend (ops/tiled.py: candidate windows, trace_candidate,
xla_trace_frame, render_tiled) against the JAX package's.

The candidate windows are integer and ordering data and must be equal;
the frames go through the two-tier image gate (utils/gate.py) with a
largest pixel difference of 1e-5: both sides compute the Möller-Trumbore
numerators as float32 matrix products whose summation order may differ
in the last bit. Scenes are those of the JAX package's tests/test_tiled.py
(a level-2 icosphere, a mixed-level plane), precomputed and compressed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import culling as jculling
from rtmm_tpu.ops import tiled as jtiled
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import culling, tiled
from rtmm_tpu_torch.utils import camera
from rtmm_tpu_torch.utils.gate import image_gate

torch.set_num_threads(1)

MESHES = {
    "sphere": lambda m: m.make_icosphere(subdivisions=0, level=2,
                                         amplitude=0.1),
    "mixed": lambda m: m.make_plane(grid=(2, 2), level=2, amplitude=0.25,
                                    mixed_levels=True),
}


def _ivp(w, h, pitch=-35.0, yaw=25.0, dist=3.0):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(pitch), np.radians(yaw), 0.0], dist)
    return camera.inv_view_proj(tb, w, h)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, make in MESHES.items():
        for comp in (False, True):
            out[name, comp] = (
                jscene.build_device_scene(make(jproc), compressed=comp),
                scene_mod.build_device_scene(make(procedural),
                                             compressed=comp, device="cpu"))
    return out


@pytest.fixture(scope="module")
def frames(scenes):
    """Both sides' frame inputs of each precomputed scene at 128x64."""
    ivp = _ivp(128, 64)
    return {name: (jtiled.build_frame_inputs(
        scenes[name, False][0], jnp.asarray(ivp),
        JaxConfig(width=128, height=64)),
        tiled.build_frame_inputs(scenes[name, False][1], ivp,
                                 RenderConfig(width=128, height=64),
                                 need_q_frame=True)) for name in MESHES}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_candidate_window_exact(scenes, frames, name):
    ref, port = scenes[name, False]
    w, h = 128, 64
    ivp = _ivp(w, h)
    jfi, fi = frames[name]
    np.testing.assert_array_equal(fi.cluster_hit.numpy(),
                                  np.asarray(jfi.cluster_hit))
    np.testing.assert_array_equal(fi.q_frame.numpy(), np.asarray(jfi.q_frame))
    kc = min(2, port.num_clusters)
    rem, jrem = fi.cluster_hit, jfi.cluster_hit
    for _ in range(2):
        cand, count, entry, rem, bound = tiled.candidate_window(
            port, fi.apex, fi.normals, rem, kc)
        jc, jn, je, jrem, jb = jtiled.candidate_window(
            ref, jfi.apex, jfi.normals, jrem, kc)
        np.testing.assert_array_equal(count.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(cand.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(entry.numpy(), np.asarray(je))
        np.testing.assert_array_equal(rem.numpy(), np.asarray(jrem))
        np.testing.assert_array_equal(bound.numpy(), np.asarray(jb))
    if name == "sphere":
        np.testing.assert_array_equal(
            tiled.candidate_counts(port, ivp,
                                   RenderConfig(width=w, height=h)).numpy(),
            np.asarray(jtiled.candidate_counts(ref, jnp.asarray(ivp),
                                               JaxConfig(width=w, height=h))))


def test_gathered_cull_and_candidate_lists(scenes, frames):
    ref, port = scenes["sphere", False]
    jfi, fi = frames["sphere"]
    n_tiles = fi.normals.shape[0]
    idx = np.arange(port.num_units) % port.num_units
    umin = np.broadcast_to(port.unit_aabb_min.numpy()[idx],
                           (n_tiles, len(idx), 3))
    umax = np.broadcast_to(port.unit_aabb_max.numpy()[idx],
                           (n_tiles, len(idx), 3))
    hit = culling.frustum_hit_gathered(fi.normals, fi.apex,
                                       torch.from_numpy(umin.copy()),
                                       torch.from_numpy(umax.copy()))
    jhit = jculling.frustum_hit_gathered(jfi.normals, jfi.apex,
                                         jnp.asarray(umin), jnp.asarray(umax))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    for front_to_back in (False, True):
        extra = ((fi.apex, port.unit_aabb_min, port.unit_aabb_max)
                 if front_to_back else ())
        jextra = ((jfi.apex, ref.unit_aabb_min, ref.unit_aabb_max)
                  if front_to_back else ())
        got = culling.candidate_lists(hit, 7, *extra)
        want = jculling.candidate_lists(jhit, 7, *jextra)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name,compressed,w,h", [
    ("sphere", False, 128, 64), ("sphere", False, 100, 60),
    ("mixed", False, 128, 64),
    ("mixed", True, 96, 64)])
def test_render_tiled_matches_jax(scenes, name, compressed, w, h):
    ref, port = scenes[name, compressed]
    ivp = _ivp(w, h)
    img = tiled.render_tiled(port, ivp, RenderConfig(width=w, height=h))
    want = np.asarray(jtiled.render_tiled(ref, jnp.asarray(ivp),
                                          JaxConfig(width=w, height=h)))
    gate = image_gate(img, torch.from_numpy(want))
    print(gate)
    assert img.shape == (h, w, 3)
    assert gate["ok"] and gate["maxdiff"] <= 1e-5, gate
    assert (np.abs(want - np.asarray(RenderConfig().background)).max(-1)
            > 1e-3).sum() > 100


def test_tile_pipeline_through_windows(scenes):
    """One cluster per window (several windows per tile) renders the
    frame of the default window size."""
    _, port = scenes["mixed", False]
    w, h = 96, 64
    ivp = _ivp(w, h)
    a = tiled.render_tiled(port, ivp, RenderConfig(width=w, height=h))
    b = tiled.render_tiled(port, ivp, RenderConfig(
        width=w, height=h, clusters_per_window=1, tile_chunk=1))
    assert torch.equal(a, b)


@pytest.mark.parametrize("compressed", [False, True])
def test_slot_groups_change_nothing(scenes, compressed, monkeypatch):
    """Candidate slots take their tables in groups of SLOT_GROUP (one
    gather or derive per group): the frame is bit for bit the one of a
    gather or derive per slot, on a plane of several hundred slots."""
    mesh = procedural.make_plane(grid=(24, 24), level=3, amplitude=0.05)
    port = scene_mod.build_device_scene(mesh, compressed=compressed,
                                        device="cpu")
    w, h = 96, 64
    cfg = RenderConfig(width=w, height=h)
    a = tiled.render_tiled(port, _ivp(w, h), cfg)
    monkeypatch.setattr(tiled, "SLOT_GROUP", 1)
    b = tiled.render_tiled(port, _ivp(w, h), cfg)
    assert torch.equal(a, b)
    assert (a != torch.tensor(cfg.background)).any(-1).sum() > 400
