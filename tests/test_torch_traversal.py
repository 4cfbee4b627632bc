"""The per-ray reference backend (ops/traversal.py, pipeline "ray") against
the JAX package's.

trace_with_steps runs on the same float32 rays on both sides (JAX's
raygen). Scenes: a level-2 icosphere and a mixed-level plane (micro-mesh,
through the hierarchy), the icosphere tessellated (`-T`), and a level-5
mixed-level plane tessellated, whose 1,008 leaf slots make the last
256-slot block start at 752 and re-test 16 slots (the clamped
dynamic_slice), which the step count sees. Criteria: hit masks equal, t
within 1e-5 relative, per-pixel steps equal on all but 0.1% of the
pixels (none found; a flip would be an acceptance-edge rounding of XLA's
CPU contraction, ROADMAP queue 3).

The frame: pipeline "ray" against JAX's "ray" (at most 5 pixels over
1e-3), and against the port's own "tile" and "pallas" (the kernel's plain
version) renders with no pixel over 1e-3, as tests/test_tiled.py holds
the JAX package's backends to each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import raygen as jraygen
from rtmm_tpu.ops import traversal as jtrav
from rtmm_tpu.render import renderer as jrenderer
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import raygen, traversal
from rtmm_tpu_torch.render import instances as inst_mod
from rtmm_tpu_torch.render import renderer
from rtmm_tpu_torch.utils import camera

torch.set_num_threads(1)

SCENES = {  # name: (mesh maker, tessellated)
    "sphere": (lambda m: m.make_icosphere(subdivisions=0, level=2,
                                          amplitude=0.1), False),
    "mixed": (lambda m: m.make_plane(grid=(2, 2), level=2, amplitude=0.25,
                                     mixed_levels=True), False),
    "sphere_T": (lambda m: m.make_icosphere(subdivisions=0, level=2,
                                            amplitude=0.1), True),
    "mixed5_T": (lambda m: m.make_plane(grid=(2, 2), level=5,
                                        amplitude=0.25, mixed_levels=True),
                 True),
}


def _ivp(w, h, pitch=-35.0, yaw=25.0, dist=3.0):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(pitch), np.radians(yaw), 0.0], dist)
    return camera.inv_view_proj(tb, w, h)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, (make, tess) in SCENES.items():
        out[name] = (jscene.build_device_scene(make(jproc), tessellated=tess),
                     scene_mod.build_device_scene(make(procedural),
                                                  tessellated=tess,
                                                  hierarchy=True,
                                                  device="cpu"))
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_with_steps_matches_jax(scenes, name):
    ref, port = scenes[name]
    w, h = (64, 32) if name == "mixed5_T" else (128, 64)
    if name == "mixed5_T":
        assert port.num_leaf_slots == 1008      # the clamped last block
    o, d = (np.array(x) for x in jraygen.generate_rays(
        jnp.asarray(_ivp(w, h), jnp.float32), w, h))
    jcfg = JaxConfig(width=w, height=h)
    jt, jn, jh, js = (np.asarray(x) for x in jax.jit(
        lambda s, a, b: jtrav.trace_with_steps(s, a, b, jcfg))(
            ref, jnp.asarray(o), jnp.asarray(d)))
    t, n, hit, steps = (x.numpy() for x in traversal.trace_with_steps(
        port, torch.from_numpy(o), torch.from_numpy(d),
        RenderConfig(width=w, height=h)))
    assert steps.dtype == np.int32 and jh.sum() > 100
    np.testing.assert_array_equal(hit, jh)
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    np.testing.assert_allclose(n[hit], jn[hit], atol=1e-5)
    flips = int((steps != js).sum())
    print(f"{name}: {int(jh.sum())} hits, {int(js.sum())} steps, "
          f"{flips} step flips")
    assert flips <= len(steps) // 1000


def _render(scene, pipeline, w, h, **kw):
    cfg = RenderConfig(width=w, height=h, pipeline=pipeline, **kw)
    return renderer.Renderer(scene, cfg).render(_ivp(w, h)).numpy()


@pytest.mark.parametrize("name", ["sphere", "mixed"])
def test_ray_pipeline_matches_jax_and_tile(scenes, name):
    ref, port = scenes[name]
    w, h = 128, 64
    jimg = np.asarray(jrenderer.Renderer(ref, JaxConfig(
        width=w, height=h, pipeline="ray", ray_chunk=4096)).render(
            _ivp(w, h)))
    ray = _render(port, "ray", w, h, ray_chunk=4096)
    npix = int((np.abs(ray - jimg).max(-1) > 1e-3).sum())
    assert npix <= 5, f"{npix} pixels differ from JAX's ray pipeline"
    for other in ("tile", "pallas"):
        img = _render(port, other, w, h)
        npix = int((np.abs(ray - img).max(-1) > 1e-3).sum())
        assert npix == 0, f"{other} differs on {npix} pixels"


def test_chunks_do_not_change_the_frame(scenes):
    """The frame is the same whatever the chunk (256 rays, a partial last
    chunk, or one chunk), and _pick_chunk is the JAX package's."""
    port = scenes["sphere"][1]
    w, h = 100, 30
    imgs = [_render(port, "ray", w, h, ray_chunk=c) for c in (256, 700,
                                                              1 << 20)]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[0], imgs[2])
    for level in (0, 3, 4, 5):
        for chunk, size in ((16384, (1920, 1080)), (8192, (64, 32)),
                            (300, (100, 30))):
            cfg = RenderConfig(width=size[0], height=size[1],
                               ray_chunk=chunk)
            jcfg = JaxConfig(width=size[0], height=size[1], ray_chunk=chunk)
            fake = dataclasses.replace(port, max_level=level)
            assert (renderer._pick_chunk(cfg, fake)
                    == jrenderer._pick_chunk(jcfg, fake))


def test_instances_work_with_ray_pipeline():
    """Baked instances through the per-ray backend (the 2D hierarchy
    tables transform under rigid + scale), as tests/test_instances.py
    holds them: no pixel over 1e-3 against the tile backend."""
    base = scene_mod.build_device_scene(
        procedural.make_icosphere(subdivisions=0, level=2, amplitude=0.1),
        hierarchy=True, device="cpu")
    baked = inst_mod.bake_instances(base, [
        inst_mod.Instance.from_euler([0.8, 0.0, 0.0], (0.2, 0.1, 0.0), 1.1)])
    w, h = 96, 64
    ivp = _ivp(w, h, pitch=-30.0, yaw=20.0, dist=5.0)
    a = renderer.Renderer(baked, RenderConfig(
        width=w, height=h, pipeline="ray", ray_chunk=2048)).render(ivp)
    b = renderer.Renderer(baked, RenderConfig(
        width=w, height=h, pipeline="tile")).render(ivp)
    npix = int(((a - b).abs().amax(-1) > 1e-3).sum())
    assert npix == 0, f"{npix} pixels differ between pipelines"
    assert float((a - b).abs().amax()) < 1e-3


def test_guards_refuse_scenes_without_tables():
    mesh = procedural.make_icosphere(subdivisions=0, level=2, amplitude=0.1)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3)
    cfg = RenderConfig()
    comp = scene_mod.build_device_scene(mesh, compressed=True, device="cpu")
    with pytest.raises(ValueError, match="compressed scenes"):
        traversal.trace(comp, o, d, cfg)
    flat = scene_mod.build_device_scene(mesh, device="cpu")
    with pytest.raises(ValueError, match="hierarchy=False"):
        traversal.trace(flat, o, d, cfg)
    with pytest.raises(ValueError, match="hierarchy=False"):
        renderer.Renderer(flat, RenderConfig(width=8, height=8,
                                             pipeline="ray")).render(
            _ivp(8, 8))
    # A level-0 scene has no hierarchy to need.
    plain = scene_mod.build_device_scene(
        procedural.make_plane(grid=(2, 2), level=0, amplitude=0.0),
        device="cpu")
    t, _, hit = traversal.trace(plain, torch.tensor([[0.1, 0.2, 1.0]]),
                                torch.tensor([[0.0, 0.0, -1.0]]), cfg)
    assert bool(hit[0]) and abs(float(t[0]) - 1.0) < 1e-6


def test_candidate_cut_and_hit_counts():
    """aabb_hit_counts counts the AABBs each ray enters (a brute-force
    slab test in float64 agrees away from box faces); with max_candidates
    at its maximum the trace equals the trace over every triangle."""
    scene = scene_mod.build_device_scene(
        procedural.make_icosphere(subdivisions=2, level=1, amplitude=0.15),
        hierarchy=True, device="cpu")
    w, h = 64, 48
    o, d = raygen.generate_rays(_ivp(w, h), w, h, device="cpu")
    counts = traversal.aabb_hit_counts(scene, o, d)
    lo = scene.aabb_min.double().numpy()
    hi = scene.aabb_max.double().numpy()
    on, dn = o.double().numpy(), d.double().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (lo[None] - on[:, None]) / dn[:, None]
        t1 = (hi[None] - on[:, None]) / dn[:, None]
    near = np.nanmax(np.minimum(t0, t1), -1)
    far = np.nanmin(np.maximum(t0, t1), -1)
    ref = ((near <= far) & (far >= 0) & scene.tri_valid.numpy()[None]
           ).sum(1)
    assert int((counts.numpy() != ref).sum()) <= 2
    k = int(counts.max())
    assert k > 8 and int((counts > 8).sum()) > 0
    cut = traversal.trace_with_steps(scene, o, d, RenderConfig(
        max_candidates=k))
    every = traversal.trace_with_steps(scene, o, d, RenderConfig(
        max_candidates=scene.num_triangles))
    for a, b in zip(cut, every):
        assert torch.equal(a, b)
