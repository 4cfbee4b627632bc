"""Multi-device rendering on the CPU: the port's parallel/sharding.py
against the JAX package's, layout by layout.

The port's ranks are processes started by parallel/launch.py over gloo
on the CPU; they run parallel/entry.py::render_jobs, so that they import
torch and the port only. The JAX reference runs in this process on the
virtual 8-device CPU mesh of tests/conftest.py. The scene is
tests/test_parallel.py's plane (8 base triangles, level 1) with 8
candidates per ray, which makes the per-ray search exhaustive on the
single-device and the scene-sharded paths alike. Tolerance 1e-5, as
tests/test_parallel.py allows the JAX package against itself.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.parallel import sharding as jsharding
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import tiled
from rtmm_tpu_torch.parallel import entry, launch, sharding
from rtmm_tpu_torch.render.renderer import render_ray
from rtmm_tpu_torch.utils import camera

torch.set_num_threads(1)

CFG = dict(width=32, height=32, ray_chunk=256, max_candidates=8)
CFG_GSPMD = dict(width=256, height=256, max_candidates=8)
RAY_LAYOUTS = {"2x1": (2, 1), "2x2": (2, 2)}


def ivp(w, h):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30), np.radians(20), 0], 3.0)
    return camera.inv_view_proj(tb, w, h)


def job(shape, cfg, pipeline, backend="auto", **kw):
    """A render_jobs job on the CPU over the scene "scene"."""
    return dict(shape=shape, device="cpu", scene="scene", cfg=cfg,
                ivp=ivp(cfg.width, cfg.height), pipeline=pipeline,
                backend=backend, **kw)


def jax_arrays(ds) -> dict:
    """A JAX scene as scene_from_arrays' input (the same tables)."""
    out = {f.name: np.asarray(getattr(ds, f.name))
           for f in dataclasses.fields(ds)
           if f.name not in scene_mod.META_FIELDS
           and getattr(ds, f.name) is not None}
    out.update({name: np.asarray(getattr(ds, name))
                for name in scene_mod.META_FIELDS})
    return out


def same_on_every_rank(results):
    """The frame every rank returned, after checking they are equal."""
    for r in results[1:]:
        np.testing.assert_array_equal(r["image"], results[0]["image"])
    return results[0]["image"]


@pytest.fixture(scope="module")
def plane():
    """(port scene, JAX scene) of the plane, each built by its package,
    with the per-ray hierarchy tables."""
    scene = scene_mod.build_device_scene(
        procedural.make_plane(grid=(2, 2), level=1, amplitude=0.15),
        hierarchy=True, device="cpu")
    jds = jscene.build_device_scene(
        jproc.make_plane(grid=(2, 2), level=1, amplitude=0.15))
    return scene, jds


@pytest.fixture(scope="module")
def port(plane):
    """Every layout's results from the port's ranks, in two worlds: two
    ranks render the per-ray 2x1 and the gspmd 2x1 frames, four the
    per-ray 2x2 frame."""
    scenes = {"scene": scene_mod.scene_arrays(plane[0])}
    cfg = RenderConfig(**CFG)
    two = launch.spawn(entry.render_jobs, 2, "cpu", args=(scenes, [
        job((2, 1), cfg, "ray"),
        job((2, 1), RenderConfig(**CFG_GSPMD), "tile")]))
    four = launch.spawn(entry.render_jobs, 4, "cpu", args=(scenes, [
        job((2, 2), cfg, "ray")]))
    return {"ray 2x1": [r[0] for r in two], "gspmd 2x1": [r[1] for r in two],
            "ray 2x2": [r[0] for r in four]}


@pytest.mark.parametrize("layout", sorted(RAY_LAYOUTS))
def test_render_sharded_matches_jax(plane, port, layout):
    scene, jds = plane
    n_rays, n_scene = RAY_LAYOUTS[layout]
    results = port[f"ray {layout}"]
    assert [r["chosen"] for r in results] == [("ray", None)] * len(results)
    out = same_on_every_rank(results)
    jmesh = jsharding.make_mesh(n_rays=n_rays, n_scene=n_scene)
    ref = np.asarray(jsharding.ShardedRenderer(
        scene=jds, cfg=JaxConfig(**CFG), mesh=jmesh,
        pipeline="ray").render(ivp(32, 32)))
    np.testing.assert_allclose(out, ref, atol=1e-5)
    single = render_ray(scene, ivp(32, 32), RenderConfig(**CFG)).numpy()
    np.testing.assert_allclose(out, single, atol=1e-5)
    assert out.shape == (32, 32, 3) and (np.abs(out - out[0, 0]) > 0.1).any()


def test_render_tiled_gspmd_matches_jax(plane, port):
    scene, jds = plane
    results = port["gspmd 2x1"]
    assert [r["chosen"] for r in results] == [("tile-gspmd", None)] * 2
    out = same_on_every_rank(results)
    jmesh = jsharding.make_mesh(n_rays=2, n_scene=1)
    ref = np.asarray(jsharding.ShardedRenderer(
        scene=jds, cfg=JaxConfig(**CFG_GSPMD), mesh=jmesh,
        pipeline="tile").render(ivp(256, 256)))
    np.testing.assert_allclose(out, ref, atol=1e-5)
    single = tiled.render_tiled(scene, ivp(256, 256),
                                RenderConfig(**CFG_GSPMD)).numpy()
    np.testing.assert_allclose(out, single, atol=1e-5)


def _shard_map_slices(ds, n):
    """Each scene shard's tables as the JAX package's shard_map hands them
    to the devices of a 1 x n mesh: {index: {name: array}}."""
    padded = jsharding._pad_scene_for_scene_axis(ds, n)
    specs = jsharding._scene_specs(padded, n)
    jmesh = jsharding.make_mesh(n_rays=1, n_scene=n)
    index = {d: s for s, d in enumerate(jmesh.devices[0])}
    out = {s: {} for s in range(n)}
    for f in dataclasses.fields(padded):
        a = getattr(padded, f.name)
        if f.name in scene_mod.META_FIELDS or a is None:
            continue
        arr = jax.device_put(a, NamedSharding(jmesh, getattr(specs, f.name)))
        for shard in arr.addressable_shards:
            out[index[shard.device]][f.name] = np.asarray(shard.data)
    return out


@pytest.mark.parametrize("kind", ["hierarchy", "compressed"])
def test_shard_scene_matches_shard_map(kind):
    """Table by table, shard_scene equals what shard_map hands each
    device, the padding of the cluster count included (the plane has
    one cluster, so shard 1 holds only padding)."""
    mesh = jproc.make_plane(grid=(2, 2), level=1 if kind == "hierarchy"
                            else 2, amplitude=0.15)
    ds = jscene.build_device_scene(mesh, compressed=kind == "compressed")
    scene = scene_mod.scene_from_arrays(jax_arrays(ds), device="cpu")
    ref = _shard_map_slices(ds, 2)
    for s in range(2):
        shard = sharding.shard_scene(scene, 2, s)
        got = {f.name: getattr(shard, f.name).numpy()
               for f in dataclasses.fields(shard)
               if f.name not in scene_mod.META_FIELDS
               and getattr(shard, f.name) is not None}
        assert sorted(got) == sorted(ref[s])
        for name, a in ref[s].items():
            np.testing.assert_array_equal(got[name], a, err_msg=name)
        assert shard.num_clusters == 1
        assert shard.device_bytes() < scene.device_bytes()


# (first tile, count) of a 160x96 frame's 5 x 3 tiles: the whole frame,
# two tiles inside a tile row, a range over a row boundary, the tail.
TILE_RANGES = [(0, 15), (2, 2), (4, 7), (11, 4)]


@pytest.mark.parametrize("tiles", TILE_RANGES,
                         ids=[f"{a}+{n}" for a, n in TILE_RANGES])
def test_frame_inputs_of_a_tile_range(plane, tiles):
    """A rank's prologue (build_frame_inputs with tiles=): its frustums
    cut before the cluster cull and rays made for its tile rows only,
    every value bit-equal to the whole frame's at those tiles."""
    scene, _ = plane
    cfg = RenderConfig(width=160, height=96)
    full = tiled.build_frame_inputs(scene, ivp(160, 96), cfg,
                                    need_q_frame=True)
    part = tiled.build_frame_inputs(scene, ivp(160, 96), cfg,
                                    need_q_frame=True, tiles=tiles)
    cut = slice(tiles[0], tiles[0] + tiles[1])
    for name in ("raymat", "dirs", "normals", "cluster_hit", "sub_normals"):
        got, want = getattr(part, name), getattr(full, name)[cut]
        assert got.shape[0] == tiles[1], name
        assert torch.equal(got, want), name
    for name in ("apex", "scene_aabb", "q_frame", "t_num"):
        assert torch.equal(getattr(part, name), getattr(full, name)), name


def test_raygen_rows():
    """generate_rays(rows=) makes the same rays as the rows of the whole
    padded grid."""
    from rtmm_tpu_torch.ops import raygen

    o, d = raygen.generate_rays(ivp(50, 40), 50, 40, 64, 64, device="cpu")
    o2, d2 = raygen.generate_rays(ivp(50, 40), 50, 40, 64, 64,
                                  device="cpu", rows=(32, 32))
    assert torch.equal(o2, o[32 * 64:]) and torch.equal(d2, d[32 * 64:])


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone, and its 1 x 1 mesh."""
    import torch.distributed as dist

    port = launch._free_port()
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        yield sharding.make_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_public_functions_on_one_rank(plane, world_of_one):
    """The module's functions, called directly on a 1 x 1 mesh, equal the
    single-device renders bit for bit (the same operations in the same
    order), and the trace kernel's walk (backend "pallas") the windowed
    frame within 1e-5 (vector against row shading)."""
    from rtmm_tpu_torch.ops import tile_trace

    scene, _ = plane
    mesh = world_of_one
    cfg = RenderConfig(**CFG)
    np.testing.assert_array_equal(
        sharding.render_sharded(scene, ivp(32, 32), cfg, mesh).numpy(),
        render_ray(scene, ivp(32, 32), cfg).numpy())
    big = RenderConfig(**CFG_GSPMD)
    single = tiled.render_tiled(scene, ivp(256, 256), big).numpy()
    np.testing.assert_array_equal(sharding.render_tiled_gspmd(
        scene, ivp(256, 256), big, mesh).numpy(), single)
    np.testing.assert_array_equal(sharding.render_tiled_sharded(
        scene, ivp(256, 256), big, mesh).numpy(), single)  # auto: xla
    kc = tile_trace.clusters_per_window(scene, cfg)
    np.testing.assert_allclose(
        sharding.render_tiled_sharded(scene, ivp(32, 32), cfg, mesh,
                                      backend="pallas").numpy(),
        tile_trace.render_windowed(scene, ivp(32, 32), cfg, kc)[0].numpy(),
        atol=1e-5)
    with pytest.raises(ValueError, match="does not cover"):
        sharding.make_mesh(2, 1, device_type="cpu")


def test_backend_rule():
    assert launch.choose_backend(4, "cpu") == "gloo"
    with pytest.raises(ValueError, match="CUDA devices only"):
        launch.choose_backend(1, "cpu", "nccl")
    with pytest.raises(ValueError, match="a card per rank"):
        launch.choose_backend(torch.cuda.device_count() + 1, "cuda", "nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        launch.choose_backend(1, "cpu", "mpi")


def test_rank_failure_raises_instead_of_hanging():
    """A rank that raises ends the world: spawn re-raises its error."""
    bad = dict(shape=(3, 1), device="cpu")
    with pytest.raises(Exception, match="does not cover 2 ranks"):
        launch.spawn(entry.render_jobs, 2, "cpu", args=({}, [bad]),
                     timeout_s=60)
