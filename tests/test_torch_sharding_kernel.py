"""The tile-sharded path with the trace kernel's walk: render_tiled_sharded
(backend="pallas"), whose shards run the windowed trace (K1b) - on the
CPU its plain version - against the JAX package's interpret-mode Pallas
path on the same mesh, and against the single-device windowed trace.

Both packages trace the very same tables (the JAX scene goes into the
port through scene_from_arrays); JAX runs at mt_precision="highest"
(float32 products). Tolerance as tests/test_parallel.py allows the JAX
package against itself: at most 5 pixels over 1e-4 (0 expected). Also
the entry points: dryrun_multichip(4) on the CPU and entry() (against
the JAX package's, within the two-tier image gate of bench.py, as the
XLA tile backend is held: XLA's CPU compiler fuses multiply-adds that
the port rounds separately). Compressed scenes:
tests/test_torch_sharding_compressed.py.
"""
import jax
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.parallel import sharding as jsharding
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import scene as scene_mod
from rtmm_tpu_torch.ops import tile_trace
from rtmm_tpu_torch.parallel import entry, launch
from rtmm_tpu_torch.utils.gate import image_gate
from test_torch_sharding import ivp, jax_arrays, same_on_every_rank

torch.set_num_threads(1)

W, H = 128, 64
CFG = dict(width=W, height=H, max_candidates=8, pipeline="tile")


def tile_job(shape, cfg, scene="plane", **kw):
    return dict(shape=shape, device="cpu", scene=scene, cfg=cfg,
                ivp=ivp(cfg.width, cfg.height), pipeline="tile",
                backend="pallas", **kw)


def jax_sharded(ds, n_rays, n_scene, **cfg):
    """The JAX package's tile-sharded frame, its Pallas kernel in
    interpret mode on the virtual CPU mesh."""
    jcfg = JaxConfig(**{**CFG, **cfg}, mt_precision="highest")
    jmesh = jsharding.make_mesh(n_rays=n_rays, n_scene=n_scene)
    sr = jsharding.ShardedRenderer(scene=ds, cfg=jcfg, mesh=jmesh,
                                   pipeline="tile", backend="pallas")
    assert (sr.chosen_pipeline, sr.chosen_backend) == ("tile-sharded",
                                                       "pallas")
    return np.asarray(sr.render(ivp(jcfg.width, jcfg.height)))


def diverging(out, ref) -> int:
    return int((np.abs(out - ref).max(-1) > 1e-4).sum())


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, port scene on the same tables): the plane of
    tests/test_parallel.py (one cluster) and a level-3 icosphere with two
    clusters, so that each of two scene shards walks a real one."""
    out = {}
    for name, mesh in (
            ("plane", jproc.make_plane(grid=(2, 2), level=1,
                                       amplitude=0.15)),
            ("sphere", jproc.make_icosphere(subdivisions=1, level=3,
                                            amplitude=0.1))):
        ds = jscene.build_device_scene(mesh, hierarchy=False)
        out[name] = ds, scene_mod.scene_from_arrays(jax_arrays(ds),
                                                    device="cpu")
    assert out["sphere"][1].num_clusters == 2
    return out


@pytest.fixture(scope="module")
def port(scenes):
    """The port's ranks: four render the plane on 2 x 2, two render it on
    2 x 1 and the sphere on 1 x 2."""
    arrays = {k: scene_mod.scene_arrays(v[1]) for k, v in scenes.items()}
    cfg = RenderConfig(**CFG)
    four = launch.spawn(entry.render_jobs, 4, "cpu", args=(arrays, [
        tile_job((2, 2), cfg)]))
    two = launch.spawn(entry.render_jobs, 2, "cpu", args=(arrays, [
        tile_job((2, 1), cfg), tile_job((1, 2), cfg, scene="sphere")]))
    return {"2x2": [r[0] for r in four], "2x1": [r[0] for r in two],
            "sphere 1x2": [r[1] for r in two]}


def single_windowed(scene):
    """The single-device windowed trace of the frame: (t, normals (tiles,
    TILE, 3), visits)."""
    cfg = RenderConfig(**CFG)
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene, ivp(W, H), cfg)
    t, n, visits, _, _ = tile_trace.trace_windows(
        scene, fi, frus, raymat, cfg, tile_trace.clusters_per_window(
            scene, cfg))
    return t.numpy(), n.transpose(1, 2).numpy(), visits.numpy()


def test_tiled_sharded_kernel_matches_jax(scenes, port):
    results = port["2x2"]
    assert {r["chosen"] for r in results} == {("tile-sharded", "pallas")}
    out = same_on_every_rank(results)
    ref = jax_sharded(scenes["plane"][0], 2, 2)
    npix = diverging(out, ref)
    print(f"2x2 against JAX: {npix} pixels over 1e-4")
    assert npix <= 5, f"{npix} pixels diverge"
    assert sum(r["trace"]["visits"].sum() for r in results) > 0


def test_rays_split_is_bit_equal_to_single_device(scenes, port):
    """2 x 1: each rank's tile rows equal the single-device windowed
    trace's bit for bit, and the ranks' visits sum to its visits."""
    t0, n0, vis0 = single_windowed(scenes["plane"][1])
    total = 0
    for r in port["2x1"]:
        tr = r["trace"]
        rows = slice(tr["tile0"], tr["tile0"] + tr["t"].shape[0])
        np.testing.assert_array_equal(tr["t"], t0[rows])
        np.testing.assert_array_equal(tr["n"], n0[rows])
        np.testing.assert_array_equal(tr["visits"], vis0[rows])
        total += int(tr["visits"].sum())
    assert total == int(vis0.sum()) > 0


def test_scene_split_finds_the_single_device_hits(scenes, port):
    """1 x 2 on a two-cluster scene: each shard walks one cluster; the
    combined t equals the single-device t on every ray, and the frame
    equals the single-device windowed frame."""
    _, scene = scenes["sphere"]
    results = port["sphere 1x2"]
    t0, _, vis0 = single_windowed(scene)
    visits = [r["trace"]["visits"] for r in results]
    print(f"sphere 1x2: visits per shard {[int(v.sum()) for v in visits]},"
          f" single device {int(vis0.sum())}")
    assert all(int(v.sum()) > 0 for v in visits)
    for r in results:
        np.testing.assert_array_equal(r["trace"]["t"], t0)
    out = same_on_every_rank(results)
    cfg = RenderConfig(**CFG)
    img0 = tile_trace.render_windowed(
        scene, ivp(W, H), cfg, tile_trace.clusters_per_window(scene, cfg))[0]
    assert diverging(out, img0.numpy()) == 0


def test_scene_split_matches_jax(scenes, port):
    """1 x 2 on the two-cluster scene against the JAX package's
    interpret-mode Pallas path: both shards walk a real cluster, each
    with its own exit box, kc and cluster cull."""
    results = port["sphere 1x2"]
    assert {r["chosen"] for r in results} == {("tile-sharded", "pallas")}
    out = same_on_every_rank(results)
    npix = diverging(out, jax_sharded(scenes["sphere"][0], 1, 2))
    print(f"sphere 1x2 against JAX: {npix} pixels over 1e-4")
    assert npix <= 5, f"{npix} pixels diverge"


def test_dryrun_multichip_cpu():
    """Four ranks on a 2 x 2 mesh through the tile-sharded renderer with
    the kernel's walk (its plain version here: no launches counted); every
    rank walks units of its own shard; the frame equals the single-device
    frame."""
    results = entry.dryrun_multichip(4, device="cpu", timeout_s=90)
    assert [r["mesh"] for r in results] == [(2, 2)] * 4
    assert all(r["launches"] == {} and r["visits"] > 0 for r in results)
    out = same_on_every_rank(results)
    scene = entry._example_scene(level=3, device="cpu", subdivisions=1)
    cfg = RenderConfig(width=64, height=32, ray_chunk=256,
                       max_candidates=2)
    img0 = tile_trace.render_frame(scene, entry._example_ivp(64, 32), cfg)
    assert diverging(out, img0.numpy()) == 0


def test_entry_matches_jax():
    import __graft_entry__ as ge

    fn, args = entry.entry(device="cpu")
    img = fn(*args)
    assert img.shape == (128, 128, 3) and bool(torch.isfinite(img).all())
    jfn, jargs = ge.entry()
    gate = image_gate(img, torch.from_numpy(np.array(jax.jit(jfn)(*jargs))))
    print(f"entry() against the JAX package's: {gate}")
    assert gate["ok"], gate
