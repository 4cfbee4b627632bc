"""Instancing: the port's render/instances.py against the JAX package's.

Baking is held in two stages, because the baked vertices differ from
JAX-on-CPU by FMA ulps (XLA contracts a*b+c, the port rounds each
operation) and an ulp can move a leaf across a Morton cell and with it
the whole unit order: the transform to a tolerance on the fields that
keep the instance-major order, and the ordering and packing exactly (unit
order, validity, AABBs) when fed the very same world-space leaves.

The merged launch's row assignment, n_seen and overflow set are discrete
and must equal the JAX quantities, recomputed here from rtmm_tpu
primitives in the order of rtmm_tpu/render/instances.py, exactly.

Images are held against rtmm_tpu.render.instances.render_instanced (the
Pallas kernel in interpret mode at mt_precision="highest") at the sizes
and pixel budgets of tests/test_instances.py: a handful of silhouette
pixels may flip on last-bit differences, nothing else.
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
from rtmm_tpu.ops import culling as jculling
from rtmm_tpu.ops import tiled as jtiled
from rtmm_tpu.render import instances as jinst
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import scene as scene_mod
from rtmm_tpu_torch.ops import tile_trace
from rtmm_tpu_torch.render import instances as inst_mod
from rtmm_tpu_torch.utils import camera
from test_torch_trace import _arrays

# One intra-op thread (see tests/test_torch_trace.py).
torch.set_num_threads(1)


def _ivp(w, h, pitch, yaw, dist):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(pitch), np.radians(yaw), 0.0], dist)
    return camera.inv_view_proj(tb, w, h)


def _port(ds):
    return scene_mod.scene_from_arrays(_arrays(ds), device="cpu")


def _stacks(ring):
    return (np.stack([i.rotation for i in ring]),
            np.stack([i.translation for i in ring]),
            np.asarray([i.scale for i in ring], np.float32))


def _ring(n, radius, scale, tilt, z=0.0):
    return [jinst.Instance.from_euler(
        [radius * np.cos(a), radius * np.sin(a), z], (0.0, a, tilt * i),
        scale) for i, a in enumerate(2.0 * np.pi * np.arange(n) / n)]


@pytest.fixture(scope="module")
def base():
    """(JAX scene, port scene): a 20-triangle level-2 icosphere with its
    hierarchy tables, so that the bake's node fields are held too."""
    ds = jscene.build_device_scene(
        jproc.make_icosphere(subdivisions=0, level=2, amplitude=0.1))
    return ds, _port(ds)


RING3 = [jinst.Instance.from_euler([1.5 * np.cos(a), 1.5 * np.sin(a), 0.1],
                                   (0.1, a, 0.2), 0.9)
         for a in (0.0, 2.1, 4.2)]


def _close(name, a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=name)


def test_instance_tensors_from_both_forms():
    rot, trn, scl = inst_mod.instance_tensors(RING3, "cpu")
    rot2, trn2, scl2 = inst_mod.instance_tensors(_stacks(RING3), "cpu")
    assert rot.shape == (3, 3, 3) and rot.dtype == torch.float32
    assert torch.equal(rot, rot2) and torch.equal(trn, trn2)
    assert torch.equal(scl, scl2)
    ident = inst_mod.Instance.identity()
    assert ident.scale == 1.0 and np.array_equal(ident.rotation, np.eye(3))
    np.testing.assert_array_equal(
        inst_mod.Instance.from_euler([1, 2, 3], (0.3, -0.5, 0.2), 1.4
                                     ).rotation,
        jinst.Instance.from_euler([1, 2, 3], (0.3, -0.5, 0.2), 1.4).rotation)


def test_morton_leaf_order_is_exact():
    """Same centers, same order: sub, div, mul, clip and cast have no
    a*b+c for XLA to contract."""
    rng = np.random.default_rng(5)
    centers = rng.uniform(-3.0, 3.0, size=(4096, 3)).astype(np.float32)
    valid = rng.uniform(size=4096) > 0.2
    ours = inst_mod._morton_leaf_order(torch.from_numpy(centers),
                                       torch.from_numpy(valid))
    theirs = jinst._morton_leaf_order(jnp.asarray(centers),
                                      jnp.asarray(valid))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


UNSORTED = ("aabb_min", "aabb_max", "plane_t", "plane_b", "plane_n",
            "plane_o", "node_verts", "node_minmax", "node_pass",
            "leaf_verts", "leaf_mask", "tri_valid")
PACKED_EXACT = ("unit_aabb_min", "unit_aabb_max", "unit_valid",
                "unit_leaf_idx", "cluster_aabb_min", "cluster_aabb_max",
                "cluster_valid", "cluster_unit_meta")
PACKED_CLOSE = ("unit_qn", "unit_n", "unit_e2w2", "unit_nrm",
                "unit_nrm_pad", "unit_q16")


def test_bake_transform_and_packing_match_jax(base):
    ds, scene = base
    rot, trn, scl = _stacks(RING3)
    theirs = jinst._bake(ds, jnp.asarray(rot), jnp.asarray(trn),
                         jnp.asarray(scl))
    ours = inst_mod._bake(scene, *inst_mod.instance_tensors(RING3, "cpu"))
    # Stage 1, the transform: fields in instance-major order. XLA's FMA
    # contraction of the 3-term sums leaves last-bit differences.
    for name in UNSORTED:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a is not None and b is not None, name
        assert tuple(a.shape) == tuple(b.shape), name
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        else:
            _close(name, a, b)
    assert ours.num_triangles == 3 * scene.num_triangles
    # Stage 2, ordering and packing, on JAX's own world-space leaves:
    # order, validity and AABBs exactly, the MT tables to FMA tolerance.
    packed = inst_mod._pack_leaves(
        torch.from_numpy(np.array(theirs.leaf_verts).reshape(-1, 3, 3)),
        torch.from_numpy(np.array(theirs.leaf_mask).reshape(-1)),
        scene.unit_nrm_pad.shape[2])
    for name in PACKED_EXACT:
        np.testing.assert_array_equal(packed[name].numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      name)
    for name in PACKED_CLOSE:
        _close(name, packed[name], getattr(theirs, name), rtol=1e-4)
    # Every field _bake replaces is one the port's scene carries.
    for name in PACKED_EXACT + PACKED_CLOSE:
        assert tuple(getattr(ours, name).shape) == tuple(
            getattr(theirs, name).shape), name


# Bench config 8's ring (bench.py:175-187) and verify frame
# (bench.py:510-515).
def _config8():
    rng = np.random.default_rng(9)
    ring = []
    for i in range(64):
        a = 2.0 * np.pi * i / 64
        rad = 2.4 + 0.9 * ((i * 7) % 3)
        ring.append(jinst.Instance.from_euler(
            [rad * np.cos(a), rad * np.sin(a),
             0.8 * float(rng.standard_normal())], (0.0, a, 0.2 * i), 0.35))
    return ring


@pytest.fixture(scope="module")
def config8():
    ds = jscene.build_device_scene(
        jproc.make_icosphere(subdivisions=1, level=3, amplitude=0.12),
        hierarchy=False)
    return ds, _port(ds), _config8()


@pytest.mark.parametrize("cap", [0, 1])
def test_row_assignment_matches_jax(config8, cap):
    """The 64-instance ring at 480x288, default pool (everything fits) and
    a pool of one row per instance (a non-empty overflow set). No
    tracing."""
    ds, scene, ring = config8
    w, h = 480, 288
    ivp = _ivp(w, h, -30.0, 25.0, 6.5)
    rot, trn, scl = (jnp.asarray(x) for x in _stacks(ring))
    jcfg = JaxConfig(width=w, height=h, instance_tile_cap=cap)
    # rtmm_tpu/render/instances.py:446-497 and :602, in its order.
    pw, ph = jtiled.padded_size(w, h)
    n_tiles = (pw // 32) * (ph // 32)
    apex_w, normals_w = jculling.tile_frustums(jnp.asarray(ivp), w, h, pw,
                                               ph)
    rows = jinst._row_budget(jcfg, n_tiles, 64)
    hp = jax.lax.Precision.HIGHEST
    inv_s = 1.0 / scl
    apex_o = (jnp.einsum("nji,nj->ni", rot, apex_w - trn, precision=hp)
              * inv_s[:, None])
    normals_o = jnp.einsum("nji,xyj->nxyi", rot, normals_w, precision=hp)
    cluster_hit = jax.vmap(
        lambda a, nm: jculling.cull_units(a, nm, ds.cluster_aabb_min,
                                          ds.cluster_aabb_max,
                                          ds.cluster_valid))(apex_o,
                                                             normals_o)
    tile_sees = cluster_hit.any(axis=2)
    n_seen = tile_sees.sum(axis=1)
    total = 64 * n_tiles
    fidx = jnp.arange(total, dtype=jnp.int32)
    key = jnp.where(tile_sees.reshape(total), fidx, jnp.int32(total))
    _, sidx = jax.lax.sort_key_val(key, fidx)
    sel = sidx[:rows]
    row_valid = key[sel] < total
    row_inst = jnp.where(row_valid, sel // n_tiles, 0)
    row_tile = jnp.where(row_valid, sel % n_tiles, 0)
    overflow = jnp.cumsum(n_seen) > rows

    cfg = RenderConfig(width=w, height=h, instance_tile_cap=cap)
    assert inst_mod._row_budget(cfg, n_tiles, 64) == rows
    t = inst_mod.instance_tensors(_stacks(ring), "cpu")
    world = inst_mod.world_frame(ivp, cfg, "cpu")
    launch = inst_mod.merged_launch_inputs(scene, *t, ivp, world, cfg)
    print(f"cap {cap}: pool {rows} rows, {int(launch.row_valid.sum())} "
          f"valid, S = {int(launch.n_seen.sum())}, overflow "
          f"{int(launch.overflow.sum())} instances")
    np.testing.assert_array_equal(launch.n_seen.numpy(), np.asarray(n_seen))
    np.testing.assert_array_equal(launch.row_valid.numpy(),
                                  np.asarray(row_valid))
    np.testing.assert_array_equal(launch.row_inst.numpy(),
                                  np.asarray(row_inst))
    np.testing.assert_array_equal(launch.row_tile.numpy(),
                                  np.asarray(row_tile))
    np.testing.assert_array_equal(launch.overflow.numpy(),
                                  np.asarray(overflow))
    assert bool(launch.overflow.any()) == (cap == 1)
    assert int(launch.n_seen.sum()) > 64
    # Each valid row lists at least one cluster, padding rows none.
    assert bool(((launch.ccount > 0) == launch.row_valid).all())
    assert launch.frus.shape == (rows, 128) and launch.raymat is None


def _jax_image(ds, ring, ivp, w, h, **kw):
    cfg = JaxConfig(width=w, height=h, pipeline="tile",
                    mt_precision="highest", **kw)
    return np.array(jinst.render_instanced(ds, ring, ivp, cfg))


def _npix(a, b, tol):
    d = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    return int((d > tol).sum()), float(d.max())


def _covered(img, cfg):
    bg = np.asarray(cfg.background, np.float32)
    return float((np.abs(np.asarray(img) - bg).max(-1) > 1e-5).mean())


def test_merged_and_serial_match_jax(base):
    """tests/test_instances.py::test_merged_instanced_matches_serial's
    scene: <= 5 pixels over 1e-4."""
    ds, scene = base
    ring = [jinst.Instance.from_euler([0.9 * np.cos(a), 0.9 * np.sin(a),
                                       0.05 * i], (0.0, a, 0.1 * i), 0.5)
            for i, a in enumerate(np.linspace(0, 2 * np.pi, 5)[:-1])]
    w, h = 128, 64
    ivp = _ivp(w, h, -25.0, 30.0, 2.6)
    ref = _jax_image(ds, ring, ivp, w, h)
    cfg = RenderConfig(width=w, height=h)
    tile_trace.reset_launches()
    merged = inst_mod.render_instanced(scene, _stacks(ring), ivp, cfg)
    serial = inst_mod.render_instanced(scene, ring, ivp, cfg, serial=True)
    renderer = inst_mod.InstancedRenderer(scene, ring, cfg)
    assert torch.equal(renderer.render(ivp), merged)
    u8 = renderer.render_u8(ivp)
    assert u8.shape == (h, w, 3) and u8.dtype == np.uint8
    assert sum(tile_trace.LAUNCHES.values()) == 0     # CPU: plain versions
    assert merged.shape == (h, w, 3) and _covered(merged, cfg) > 0.05
    for name, img in (("merged", merged), ("serial", serial)):
        npix, worst = _npix(img, ref, 1e-4)
        print(f"{name} vs JAX merged: {npix} px over 1e-4, max {worst:.3g}")
        assert npix <= 5, (name, npix, worst)
    npix, worst = _npix(merged, serial, 1e-4)
    assert npix <= 5, (npix, worst)
    # The ray-matrix source of the raw launch (kernel_raygen False).
    rm = inst_mod.render_instanced(
        scene, ring, ivp, dataclasses.replace(cfg, kernel_raygen=False))
    npix, worst = _npix(rm, merged, 1e-4)
    assert npix <= 5, (npix, worst)








def test_two_level_matches_baked_in_the_port(base):
    """tests/test_instances.py::test_two_level_traversal_matches_baked:
    render_instanced against the baked world-space scene through
    render_frame, <= 3 pixels over 1e-3."""
    _, scene = base
    ring = [jinst.Instance.from_euler(
        [2.2 * np.cos(a), 2.2 * np.sin(a), 0.0], (0.0, a, 0.25 * i),
        0.7 + 0.1 * (i % 3))
        for i, a in enumerate(2.0 * np.pi * np.arange(6) / 6)]
    w, h = 96, 64
    ivp = _ivp(w, h, -30.0, 20.0, 6.0)
    cfg = RenderConfig(width=w, height=h)
    baked = tile_trace.render_frame(inst_mod.bake_instances(scene, ring),
                                    ivp, cfg)
    two_level = inst_mod.render_instanced(scene, ring, ivp, cfg)
    npix, worst = _npix(two_level, baked, 1e-3)
    print(f"two-level vs baked: {npix} px over 1e-3, max {worst:.3g}")
    assert npix <= 3, (npix, worst)
    assert _covered(two_level, cfg) > 0.02
