"""The port's compressed scenes against the JAX package's, on the CPU.

Host helpers and builds are the same NumPy code in both packages and must
agree bit for bit. The torch derive (the plain version of the kernel's
in-kernel derive) is held against the JAX kernel's own _derive_unit, run
through pl.pallas_call in interpret mode as tests/test_compressed.py runs
it, and against the NumPy oracle, at rtol 1e-4: XLA's CPU compiler fuses
the cross products' multiply-adds, the port rounds each product, so
cancelled terms differ in the last bits (the JAX test admits the same
rtol for the same reason). Compressed frames must give the JAX kernel's
per-tile counts exactly and pass the image gate with max |diff| <= 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import compressed as jcomp
from rtmm_tpu.utils import cache as jcache
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import compressed as comp
from rtmm_tpu_torch.ops import tile_trace
from rtmm_tpu_torch.utils import camera
from rtmm_tpu_torch.utils.gate import image_gate

# One intra-op thread: the suite runs several pytest workers on one shared
# CPU, and with JAX in the same process the first multi-threaded PyTorch
# op after a JAX computation was seen to compute part of its range wrong
# (about one process in twenty; never single-threaded).
torch.set_num_threads(1)

# name -> mesh maker over a procedural module: a level-3 uniform plane
# (plain records, shared gather matrix), a level-2 plane (indexed records
# packing 4 triangles per unit, shared unit_gmat) and a mixed-level mesh
# (indexed records, per-unit topology).
MESHES = {
    "level3_plane": lambda p: p.make_plane(grid=(4, 4), level=3,
                                           amplitude=0.05),
    "level2_plane": lambda p: p.make_plane(grid=(8, 8), level=2,
                                           amplitude=0.05),
    "mixed_levels": lambda p: p.make_icosphere(
        subdivisions=1, level=3, amplitude=0.12, mixed_levels=True),
}
APEX = np.asarray([0.3, -1.2, 2.5], np.float32)


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


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX compressed scene, port compressed scene)."""
    return {name: (jscene.build_device_scene(make(jproc), compressed=True),
                   scene_mod.build_device_scene(make(procedural),
                                                compressed=True,
                                                device="cpu"))
            for name, make in MESHES.items()}


# ----------------------------------------------------------------------
# Host helpers: copies, bit for bit.

def _present(level):
    mesh = jproc.make_plane(grid=(2, 2), level=level, amplitude=0.25,
                            mixed_levels=True)
    return [t.u_present for t in mesh.triangles
            if t.subdivision_level == level]


HELPERS = {
    "leaf_gather_matrix": lambda m: [m.leaf_gather_matrix(su)
                                     for su in range(4)],
    "uniform_unit_indices": lambda m: [m.uniform_unit_indices(su)
                                       for su in range(4)],
    "subtree_grid_coords": lambda m: [m.subtree_grid_coords(lvl)[0]
                                      for lvl in range(6)],
    "stitched_unit_topology": lambda m: [
        x for lvl in (2, 3) for pres in _present(lvl)
        for x in m.stitched_unit_topology(lvl, pres)[:2]],
    "gather_matrix_from_indices": lambda m: [
        m.gather_matrix_from_indices(m.uniform_unit_indices(su))
        for su in range(4)],
    "pack_index_rows": lambda m: [m.pack_index_rows(
        m.uniform_unit_indices(2)[None])],
    "grid_positions": lambda m: [m.grid_positions(
        *[np.random.default_rng(i).standard_normal((5, 3)).astype(
            np.float32) for i in range(6)],
        np.random.default_rng(7).standard_normal((5, 153)).astype(
            np.float32),
        m.subtree_grid_coords(4)[0], 4)],
    "derive_unit_tables_np": lambda m: [
        x for grid, su, idx in ((_records(m, m.GRID_ROWS), 3, False),
                                (_records(m, m.IDX_ROWS), 2, True))
        for x in m.derive_unit_tables_np(grid, APEX, su,
                                         indexed=idx).values()],
}


def _records(m, rows):
    """Eight random records; index rows (when there are any) of the
    all-present level-3 topology."""
    rec = np.zeros((8, rows, m.GRID_LANES), np.float32)
    rec[:, 0:3, :45] = np.random.default_rng(3).standard_normal((8, 3, 45))
    if rows == m.IDX_ROWS:
        rec[:, 3:6] = m.pack_index_rows(m.uniform_unit_indices(3)[None])[0]
    return rec


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_host_helpers_equal_jax(name):
    got, ref = HELPERS[name](comp), HELPERS[name](jcomp)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_record_constants_equal_jax():
    for name in ("GRID_ROWS", "GRID_LANES", "SUB_LEVEL", "LPU", "IDX_ROWS",
                 "IDX_SENTINEL"):
        assert getattr(comp, name) == getattr(jcomp, name), name


# ----------------------------------------------------------------------
# Builds.

@pytest.mark.parametrize("name", sorted(MESHES))
def test_compressed_build_bit_equal(scenes, name):
    ref, port = scenes[name]
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name in jcache._META_FIELDS:
            assert a == b, f.name
        elif a is None:
            assert b is None, f.name
        else:
            a, b = np.asarray(a), b.numpy()
            assert (a.dtype, a.shape) == (b.dtype, b.shape), f.name
            assert a.tobytes() == b.tobytes(), f"{f.name} differs"
    assert port.compressed and port.unit_qn is None
    assert port.indexed == (name != "level3_plane")
    assert (port.unit_gmat is not None) == (name == "level2_plane")


def test_compressed_scene_device_and_leaves_per_unit(scenes):
    """A compressed scene has no unit_qn: its device and leaves per unit
    come from the fields it does have."""
    for _, port in scenes.values():
        assert port.device == torch.device("cpu")
        assert port.leaves_per_unit == comp.LPU


def test_scene_from_saved_compressed_npz(scenes, tmp_path):
    ref, port = scenes["level2_plane"]
    path = str(tmp_path / "scene.npz")
    jcache.save_scene(ref, path)
    with np.load(path) as z:
        loaded = scene_mod.scene_from_arrays(z, device="cpu")
    assert loaded.compressed and loaded.indexed
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(loaded, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_corner_lanes_equal_index_rows(scenes):
    """The shared gather matrix as lane indices: exactly each record's
    own corner-index rows."""
    _, port = scenes["level2_plane"]
    lanes = comp.corner_lanes(port.unit_gmat)
    rows = port.unit_grid[port.unit_valid][:, 3:6, :comp.LPU].to(torch.int32)
    assert torch.equal(rows, lanes.expand_as(rows))
    uni = comp.corner_lanes(torch.from_numpy(comp.leaf_gather_matrix(3)))
    assert torch.equal(uni, torch.from_numpy(comp.uniform_unit_indices(3)))


# ----------------------------------------------------------------------
# The derive.

def _port_derive(port, apex):
    _, tables, opts = tile_trace.scene_tables(port)
    centers = 0.5 * (port.unit_aabb_min + port.unit_aabb_max)
    return comp.derive_unit_tables(tables, torch.from_numpy(apex), centers,
                                   opts["corners"]), centers


def _pallas_derive(ref, apex, centers):
    """pallas_tiled._derive_unit per unit, through pl.pallas_call in
    interpret mode (tests/test_compressed.py:317-364 does the same)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from rtmm_tpu.ops.pallas_tiled import _derive_unit

    grid = jnp.asarray(ref.unit_grid)
    n, gr, gl = grid.shape
    kidx = ref.indexed and ref.unit_gmat is None
    gmat = jnp.asarray(ref.unit_gmat if ref.unit_gmat is not None
                       else jcomp.leaf_gather_matrix(ref.sub_level))
    lpu = jcomp.LPU

    def kernel(grid_ref, gmat_ref, ctr_ref, q_out, tn_out, nrm_out):
        q, tn, nrm = _derive_unit(
            grid_ref[0], None if kidx else gmat_ref[...],
            jnp.float32(apex[0]), jnp.float32(apex[1]), jnp.float32(apex[2]),
            ctr_ref[0, 0, 0], ctr_ref[0, 0, 1], ctr_ref[0, 0, 2], lpu,
            indexed=kidx)
        q_out[0] = q
        tn_out[0] = tn
        nrm_out[0] = nrm

    fn = pl.pallas_call(
        kernel, grid=(n,),
        in_specs=[pl.BlockSpec((1, gr, gl), lambda u: (u, 0, 0)),
                  pl.BlockSpec(tuple(gmat.shape), lambda u: (0, 0)),
                  pl.BlockSpec((1, 1, 3), lambda u: (u, 0, 0))],
        out_specs=[pl.BlockSpec((1, 6, 3 * lpu), lambda u: (u, 0, 0)),
                   pl.BlockSpec((1, 1, lpu), lambda u: (u, 0, 0)),
                   pl.BlockSpec((1, 8, lpu), lambda u: (u, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((n, 6, 3 * lpu), jnp.float32),
                   jax.ShapeDtypeStruct((n, 1, lpu), jnp.float32),
                   jax.ShapeDtypeStruct((n, 8, lpu), jnp.float32)],
        interpret=True)
    q, tn, nrm = fn(grid, gmat, jnp.asarray(centers)[:, None, :])
    return (np.asarray(q), np.asarray(tn)[:, 0],
            np.asarray(nrm)[:, 0:3].transpose(0, 2, 1))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_derive_matches_pallas_derive_unit(scenes, name):
    ref, port = scenes[name]
    (q, tn, nrm), centers = _port_derive(port, APEX)
    q0, tn0, nrm0 = _pallas_derive(ref, APEX, centers.numpy())
    np.testing.assert_allclose(q.numpy(), q0, rtol=1e-4, atol=1e-30)
    np.testing.assert_allclose(tn.numpy(), tn0, rtol=1e-4, atol=1e-30)
    np.testing.assert_allclose(nrm.numpy(), nrm0, rtol=1e-4, atol=1e-30)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_derive_matches_numpy_oracle(scenes, name):
    ref, port = scenes[name]
    (q, tn, nrm), centers = _port_derive(port, APEX)
    # Indexed scenes through their records' index rows (a shared unit_gmat
    # equals them, test_corner_lanes_equal_index_rows), the level-3 plane
    # through leaf_gather_matrix.
    oracle = jcomp.derive_unit_tables_np(np.asarray(ref.unit_grid), APEX,
                                         ref.sub_level,
                                         centers=centers.numpy(),
                                         indexed=ref.indexed)
    lpu = jcomp.LPU
    np.testing.assert_allclose(q.numpy(), oracle["q"][:, 0:6, :3 * lpu],
                               rtol=1e-4, atol=1e-30)
    np.testing.assert_allclose(tn.numpy(), oracle["q"][:, 7, 3 * lpu:],
                               rtol=1e-4, atol=1e-30)
    np.testing.assert_allclose(nrm.numpy(), oracle["nrm"], rtol=1e-4,
                               atol=1e-30)


# ----------------------------------------------------------------------
# Frames.

@pytest.mark.parametrize("name", ["level2_plane", "level3_plane"])
def test_compressed_frame_matches_pallas_kernel(scenes, name):
    from jax import numpy as jnp

    from rtmm_tpu.ops.pallas_tiled import render_pallas

    ref, _ = scenes[name]
    w = h = 64
    cfg = dataclasses.replace(JaxConfig(width=w, height=h),
                              mt_precision="highest")
    img0, st = render_pallas(ref, jnp.asarray(_ivp(w, h)), cfg,
                             interpret=True, with_stats=True)
    scene = scene_mod.scene_from_arrays(_arrays(ref), device="cpu")
    img, st1 = tile_trace.render_frame(scene, _ivp(w, h),
                                       RenderConfig(width=w, height=h),
                                       with_stats=True)
    vis = st1["kernel_unit_visits"].numpy()
    print(f"{name}: visits {vis.tolist()}")
    np.testing.assert_array_equal(vis, np.asarray(st["kernel_unit_visits"]))
    np.testing.assert_array_equal(st1["kernel_unit_eligible"].numpy(),
                                  np.asarray(st["kernel_unit_eligible"]))
    assert vis.sum() > 0 and st1["windows"] == 1
    gate = image_gate(img, torch.from_numpy(np.array(img0)))
    print(f"{name}: {gate}")
    assert gate["ok"], gate
    assert gate["maxdiff"] <= 1e-5, gate


def test_compressed_matches_standard_tables():
    """The same mesh, compressed and precomputed, through the port: the
    derived leaves are the standard tables' leaves (bitwise, see
    tests/test_compressed.py), so the frames agree within the gate."""
    mesh = procedural.make_icosphere(subdivisions=0, level=3, amplitude=0.1)
    cfg = RenderConfig(width=64, height=64)
    a = tile_trace.render_frame(scene_mod.build_device_scene(
        mesh, device="cpu"), _ivp(64, 64), cfg)
    b = tile_trace.render_frame(scene_mod.build_device_scene(
        mesh, compressed=True, device="cpu"), _ivp(64, 64), cfg)
    gate = image_gate(a, b)
    assert gate["ok"] and gate["nbig"] == 0, gate
    assert (a != torch.tensor(cfg.background)).any(-1).float().mean() > 0.05


def test_compressed_tessellated_is_refused():
    mesh = procedural.make_plane(grid=(2, 2), level=2, amplitude=0.25)
    with pytest.raises(ValueError, match="tessellated"):
        scene_mod.build_device_scene(mesh, tessellated=True,
                                     compressed=True, device="cpu")
