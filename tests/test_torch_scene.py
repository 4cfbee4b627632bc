"""The port's scene tables against the JAX package's, on the CPU.

The host build is the same NumPy code in both packages, so every table
must agree bit for bit, and a scene the JAX package saved must load into
the port unchanged.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rtmm_tpu.io import loader as jloader
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.utils import cache as jcache
from rtmm_tpu_torch.io import loader
from rtmm_tpu_torch.models import procedural
from rtmm_tpu_torch.models import scene as scene_mod

# One intra-op thread: the suite runs several pytest workers on one shared
# CPU, and with JAX in the same process the first multi-threaded PyTorch
# op after a JAX computation was seen to compute part of its range wrong
# (about one process in twenty; never single-threaded).
torch.set_num_threads(1)

# name -> (makes the mesh from a procedural module, tessellated)
BUILDS = {
    "icosphere0_level2": (
        lambda p: p.make_icosphere(subdivisions=0, level=2, amplitude=0.1),
        False),
    "mixed_level_plane": (        # tests/test_tiled.py's mixed_scene
        lambda p: p.make_plane(grid=(2, 2), level=2, amplitude=0.25,
                               mixed_levels=True),
        False),
    "tessellated": (
        lambda p: p.make_icosphere(subdivisions=0, level=2, amplitude=0.1),
        True),
}


def _assert_bit_equal(jax_scene, port_scene):
    jnames = [f.name for f in dataclasses.fields(jax_scene)]
    assert jnames == [f.name for f in dataclasses.fields(port_scene)]
    for name in jnames:
        a, b = getattr(jax_scene, name), getattr(port_scene, name)
        if name in jcache._META_FIELDS:
            assert a == b, name
        elif a is None:
            assert b is None, name
        else:
            a = np.asarray(a)
            b = b.cpu().numpy()
            assert (a.dtype, a.shape) == (b.dtype, b.shape), name
            assert a.tobytes() == b.tobytes(), f"{name} differs"


@pytest.mark.parametrize("name", sorted(BUILDS))
@pytest.mark.parametrize("hierarchy", [False, True])
def test_build_device_scene_bit_equal(name, hierarchy):
    make, tess = BUILDS[name]
    ref = jscene.build_device_scene(make(jproc), tessellated=tess,
                                    hierarchy=hierarchy)
    port = scene_mod.build_device_scene(make(procedural), tessellated=tess,
                                        hierarchy=hierarchy, device="cpu")
    _assert_bit_equal(ref, port)


def test_scene_from_saved_npz(tmp_path):
    make, _ = BUILDS["icosphere0_level2"]
    path = str(tmp_path / "scene.npz")
    jcache.save_scene(jscene.build_device_scene(make(jproc),
                                                hierarchy=False), path)
    with np.load(path) as z:
        loaded = scene_mod.scene_from_arrays(z, device="cpu")
    own = scene_mod.build_device_scene(make(procedural), device="cpu")
    _assert_bit_equal(own, loaded)
    assert loaded.num_units == 64 and loaded.num_clusters == 1


def test_compressed_is_a_later_slice(tmp_path):
    """The port builds compressed scenes and loads the JAX package's saved
    ones, bit for bit (tests/test_torch_compressed.py holds the rest)."""
    mesh = procedural.make_icosphere(subdivisions=0, level=3)
    own = scene_mod.build_device_scene(mesh, compressed=True, device="cpu")
    path = str(tmp_path / "c.npz")
    ref = jscene.build_device_scene(
        jproc.make_icosphere(subdivisions=0, level=3), compressed=True)
    jcache.save_scene(ref, path)
    with np.load(path) as z:
        loaded = scene_mod.scene_from_arrays(z, device="cpu")
    _assert_bit_equal(ref, own)
    _assert_bit_equal(ref, loaded)


def test_gltf_bary_round_trip_matches(tmp_path):
    path = str(tmp_path / "sphere.gltf")
    loader.save_gltf_bary(procedural.make_icosphere(
        subdivisions=1, level=3, amplitude=0.12), path)
    a = jloader.load_micromesh(path)
    b = loader.load_micromesh(path)
    for f in ("positions", "normals", "directions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.num_triangles == b.num_triangles == 80
    for ta, tb in zip(a.triangles, b.triangles):
        for f in ("base_vertex_indices", "u_positions", "u_displacements",
                  "u_present", "u_faces"):
            x, y = getattr(ta, f), getattr(tb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
