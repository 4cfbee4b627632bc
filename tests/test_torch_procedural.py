"""The port's procedural meshes and compressed scene build at scale.

The port builds micro-meshes level by level over arrays and reads the
mesh array-wide (levels, presence, validation) in the scene build, where
the JAX package loops per face. Every array must come out identical,
dtype for dtype: the meshes against the JAX package's generators, and the
compressed scene against the JAX package's per-face path end to end (its
mesh through its build). On the CPU; NumPy only on the JAX side.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rtmm_tpu.models import mesh as jmesh
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu_torch.models import mesh as mesh_mod
from rtmm_tpu_torch.models import procedural, scene as scene_mod

torch.set_num_threads(1)


def _assert_meshes_identical(ref, got):
    for name in ("positions", "normals", "directions"):
        a, b = getattr(ref, name), getattr(got, name)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        assert a.tobytes() == b.tobytes(), name
    assert len(ref.triangles) == len(got.triangles)
    for i, (ta, tb) in enumerate(zip(ref.triangles, got.triangles)):
        for name in ("base_vertex_indices", "u_positions", "u_displacements",
                     "u_present", "u_faces"):
            a, b = getattr(ta, name), getattr(tb, name)
            assert (a.dtype, a.shape) == (b.dtype, b.shape), (i, name)
            assert a.tobytes() == b.tobytes(), (i, name)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("level", range(6))
@pytest.mark.parametrize("grid", [(1, 1), (3, 5), (8, 8)])
def test_plane_identical_to_jax(grid, level, mixed):
    kw = dict(grid=grid, level=level, amplitude=0.25, mixed_levels=mixed)
    _assert_meshes_identical(jproc.make_plane(**kw),
                             procedural.make_plane(**kw))


@pytest.mark.parametrize("level", range(6))
@pytest.mark.parametrize("subdivisions", [0, 1])
def test_icosphere_identical_to_jax(subdivisions, level):
    kw = dict(subdivisions=subdivisions, level=level, amplitude=0.15)
    _assert_meshes_identical(jproc.make_icosphere(**kw),
                             procedural.make_icosphere(**kw))


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("level", [2, 3])
def test_compressed_scene_identical_to_per_face_build(level, mixed):
    """A 12x12 plane: level 3 takes the uniform compressed build, level 2
    and the mixed levels the indexed one."""
    kw = dict(grid=(12, 12), level=level, amplitude=0.05, mixed_levels=mixed)
    ref = jscene.build_device_scene(jproc.make_plane(**kw), hierarchy=False,
                                    compressed=True)
    got = scene_mod.build_device_scene(procedural.make_plane(**kw),
                                       compressed=True, device="cpu")
    arrays = scene_mod.scene_arrays(got)
    for f in dataclasses.fields(ref):
        a = getattr(ref, f.name)
        if a is None:
            assert getattr(got, f.name) is None, f.name
            continue
        a = np.asarray(a)
        b = arrays[f.name]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f.name
        assert a.tobytes() == b.tobytes(), f.name


@pytest.mark.parametrize("gap", [1, 2])
def test_validate_reports_as_per_face(gap):
    """A level-3 triangle beside one of level 3 - gap: the array-wide
    validate passes or raises exactly as the JAX package's per-face one."""
    def mixed(mod, m):
        hi = mod.make_plane(grid=(1, 1), level=3)
        lo = mod.make_plane(grid=(1, 1), level=3 - gap)
        return m.MicroMesh(positions=hi.positions, normals=hi.normals,
                           directions=hi.directions,
                           triangles=[hi.triangles[0], lo.triangles[1]])

    def outcome(mesh):
        try:
            mesh.validate()
        except ValueError as exc:
            return str(exc)
        return None

    ref = outcome(mixed(jproc, jmesh))
    assert outcome(mixed(procedural, mesh_mod)) == ref
    assert (ref is None) == (gap == 1)
