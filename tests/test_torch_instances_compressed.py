"""Instancing over a compressed base scene: the baked records and the
two-level render, against rtmm_tpu.render.instances at the sizes and
pixel budgets of tests/test_instances.py (see
tests/test_torch_instances.py for the tolerances' reasons).
"""
import jax.numpy as jnp
import numpy as np
import torch

from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.render import instances as jinst
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.render import instances as inst_mod
from test_torch_instances import (RING3, _close, _covered, _ivp, _jax_image,
                                  _npix, _port, _ring, _stacks)

# One intra-op thread (see tests/test_torch_trace.py).
torch.set_num_threads(1)


def test_bake_compressed_matches_jax():
    mesh = jproc.make_icosphere(subdivisions=0, level=3, amplitude=0.12)
    ds = jscene.build_device_scene(mesh, compressed=True)
    rot, trn, scl = _stacks(RING3)
    theirs = jinst._bake_compressed(ds, jnp.asarray(rot), jnp.asarray(trn),
                                    jnp.asarray(scl))
    ours = inst_mod.bake_instances(_port(ds), _stacks(RING3))
    assert ours.compressed and ours.unit_qn is None
    for name in ("tri_valid", "unit_valid", "cluster_valid"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      name)
    # The same unit order (else every row below is off by whole units),
    # values to the FMA tolerance of the transform.
    for name in ("aabb_min", "aabb_max", "unit_aabb_min", "unit_aabb_max",
                 "unit_grid", "cluster_aabb_min", "cluster_aabb_max",
                 "cluster_unit_meta"):
        _close(name, getattr(ours, name), getattr(theirs, name))


def test_compressed_base_matches_jax():
    """tests/test_instances.py::test_two_level_traversal_compressed_scene:
    instances of a compressed base, <= 3 pixels over 1e-3."""
    mesh = jproc.make_icosphere(subdivisions=0, level=3, amplitude=0.12)
    ds = jscene.build_device_scene(mesh, compressed=True)
    ring = _ring(4, 1.8, 0.8, 0.3)
    w, h = 96, 64
    ivp = _ivp(w, h, -30.0, 20.0, 5.0)
    ref = _jax_image(ds, ring, ivp, w, h)
    cfg = RenderConfig(width=w, height=h)
    img = inst_mod.render_instanced(_port(ds), ring, ivp, cfg)
    std = inst_mod.render_instanced(
        _port(jscene.build_device_scene(mesh, hierarchy=False)), ring, ivp,
        cfg)
    assert _covered(img, cfg) > 0.05
    for name, other in (("JAX compressed", ref), ("precomputed base", std)):
        npix, worst = _npix(img, other, 1e-3)
        print(f"compressed vs {name}: {npix} px over 1e-3, max {worst:.3g}")
        assert npix <= 3, (name, npix, worst)
