"""The raw trace mode: the port's plain version against the JAX kernel.

Rows are those of a merged instancing launch over three non-identity
instances (rotated, translated, scales 0.6-1.3, so that a swap of the two
apexes of the pack or a missing 1/scale shows) at 96x64, built once by
the port's prologue and handed as the same NumPy arrays to
rtmm_tpu.ops.pallas_tiled.trace_pallas(raw=True) in interpret mode at
mt_precision="highest".

Tolerances: hit masks must be equal. t agrees to rtol 2e-5 and the summed
winner normal to 1e-5: XLA's CPU compiler contracts a*b+c into FMA where
the port rounds each operation, which moves rays and quotients by last
bits; a different winner leaf at a t-tie within that noise would show as
a normal off by ~0.1, which the scenes here do not produce.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import pallas_tiled
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.ops import tile_trace, tiled
from rtmm_tpu_torch.render import instances as inst_mod
from test_torch_instances import _ivp, _port

# One intra-op thread (see tests/test_torch_trace.py).
torch.set_num_threads(1)

W, H = 96, 64
RING = [inst_mod.Instance.from_euler([1.6, 0.2, 0.1], (0.3, -0.5, 0.2), 0.6),
        inst_mod.Instance.from_euler([-1.1, 0.9, -0.3], (0.1, 2.1, 0.7), 1.3),
        inst_mod.Instance.from_euler([0.1, -1.4, 0.4], (-0.4, 4.0, 0.1),
                                     0.9)]
BIG = tile_trace.BIG


def _launch(scene, kernel_raygen):
    cfg = RenderConfig(width=W, height=H, kernel_raygen=kernel_raygen)
    ivp = _ivp(W, H, -30.0, 20.0, 4.5)
    world = inst_mod.world_frame(ivp, cfg, "cpu")
    launch = inst_mod.merged_launch_inputs(
        scene, *inst_mod.instance_tensors(RING, "cpu"), ivp, world, cfg)
    assert int(launch.row_valid.sum()) >= 6
    return cfg, launch


def _jax_raw(ds, launch, kernel_raygen):
    cfg = JaxConfig(width=W, height=H, mt_precision="highest")
    raymat = (None if launch.raymat is None
              else jnp.asarray(launch.raymat.numpy()))
    out = pallas_tiled.trace_pallas(
        ds, raymat, jnp.asarray(launch.frus.numpy()),
        jnp.asarray(launch.ccand.numpy()), jnp.asarray(launch.ccount.numpy()),
        jnp.asarray(launch.centry.numpy()), None, None, cfg, interpret=True,
        raw=True, xform_raygen=kernel_raygen)
    return np.array(out)


def _hold(name, out, ref, vis):
    out = out.numpy()
    hit, hit0 = out[:, 0] < BIG * 0.5, ref[:, 0] < BIG * 0.5
    print(f"{name}: {int(hit.sum())} rays hit on {out.shape[0]} rows, "
          f"visits {vis.tolist()}")
    assert hit.sum() > 200
    np.testing.assert_array_equal(hit, hit0)
    np.testing.assert_allclose(out[:, 0][hit], ref[:, 0][hit], rtol=2e-5)
    np.testing.assert_array_equal(out[:, 0][~hit], ref[:, 0][~hit])
    np.testing.assert_allclose(out[:, 1:4], ref[:, 1:4], atol=1e-5)


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene) of a two-cluster icosphere."""
    ds = jscene.build_device_scene(
        jproc.make_icosphere(subdivisions=1, level=3, amplitude=0.12),
        hierarchy=False)
    return ds, _port(ds)


@pytest.mark.parametrize("kernel_raygen", [True, False],
                         ids=["xform_raygen", "ray_matrix"])
def test_raw_plain_matches_pallas_kernel(scenes, kernel_raygen):
    ds, scene = scenes
    cfg, launch = _launch(scene, kernel_raygen)
    assert (launch.raymat is None) == kernel_raygen
    out, vis, elig = tile_trace.trace_raw(
        launch.ccand, launch.ccount, launch.centry, launch.frus,
        scene.cluster_unit_meta, scene.unit_qn, cfg, raymat=launch.raymat)
    assert out.shape == (launch.frus.shape[0], 4, 1024)
    # Padding rows of the pool: misses, nothing visited.
    pad = ~launch.row_valid
    assert bool(pad.any())
    assert bool((out[pad, 0] == BIG).all()) and not bool(out[pad, 1:].any())
    assert not bool(vis[pad].any()) and int((vis[~pad] > 0).sum()) >= 6
    assert bool((elig >= vis).all())
    _hold("raw", out, _jax_raw(ds, launch, kernel_raygen), vis)


def test_raw_compressed_plain_matches_pallas_kernel():
    mesh = jproc.make_icosphere(subdivisions=0, level=3, amplitude=0.12)
    ds = jscene.build_device_scene(mesh, compressed=True)
    scene = _port(ds)
    cfg, launch = _launch(scene, True)
    meta, tables, opts = tile_trace.scene_tables(scene)
    assert opts["compressed"]
    out, vis, _ = tile_trace.trace_raw(
        launch.ccand, launch.ccount, launch.centry, launch.frus, meta,
        tables, cfg, **opts)
    _hold("raw compressed", out, _jax_raw(ds, launch, True), vis)


def test_raw_equals_fresh_windowed_launch(scenes):
    """Raw with a ray-matrix input is the windowed mode started from
    fresh carries: bit for bit the same t, normals and counters. The rows
    given to trace_raw_plain come back alone."""
    _, scene = scenes
    cfg, launch = _launch(scene, False)
    args = (launch.ccand, launch.ccount, launch.centry, launch.frus)
    meta, tables = scene.cluster_unit_meta, scene.unit_qn
    out, vis, elig = tile_trace.trace_raw(*args, meta, tables, cfg,
                                          raymat=launch.raymat)
    n = launch.frus.shape[0]
    carry = (torch.full((n, 1024), BIG), torch.zeros((n, 3, 1024)),
             torch.zeros(n, dtype=torch.int32),
             torch.zeros(n, dtype=torch.int32))
    t, nrm, vis_w, elig_w = tile_trace.trace_windowed(
        *args, launch.raymat, carry, meta, tables, cfg)
    assert torch.equal(out[:, 0], t) and torch.equal(out[:, 1:4], nrm)
    assert torch.equal(vis, vis_w) and torch.equal(elig, elig_w)
    assert int(vis.sum()) > 0
    rows = [1, 3]
    part, pvis, _ = tile_trace.trace_raw_plain(
        *args, meta, tables, cfg, raymat=launch.raymat, rows=rows)
    assert torch.equal(part[rows], out[rows])
    assert torch.equal(pvis[rows], vis[rows])
    assert int(pvis.sum()) == int(vis[rows].sum())


def test_raw_wrapper_checks_its_pack(scenes):
    _, scene = scenes
    cfg, launch = _launch(scene, True)
    assert launch.frus.shape[1] == tiled.frustum_pack_len(
        cfg.sub_frusta, with_xform=True) == 128
    assert tiled.frustum_pack_len(8, with_raygen=True) == 128
    assert tiled.frustum_pack_len(8, with_xform=True) == 192
    with pytest.raises(ValueError):
        tile_trace.trace_raw(
            launch.ccand, launch.ccount, launch.centry,
            launch.frus[:, :64].contiguous(), scene.cluster_unit_meta,
            scene.unit_qn, cfg)
    with pytest.raises(TypeError):
        tile_trace.trace_raw(
            launch.ccand.long(), launch.ccount, launch.centry, launch.frus,
            scene.cluster_unit_meta, scene.unit_qn, cfg)
    cfg8 = dataclasses.replace(cfg, sub_frusta=8)
    with pytest.raises(ValueError):      # an 8-sub pack is 192 long
        tile_trace.trace_raw(
            launch.ccand, launch.ccount, launch.centry, launch.frus,
            scene.cluster_unit_meta, scene.unit_qn, cfg8)
