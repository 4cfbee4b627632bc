"""Instancing, the exactness backstop and the serial scan: a merged launch
whose row pool overflows re-runs the truncated instances through the
serial full-frame pass, and the serial scan's gathered-tile window agrees
with tracing every tile. Against rtmm_tpu.render.instances at the sizes
and pixel budgets of tests/test_instances.py (see
tests/test_torch_instances.py for the tolerances' reasons).
"""
import dataclasses

import numpy as np
import torch

from rtmm_tpu.render import instances as jinst
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.render import instances as inst_mod
from test_torch_instances import _covered, _ivp, _jax_image, _npix, base  # noqa: F401

# One intra-op thread (see tests/test_torch_trace.py).
torch.set_num_threads(1)


def test_forced_overflow_matches_jax(base):
    """tests/test_instances.py::test_merged_instanced_overflow_backstop:
    a close-up instance over a pool of 2 rows per instance re-runs through
    the serial pass; <= 5 pixels over 1e-4 against JAX and against the
    default pool."""
    ds, scene = base
    ring = [jinst.Instance.identity(),
            jinst.Instance.from_euler([1.4, 0.0, 0.0], (0, 0, 0), 0.3)]
    w, h = 128, 64
    ivp = _ivp(w, h, -25.0, 30.0, 1.8)
    ref = _jax_image(ds, ring, ivp, w, h, instance_tile_cap=2)
    cfg = RenderConfig(width=w, height=h, instance_tile_cap=2)
    world = inst_mod.world_frame(ivp, cfg, "cpu")
    launch = inst_mod.merged_launch_inputs(
        scene, *inst_mod.instance_tensors(ring, "cpu"), ivp, world, cfg)
    assert launch.overflow.tolist() == [True, True]
    capped = inst_mod.render_instanced(scene, ring, ivp, cfg)
    full = inst_mod.render_instanced(
        scene, ring, ivp, dataclasses.replace(cfg, instance_tile_cap=0))
    for name, other in (("JAX capped", ref), ("default pool", full)):
        npix, worst = _npix(capped, other, 1e-4)
        print(f"capped vs {name}: {npix} px over 1e-4, max {worst:.3g}")
        assert npix <= 5, (name, npix, worst)
    assert _covered(capped, cfg) > 0.1


def test_serial_compaction_matches_full(base):
    """The serial scan's gathered-tile window (instances under the cap)
    and its full-frame branch (the close-up instance over it) agree with
    the scan that traces every tile of every instance."""
    _, scene = base
    ring = [jinst.Instance.identity(),
            jinst.Instance.from_euler([1.4, 0.9, 0.3], (0.2, 0.5, 0.1), 0.35),
            jinst.Instance.from_euler([-1.2, -0.8, -0.2], (0.1, 0.2, 0.4),
                                      0.3)]
    w, h = 128, 64
    ivp = _ivp(w, h, -40.0, 15.0, 3.5)
    cfg = RenderConfig(width=w, height=h, instance_tile_cap=10**9)
    assert inst_mod._tile_cap(cfg, 8) == 8
    assert inst_mod._tile_cap(dataclasses.replace(cfg, instance_tile_cap=0),
                              2040) == 255
    a = inst_mod.render_instanced(scene, ring, ivp, cfg, serial=True)
    b = inst_mod.render_instanced(
        scene, ring, ivp, dataclasses.replace(cfg, instance_tile_cap=3),
        serial=True)
    npix, worst = _npix(a, b, 1e-4)
    assert npix <= 5, (npix, worst)
    assert _covered(a, cfg) > 0.02
