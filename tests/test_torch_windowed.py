"""Windowed frames: the port against render_pallas's windowed branch.

A scene with more clusters than kernel_clusters_per_window is traced in
cluster windows: each window takes the next kc nearest clusters of every
tile, and the trace carries the running best hit from window to window.
The JAX reference is render_pallas in interpret mode at
mt_precision="highest" on the very same tables (scene_from_arrays); the
port runs the plain version of its windowed kernel (the CPU path of
trace_windowed). Per-tile visit and eligible counts must be equal, and the
images pass the two-tier gate with max |diff| <= 1e-5.
"""
import numpy as np
import pytest
import torch

from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.ops import tiled, tile_trace
from rtmm_tpu_torch.utils.gate import image_gate
from test_torch_trace import _ivp, _render_reference

# One intra-op thread (see tests/test_torch_trace.py).
torch.set_num_threads(1)

# name -> (icosphere subdivisions, level, width, height,
# kernel_clusters_per_window)
WINDOWED = {
    "icosphere1_level3_kc1": (1, 3, 256, 64, 1),    # 2 clusters, 2 windows
    "icosphere2_level3_kc2": (2, 3, 128, 64, 2),    # 5 clusters, 3 windows
}


@pytest.fixture(scope="module")
def reference():
    """name -> (port scene, JAX image, JAX visits, JAX eligible)."""
    return {name: _render_reference(*args)
            for name, args in WINDOWED.items()}


@pytest.mark.parametrize("name", sorted(WINDOWED))
def test_windowed_frame_matches_pallas_kernel(reference, name):
    scene, img0, vis0, elig0 = reference[name]
    _, _, w, h, kc = WINDOWED[name]
    cfg = RenderConfig(width=w, height=h, kernel_clusters_per_window=kc)
    img, st = tile_trace.render_frame(scene, _ivp(w, h), cfg,
                                      with_stats=True)
    vis = st["kernel_unit_visits"].numpy()
    print(f"{name}: {st['windows']} windows, visits {vis.tolist()}")
    assert st["windows"] > 1
    np.testing.assert_array_equal(vis, vis0)
    np.testing.assert_array_equal(st["kernel_unit_eligible"].numpy(), elig0)
    gate = image_gate(img, torch.from_numpy(img0))
    print(f"{name}: {gate}")
    assert gate["ok"], gate
    assert gate["maxdiff"] <= 1e-5, gate


def test_windowed_walk_carries_counters(reference):
    """Window by window through trace_windowed: the counters accumulate,
    a tile with no cluster left passes its carry through unchanged, and
    the last window's carry is the frame's."""
    scene = reference["icosphere2_level3_kc2"][0]
    cfg = RenderConfig(width=128, height=64, kernel_clusters_per_window=2)
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene, _ivp(128, 64), cfg)
    meta, tables, opts = tile_trace.scene_tables(scene)
    n = frus.shape[0]
    carry = (torch.full((n, 1024), tile_trace.BIG),
             torch.zeros((n, 3, 1024)), torch.zeros(n, dtype=torch.int32),
             torch.zeros(n, dtype=torch.int32))
    remaining = fi.cluster_hit
    totals = []
    while bool(remaining.any()):
        ccand, ccount, centry, remaining, _ = tiled.cluster_window(
            scene, fi.apex, remaining, 2)
        new = tile_trace.trace_windowed(ccand, ccount, centry, frus, raymat,
                                        carry, meta, tables, cfg, **opts)
        idle = ccount == 0
        assert torch.equal(new[0][idle], carry[0][idle])
        assert torch.equal(new[2][idle], carry[2][idle])
        assert bool((new[2] >= carry[2]).all())
        carry = new
        totals.append(int(carry[2].sum()))
    assert len(totals) >= 3 and totals == sorted(totals)
    _, st = tile_trace.render_frame(scene, _ivp(128, 64), cfg,
                                    with_stats=True)
    # The frame's window loop stops tiles early (worst bound below the next
    # window's entry), so it visits no more than walking every window.
    assert int(st["kernel_unit_visits"].sum()) <= totals[-1]
