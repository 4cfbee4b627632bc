"""The tile trace's plain version (ops/tile_trace.py on CPU tensors) sums
only the det column's non-zero terms (DET_ROWS = 3, the d rows), as the
Hopper kernel does; this file holds it to the full six-row contraction,
which it keeps as the reference, without JAX:

  (a) on seeded cameras over a subdivision-1 level-3 icosphere with
      precomputed and with compressed tables and a level-2 plane with
      indexed compressed records, through a ray matrix (the raw mode) and
      through the in-kernel raygen (the fused mode): t, normals, pixels
      and the per-tile counts are equal bit for bit;
  (b) a crafted tile whose det partial sum is exactly -0: a collinear
      (zero-area) leaf has n = +0, so its det entries are -0, and a ray
      with positive direction components sums three -0 products to -0,
      where the six-row sum adds a +0 moment product and gives +0. The
      sign flips 1/det from -inf to +inf and with it every quotient, but
      the leaf is rejected in both (its u, v and w numerators sum to 0,
      so min(u, v, w) is -inf either way, and its t numerator is -0, so
      p is NaN), and the walk's outputs are equal.
"""
import functools

import numpy as np
import pytest
import torch

from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import culling, tiled, tile_trace
from rtmm_tpu_torch.utils import camera

torch.set_num_threads(1)

SCENES = {
    "icosphere": (lambda: procedural.make_icosphere(
        subdivisions=1, level=3, amplitude=0.15), False),
    "icosphere_compressed": (lambda: procedural.make_icosphere(
        subdivisions=1, level=3, amplitude=0.15), True),
    "plane_indexed": (lambda: procedural.make_plane(
        grid=(4, 4), level=2, amplitude=0.2), True),
}


@functools.lru_cache(maxsize=None)
def _scene(name):
    make, comp = SCENES[name]
    return scene_mod.build_device_scene(make(), compressed=comp,
                                        device="cpu")


def _ivp(w, h, seed):
    rng = np.random.default_rng(seed)
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(rng.uniform(-50.0, 50.0)),
                              np.radians(rng.uniform(0.0, 360.0)), 0.0],
                  float(rng.uniform(2.5, 3.5)))
    return camera.inv_view_proj(tb, w, h)


def _launches(scene, mode):
    """The plain call of one seeded frame of 96x64 pixels with 8 sub-cones
    in 2 rows: the raw mode on the frame's ray matrix, or the fused mode
    with the in-kernel raygen."""
    cfg = RenderConfig(width=96, height=64, sub_frusta=8, sub_rows=2)
    ivp = _ivp(96, 64, seed=11 if mode == "raw" else 12)
    meta, tables, opts = tile_trace.scene_tables(scene)
    kc = tile_trace.clusters_per_window(scene, cfg)
    if mode == "raw":
        fi, frus, raymat = tile_trace.ray_frame_inputs(scene, ivp, cfg)
        lists = tile_trace.cluster_lists(scene, fi, kc)
        return lambda: tile_trace.trace_raw_plain(
            *lists, frus, meta, tables, cfg, raymat=raymat, **opts)
    rows = tile_trace.frame_inputs(scene, ivp, cfg, kc)
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    tx = pw // culling.TILE_W
    return lambda: tile_trace.trace_fused_plain(
        *rows, meta, tables, cfg, tiles_per_frame=tx * (ph // 32), tx=tx,
        pw=pw, ph=ph, **opts)


@pytest.mark.parametrize("mode", ["raw", "fused"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_det_rows_match_full_contraction(name, mode, monkeypatch):
    run = _launches(_scene(name), mode)
    three = run()
    assert tile_trace.DET_ROWS == 3
    assert int(three[1].sum()) > 0
    if mode == "raw":
        assert int((three[0][:, 0] < 1e29).sum()) > 300
    monkeypatch.setattr(tile_trace, "DET_ROWS", 6)
    six = run()
    assert len(three) == len(six) == 3
    for a, b in zip(three, six):
        assert torch.equal(a, b)


def _leaf_tables(v0, v1, v2, c, apex):
    """One unit's plain-walk tables (qd, qu, qv (6, LPU), t_num (LPU,),
    nrm (3, LPU)) from its leaves' corners (LPU, 3), recentered on c, in
    the float32 operations and order of compressed.derive_unit_tables."""
    e1, e2, v0c = v1 - v0, v2 - v0, v0 - c

    def cross(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)

    n, w1, w2 = cross(e1, e2), cross(e2, v0c), cross(v0c, e1)
    e2w2 = e2[:, 0] * w2[:, 0] + e2[:, 1] * w2[:, 1] + e2[:, 2] * w2[:, 2]
    ac = apex - c
    tn = ac[0] * n[:, 0] + ac[1] * n[:, 1] + ac[2] * n[:, 2] - e2w2
    zero = np.zeros_like(n)
    qd = np.concatenate([-n, zero], axis=1).T
    qu = np.concatenate([-w1, e2], axis=1).T
    qv = np.concatenate([-w2, -e1], axis=1).T
    norm = np.maximum(np.sqrt((n * n).sum(1)), np.float32(1e-20))
    t = (torch.from_numpy(np.ascontiguousarray(x, np.float32))
         for x in (qd, qu, qv, tn, (n / norm[:, None]).T))
    return tuple(t)


def test_signed_zero_det_is_inert(monkeypatch):
    f32 = np.float32
    lpu, tile = tile_trace.LPU, tile_trace.TILE
    # Leaves on the plane z = 0 around (0.5, 0.5): leaf 0 collinear (zero
    # area: e1 x e2 is +0 in every component), the others small triangles
    # on an 8x8 grid.
    g = (np.arange(lpu) % 8).astype(f32), (np.arange(lpu) // 8).astype(f32)
    v0 = np.stack([0.1 * g[0] + 0.1, 0.1 * g[1] + 0.1, 0 * g[0]], 1)
    v0 = v0.astype(f32)
    v1 = (v0 + np.array([0.08, 0.0, 0.0], f32)).astype(f32)
    v2 = (v0 + np.array([0.0, 0.08, 0.0], f32)).astype(f32)
    v2[0] = v0[0] + np.array([0.16, 0.0, 0.0], f32)
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    c = (f32(0.5) * (lo + hi)).astype(f32)
    apex = np.array([-0.5, -0.5, -2.0], f32)
    tabs = _leaf_tables(v0, v1, v2, c, apex)
    assert not np.signbit(-tabs[0][0:3, 0].numpy()).any()   # n = +0

    # 1,024 rays from the apex towards the leaves' corners: every
    # direction component is positive.
    rng = np.random.default_rng(3)
    target = v0[rng.integers(0, lpu, tile)] + rng.uniform(
        0.0, 0.05, (tile, 3)).astype(f32) * np.array([1, 1, 0], f32)
    d = (target - apex).astype(f32)
    d = (d / np.sqrt((d * d).sum(1, keepdims=True))).astype(f32)
    m = np.cross(np.broadcast_to(apex, d.shape), d).astype(f32)
    rays = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        d[:, 0], d[:, 1], d[:, 2], m[:, 0], m[:, 1], m[:, 2],
        np.zeros(tile, f32)))
    assert (d > 0).all()

    # Leaf 0's det per ray in both sums, over the recentered moment.
    cx, cy, cz = (torch.tensor(x) for x in c)
    dx, dy, dz, mx, my, mz, _ = rays
    rows = (dx, dy, dz, mx - (cy * dz - cz * dy), my - (cz * dx - cx * dz),
            mz - (cx * dy - cy * dx))
    qd = tabs[0][:, 0]
    det3 = qd[0] * rows[0] + qd[1] * rows[1] + qd[2] * rows[2]
    det6 = det3 + qd[3] * rows[3] + qd[4] * rows[4] + qd[5] * rows[5]
    flip = (torch.signbit(det3) & ~torch.signbit(det6) & (det3 == 0))
    # Every ray sums three -0 products to -0; the six-row sum is +0 where
    # a moment product is +0, and 1/det flips from -inf to +inf.
    assert bool((det3 == 0).all()) and bool(torch.signbit(det3).all())
    assert int(flip.sum()) > 100
    assert bool((1.0 / det3[flip] == -np.inf).all())
    assert bool((1.0 / det6[flip] == np.inf).all())
    # What the sign does: every quotient flips with it, but the leaf is
    # rejected either way. Its u, v and w numerators sum to det = 0, so
    # they never share a sign and min(u, v, w) is -inf in both sums; and
    # its t numerator is -0, so p = t_num / det is NaN in both.
    q = [b[:, 0] for b in tabs[:3]]
    qw = (q[0] - q[1]) - q[2]
    num = [sum((b[r] * rows[r] for r in range(1, 6)), b[0] * rows[0])
           for b in (q[1], q[2], qw)]
    for det in (det3, det6):
        iv = 1.0 / det
        quot = torch.stack([x * iv for x in num])
        assert bool((quot.amin(0)[flip] == -np.inf).all())
        assert bool(torch.isnan(tabs[3][0] * iv).all())
    assert bool((torch.sign(num[0] / det3) == -torch.sign(num[0] / det6))
                [flip].all())

    # One cluster of one valid unit, its AABB the leaves' box; a pack
    # whose sub-cone planes (all zero) keep the unit inside, and a scene
    # box around everything.
    meta = torch.zeros((1, 8, 128))
    meta[0, 0:3, 0] = torch.from_numpy(lo)
    meta[0, 3:6, 0] = torch.from_numpy(hi)
    meta[0, 6, 0] = 1.0
    fr = torch.zeros(3 + 12 + 6)
    fr[0:3] = torch.from_numpy(apex)
    fr[15:18] = -10.0
    fr[18:21] = 10.0
    cfg = RenderConfig()

    def walk():
        return tile_trace._trace_tile_plain(
            fr, rays, False, torch.tensor([0]), torch.tensor([0.0]), 1,
            meta, lambda cl, crow: (lambda u: tabs), cfg, 1,
            tile_trace._sub_masks(1, 1, "cpu"),
            torch.arange(128, dtype=torch.int32),
            (torch.full((tile,), tile_trace.BIG), [torch.zeros(tile)] * 3,
             0, 0))

    three = walk()
    monkeypatch.setattr(tile_trace, "DET_ROWS", 6)
    six = walk()
    bt, bn, nv, ne = three
    assert (nv, ne) == (1, 1) == six[2:]
    assert torch.equal(bt, six[0])
    for a, b in zip(bn, six[1]):
        assert torch.equal(a, b)
    # The rays hit the other leaves, and none takes the collinear one
    # (its normal is 0: a take of it alone would leave a zero normal).
    hit = bt < 1e29
    assert int(hit.sum()) > 800
    norm = bn[0] * bn[0] + bn[1] * bn[1] + bn[2] * bn[2]
    assert bool((norm[hit] > 0.5).all())
