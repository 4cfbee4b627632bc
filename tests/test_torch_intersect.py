"""The port's intersectors (ops/intersect.py) against the JAX package's.

The hand-made cases are those of the JAX package's tests/test_intersect.py;
the seeded random batches put many lanes near every acceptance edge. The
port writes dot and cross products out by component and divides through
ops/_f32.py; XLA's CPU compiler may contract a*b+c into one rounding
(ROADMAP queue 3), so the two agree to the last bits, not bit for bit:
masks are equal except at lanes within 1e-5 of a threshold (measured in
float64), and t, normals and the 2D projection agree within 1e-6 relative
(to the magnitude of the operands, which bounds the cancellation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.ops import intersect as jint
from rtmm_tpu_torch.ops import intersect

torch.set_num_threads(1)

N = 20000
NEAR = 1e-5
RTOL = 1e-6


def _both(fn_name, *arrays):
    """Run the JAX and the port function on the same float32 arrays."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    ref = getattr(jint, fn_name)(*[jnp.asarray(a) for a in arrays])
    out = getattr(intersect, fn_name)(*[torch.from_numpy(a.copy())
                                        for a in arrays])
    if not isinstance(ref, tuple):
        ref, out = (ref,), (out,)
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


def _close(a, b, scale):
    """|a - b| <= RTOL * scale, lane by lane (scale: operand magnitude)."""
    err = np.abs(a.astype(np.float64) - b)
    assert (err <= RTOL * scale + 1e-30).all(), float((err / scale).max())


def _masks_equal(a, b, margin):
    """Equal except at lanes within NEAR of a threshold."""
    diff = a != b
    assert not (diff & (margin >= NEAR)).any(), int(diff.sum())
    return int(diff.sum())


def test_constants_match():
    for name in ("MAX_T", "EDGE_PARALLEL_EPS", "BAND_EPS", "MT_UV_EPS",
                 "MT_DET_EPS"):
        assert getattr(intersect, name) == getattr(jint, name)


@pytest.mark.parametrize("case", [
    # (origin, direction): a hit, a miss, a hit behind the origin
    ([0.25, 0.25, -1.0], [0.0, 0.0, 1.0]),
    ([2.0, 2.0, -1.0], [0.0, 0.0, 1.0]),
    ([0.25, 0.25, 1.0], [0.0, 0.0, 1.0]),
])
def test_moller_trumbore_cases(case):
    tri = ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    ref, out = _both("moller_trumbore", *case, *tri)
    assert bool(ref[0]) == bool(out[0])
    if bool(out[0]):
        np.testing.assert_array_equal(out[1], ref[1])
        np.testing.assert_array_equal(out[2], ref[2])


def test_ray_aabb_cases():
    o = [0.0, 0.0, -5.0]
    inv = 1.0 / np.array([1e-12, 1e-12, 1.0], np.float32)
    for lo, hi in (([-1.0] * 3, [1.0] * 3), ([1e30] * 3, [-1e30] * 3)):
        ref, out = _both("ray_aabb", o, inv, lo, hi)
        assert bool(ref[0]) == bool(out[0])
        np.testing.assert_array_equal(out[1], ref[1])


@pytest.mark.parametrize("edge", [
    ([2.0, -1.0], [2.0, 1.0]),        # crossed
    ([-2.0, -1.0], [-2.0, 1.0]),      # behind the origin
    ([0.0, 1.0], [5.0, 1.0]),         # parallel
])
def test_ray_edge_2d_cases(edge):
    ref, out = _both("ray_edge_2d", [0.0, 0.0], [1.0, 0.0], *edge)
    assert bool(ref[0]) == bool(out[0])
    np.testing.assert_array_equal(out[1], ref[1])


def test_node_test_height_band_cases():
    verts = [[[-1.0, -1.0], [3.0, -1.0], [1.0, 3.0]]]
    for band, inside in (([-0.1, 0.1], False), ([-0.1, 6.0], True)):
        ref, out = _both("node_test", [[-5.0, 0.5]], [[1.0, 0.0]], verts,
                         [band], [5.0], [0.0])
        assert bool(out[0][0]) == bool(ref[0][0]) == inside


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_moller_trumbore_random():
    rng = np.random.default_rng(7)
    v0, v1, v2 = (rng.uniform(-1, 1, size=(N, 3)) for _ in range(3))
    # Rays aimed at a random point of a slightly grown triangle: about
    # half the lanes hit, many within a few 1e-3 of an edge.
    b = rng.uniform(-0.1, 1.1, size=(N, 2))
    target = v0 + b[:, :1] * (v1 - v0) + b[:, 1:] * (v2 - v0)
    o = target - 3.0 * _unit(rng, N)
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    arrays = [x.astype(np.float32) for x in (o, d, v0, v1, v2)]
    ref, out = _both("moller_trumbore", *arrays)
    # Float64 u, v of the float32 inputs: the acceptance margins.
    o, d, v0, v1, v2 = (x.astype(np.float64) for x in arrays)
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    tv = o - v0
    u = (tv * p).sum(-1) / det
    v = (d * np.cross(tv, e1)).sum(-1) / det
    eps = intersect.MT_UV_EPS
    margin = np.min(np.abs([u + eps, u - 1 - eps, v + eps,
                            u + v - 1 - eps]), axis=0)
    flips = _masks_equal(ref[0], out[0], margin)
    both = ref[0] & out[0]
    assert both.sum() > N // 4
    nrm = lambda x: np.linalg.norm(x, axis=-1)
    # t = e2 . (tvec x e1) / det; n = e1 x e2 / |e1 x e2|.
    _close(out[1][both], ref[1][both],
           (nrm(e2) * nrm(tv) * nrm(e1) / np.abs(det))[both])
    _close(out[2], ref[2],
           (nrm(e1) * nrm(e2) / nrm(np.cross(e1, e2)))[:, None])
    print(f"{flips} mask flips of {N}")


def test_ray_aabb_random():
    rng = np.random.default_rng(8)
    o = rng.uniform(-3, 3, size=(N, 3))
    d = _unit(rng, N)
    d[::7, 0] = 0.0                               # axis-parallel lanes
    safe = np.where(np.abs(d) < 1e-12, 1e-12, d).astype(np.float32)
    inv = np.float32(1.0) / safe
    c = rng.uniform(-1, 1, size=(N, 3))
    ext = rng.uniform(0.01, 1.0, size=(N, 3))
    lo, hi = c - ext, c + ext
    lo[::11], hi[::11] = 1e30, -1e30              # padding sentinels
    ref, out = _both("ray_aabb", o, inv, lo, hi)
    # Slab products round once on both sides: bit-equal.
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    assert 0 < ref[0].sum() < N


def test_ray_edge_and_node_test_random():
    rng = np.random.default_rng(9)
    o2 = rng.uniform(-2, 2, size=(N, 2))
    ang = rng.uniform(0, 2 * np.pi, size=N)
    d2 = np.stack([np.cos(ang), np.sin(ang)], -1)
    verts = rng.uniform(-1.5, 1.5, size=(N, 3, 2))
    mm = np.sort(rng.uniform(-0.3, 0.3, size=(N, 2)), axis=-1)
    h0 = rng.uniform(-0.5, 0.5, size=N)
    hs = rng.uniform(-0.2, 0.2, size=N)
    arrays = [x.astype(np.float32) for x in (o2, d2, verts, mm, h0, hs)]
    o2, d2, verts, mm, h0, hs = (x.astype(np.float64) for x in arrays)
    margins = []
    ts = []
    for i, j in ((0, 1), (1, 2), (2, 0)):
        ref, out = _both("ray_edge_2d", arrays[0], arrays[1],
                         arrays[2][:, i], arrays[2][:, j])
        v1, v2 = o2 - verts[:, i], verts[:, j] - verts[:, i]
        v3 = np.stack([-d2[:, 1], d2[:, 0]], -1)
        den = (v2 * v3).sum(-1)
        t1 = (v2[:, 0] * v1[:, 1] - v2[:, 1] * v1[:, 0]) / den
        t2 = (v1 * v3).sum(-1) / den
        m = np.min(np.abs([np.abs(den) - intersect.EDGE_PARALLEL_EPS,
                           t1, t2, t2 - 1.0]), axis=0)
        _masks_equal(ref[0], out[0], m)
        both = ref[0] & out[0]
        _close(out[1][both], ref[1][both],
               (np.abs(v2).sum(-1) * np.abs(v1).sum(-1)
                / np.abs(den))[both] + 1.0)
        margins.append(m)
        ts.append(np.where(ref[0], t1, -1.0))
    # node_test: the edge margins, and the band's: heights at entry/exit
    # against the min/max, and |entry - exit| against BAND_EPS.
    ts = np.stack(ts, -1)
    entry = np.where(ts < 0, intersect.MAX_T, ts).min(-1)
    exit_ = ts.max(-1)
    band = np.min(np.abs([h0 + entry * hs - mm[:, 0],
                          h0 + entry * hs - mm[:, 1],
                          h0 + exit_ * hs - mm[:, 0],
                          h0 + exit_ * hs - mm[:, 1],
                          np.abs(entry - exit_) - intersect.BAND_EPS]),
                  axis=0)
    ref, out = _both("node_test", *arrays)
    flips = _masks_equal(ref[0], out[0],
                         np.minimum(np.min(margins, 0), band))
    assert 0 < ref[0].sum() < N
    print(f"{flips} node_test flips of {N}")


def test_project_ray_2d_random():
    rng = np.random.default_rng(10)
    o = rng.normal(size=(N, 3))
    d = _unit(rng, N)
    pn = _unit(rng, N)
    pt = np.cross(pn, _unit(rng, N))
    pt /= np.linalg.norm(pt, axis=-1, keepdims=True)
    pb = np.cross(pn, pt)
    po = rng.normal(size=(N, 3))
    arrays = [x.astype(np.float32) for x in (o, d, pt, pb, pn, po)]
    ref, out = _both("project_ray_2d", *arrays)
    rel = np.abs(o).sum(-1) + np.abs(po).sum(-1) + 1.0
    lp = np.linalg.norm(np.stack([(d * pt).sum(-1), (d * pb).sum(-1)], -1),
                        axis=-1)
    _close(out[0], ref[0], rel[:, None])
    _close(out[1], ref[1], 1.0 / np.maximum(lp, 1e-12)[:, None])
    _close(out[2], ref[2], rel)
    _close(out[3], ref[3], 1.0 / np.maximum(lp, 1e-12))
