"""The benchmark's deployment-sized cell, plane1m-orbit, at a size the CPU
draws in seconds: the plane base, the culled reference against the
all-pairs oracle bit for bit, the cell through the renderer's plain
versions (correct, windowed compressed traces only), the bfloat16
control and the output faults judged incorrect, the window loop's span,
and the cell's per-layer readers on synthetic counters and records."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench import check, faults, harness, runner, scene
from rtbench.reference import culled, geometry, shading
from rtbench.reference.raycast import RayCaster
from rtmm_tpu_torch.ops import tile_trace
from rtmm_tpu_torch.utils import spans

torch.set_num_threads(1)

CELL = "plane1m-orbit"
# The cell cut for the CPU: 96x64 frames, a 12x12 level-2 plane (2
# clusters), windows of one cluster, so a frame takes two.
TRAFFIC = {"width": 96, "height": 64, "check_per_frame": 512,
           "clusters_per_window": 1}
RECIPE = {"grid": 12, "level": 2}
LOOP = "rtmm.tile_trace.trace_windows"


def tiny_cell():
    cell = harness.Cell(CELL)
    cell.traffic.update(TRAFFIC)
    cell.config["recipe"].update(RECIPE)
    return cell


def test_plane_base():
    """The base is the square [-1, 1]^2 of y = 0, faces wound +y, in the
    order of the per-square loop."""
    grid = 5
    base = harness.base_arrays({"base": "plane_y0", "grid": grid})
    pos, faces = base["positions"], base["faces"]
    xs = np.linspace(-1.0, 1.0, grid + 1)
    want_pos = np.array([[x, 0.0, z] for x in xs for z in xs], np.float32)
    want = []
    for i in range(grid):
        for j in range(grid):
            a, b = i * (grid + 1) + j, (i + 1) * (grid + 1) + j
            want += [[a, a + 1, b + 1], [a, b + 1, b]]
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_array_equal(faces, np.asarray(want, np.int64))
    assert faces.dtype == np.int64 and pos.dtype == np.float32
    p0, p1, p2 = (pos[faces[:, k]] for k in range(3))
    assert (np.cross(p1 - p0, p2 - p0)[:, 1] > 0).all()
    np.testing.assert_array_equal(base["normals"],
                                  np.tile(np.float32([0, 1, 0]), (36, 1)))


def _rays(arrays, seed):
    """Seeded rays: from above at random points of the tile, grazing ones
    at the tile's heights, ones aimed at micro-vertices and micro-edge
    midpoints (shared by neighbouring micro-triangles and bases), and
    ones whose hit lies T_MIN along them."""
    rng = np.random.default_rng(seed)
    verts = arrays["vertices"]
    tris = arrays["triangles"]

    def from_above(targets):
        n = len(targets)
        o = np.c_[rng.uniform(-2, 2, n), rng.uniform(0.4, 2.5, n),
                  rng.uniform(-2, 2, n)]
        d = targets - o
        return o, d / np.linalg.norm(d, axis=1, keepdims=True)

    n = 200
    o1, d1 = from_above(np.c_[rng.uniform(-1.1, 1.1, n),
                              rng.uniform(-0.1, 0.1, n),
                              rng.uniform(-1.1, 1.1, n)])
    o2 = np.c_[rng.uniform(-1.5, 1.5, n), rng.uniform(-0.08, 0.08, n),
               rng.uniform(-1.5, 1.5, n)]
    d2 = np.c_[rng.normal(size=n), rng.normal(scale=2e-3, size=n),
               rng.normal(size=n)]
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o3, d3 = from_above(verts[rng.integers(0, len(verts), n)])
    pick = tris[rng.integers(0, len(tris), n)]
    k = rng.integers(0, 3, n)
    rows = np.arange(n)
    o4, d4 = from_above(0.5 * (verts[pick[rows, k]]
                               + verts[pick[rows, (k + 1) % 3]]))
    tgt = verts[rng.integers(0, len(verts), n)]
    _, d5 = from_above(tgt)
    o5 = tgt - shading.T_MIN * d5 * rng.choice([0.999, 1.0, 1.001], (n, 1))
    o = np.concatenate([o1, o2, o3, o4, o5]).astype(np.float32)
    d = np.concatenate([d1, d2, d3, d4, d5]).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _bits(x):
    x = x.contiguous()
    if x.dtype == torch.bool:
        return x
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


SCENES = [(8, 2, 0.1), (10, 3, 0.05)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("grid, level, amplitude", SCENES,
                         ids=[f"plane{g}-l{lv}" for g, lv, _ in SCENES])
def test_culled_equals_oracle(grid, level, amplitude, dtype):
    """t, hit and normal bit for bit, over the whole t window and over a
    window whose ends are the oracle's own hit distances."""
    recipe = {"base": "plane_y0", "grid": grid, "level": level,
              "amplitude": amplitude, "phase": [0.3, 0, 0, 0]}
    arrays = geometry.scene_arrays(recipe, harness.base_arrays(recipe))
    o, d = _rays(arrays, grid * 7 + level)
    oracle = RayCaster(arrays["vertices"], arrays["triangles"], "cpu", dtype)
    cull = culled.CulledCaster(oracle, level, slab_elems=1 << 14,
                               pair_elems=1 << 12)
    want = oracle.cast(o, d, shading.T_MIN, shading.T_MAX)
    assert int(want[1].sum()) > o.shape[0] // 3
    got = cull.cast(o, d, shading.T_MIN, shading.T_MAX)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    hit_t = want[0][want[1]].float().sort().values
    lo, hi = (float(hit_t[int(q * (len(hit_t) - 1))]) for q in (0.3, 0.7))
    want = oracle.cast(o, d, lo, hi)
    got = cull.cast(o, d, lo, hi)
    for w, g in zip(want, got):
        assert torch.equal(_bits(g), _bits(w))
    at_ends = (want[0] == torch.tensor(lo, dtype=dtype)) | (
        want[0] == torch.tensor(hi, dtype=dtype))
    assert int(at_ends.sum()) >= 2


@pytest.fixture(scope="module")
def sound():
    """The tiny cell's run, with the plain trace versions' calls counted
    by mode."""
    calls: dict = {}
    saved = {}
    for name in ("trace_fused_plain", "trace_windowed_plain",
                 "trace_raw_plain"):
        saved[name] = orig = getattr(tile_trace, name)

        def counted(*a, _orig=orig, _name=name, **k):
            key = (_name, bool(k.get("compressed")))
            calls[key] = calls.get(key, 0) + 1
            return _orig(*a, **k)
        setattr(tile_trace, name, counted)
    try:
        cell = tiny_cell()
        res = runner.run_cell(cell, 2**31 + 17, 0.1, False, "cpu")
    finally:
        for name, fn in saved.items():
            setattr(tile_trace, name, fn)
    return cell, res, calls


def test_tiny_cell_is_correct_and_windowed(sound):
    cell, res, calls = sound
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["check"]) == set(cell.limits)
    drv = res["_run"].driver
    assert set(calls) == {("trace_windowed_plain", True)}
    assert calls["trace_windowed_plain", True] >= 2 * drv.rendered
    assert drv.cfg.kernel_clusters_per_window == 1
    covered = (res["_want"].to(torch.int32) != 74).any(-1)
    assert int(covered.sum()) > len(covered) // 20


def test_control_is_judged_incorrect(sound):
    cell, res, _ = sound
    low, ok = check.control(res["_run"].driver, res["_drawn"],
                            scene.reference_arrays(cell), "cpu",
                            res["_want"], res["_subsets"], cell.limits)
    assert not ok, low


@pytest.mark.parametrize("fault", faults.OUTPUT)
def test_fault_is_judged_incorrect(monkeypatch, fault):
    """The orbit entry's output faults, planted on render_frames, which
    the cell's driver calls."""
    faults.plant(fault, "orbit", monkeypatch.setattr)
    res = runner.run_cell(tiny_cell(), 77, 0.1, False, "cpu")
    assert res["correct"] is False, res["check"]


def test_one_loop_span_per_windowed_frame():
    """render_frames of two frames: one trace_windows span a frame, every
    cluster_window sync and windowed launch span nested in one."""
    cell = tiny_cell()
    sc = scene.device_scene(cell, 0, "cpu")
    drv = cell.driver()(cell, 0, sc, "cpu")
    ivps = np.concatenate([drv.cameras(0), drv.cameras(3)])
    spans.take()
    with spans.on():
        tile_trace.render_frames(sc, torch.from_numpy(ivps), drv.cfg)
    recs = spans.take()
    by_id = {r.id: r for r in recs}
    loops = [r for r in recs if r.name == LOOP]
    assert len(loops) == 2

    def loop_of(r):
        up = by_id.get(r.parent)
        while up is not None and up.name != LOOP:
            up = by_id.get(up.parent)
        return up

    for name in ("rtmm.tiled.cluster_window",
                 "rtmm.tile_trace.trace_windowed"):
        inner = [r for r in recs if r.name == name]
        assert inner and all(loop_of(r) in loops for r in inner)
    for lp in loops:
        windows = sum(r.name == "rtmm.tile_trace.trace_windowed"
                      and loop_of(r) is lp for r in recs)
        syncs = [r for r in recs if r.sync and loop_of(r) is lp]
        assert windows == 2 and len(syncs) == windows + 1
        assert all(r.name == "rtmm.tiled.cluster_window" for r in syncs)
        assert all(lp.start_ns <= r.start_ns <= r.end_ns <= lp.end_ns
                   for r in syncs)


class _Run:
    def __init__(self, **kw):
        self.device = torch.device("cpu")
        self.scene = self.driver = None
        self.__dict__.update(kw)


def _record(rid, name, parent, start, end, sync=False):
    r = spans.Record()
    r.id, r.name, r.parent, r.frame = rid, name, parent, 1
    r.start_ns, r.end_ns, r.events, r.sync = start, end, None, sync
    return r


def test_plane_readers():
    cell = harness.Cell(CELL)
    per_frame = cell.reader("windows_per_frame.plane")
    run = _Run(frames=4, launches={"tile_trace_windowed_compressed": 9,
                                   "cluster_select": 9})
    assert per_frame.read(run, "windows_per_frame.plane") == 2.25
    assert per_frame.read(_Run(frames=4, launches={"tile_trace_fused": 4}),
                          "windows_per_frame.plane") is None
    host = cell.reader("window_host_ms.plane")
    ms = 1_000_000
    records = [
        _record(1, "rtmm.tile_trace.render_frames", None, 0, 20 * ms),
        _record(2, LOOP, 1, 1 * ms, 11 * ms),
        _record(3, "rtmm.tiled.cluster_window", 2, 2 * ms, 5 * ms, True),
        _record(4, "rtmm.tile_trace.trace_windowed", 2, 5 * ms, 6 * ms),
        _record(5, "rtmm.tiled.cluster_window", 2, 6 * ms, 7 * ms, True),
        _record(6, "rtmm.tiled.some_inner", 4, 5 * ms, 6 * ms),
        _record(7, "rtmm.inner_sync", 6, 5 * ms, 5 * ms + ms // 2, True),
        _record(8, "rtmm.tiled.elsewhere", 1, 12 * ms, 13 * ms, True),
        _record(9, LOOP, None, 30 * ms, 31 * ms),
        _record(10, LOOP, None, 40 * ms, 44 * ms),
    ]
    # Loops: 10 - 3 - 1 - 0.5 = 5.5 ms, 1 ms and 4 ms; the sync outside
    # them counts for none.
    assert host.own_ms(records) == 4.0
    assert host.own_ms(records[:8]) == 5.5
    assert host.own_ms(records[:1]) is None
    assert host.read(_Run(program_spans={"records": records[:8]}),
                     "window_host_ms.plane") == 5.5
    assert host.read(_Run(program_spans=None), "window_host_ms.plane") \
        is None
    roof = cell.reader("k1bc_roofline.plane")
    assert roof.read(_Run(), "k1bc_roofline.plane") is None
