"""The grouped trace's plain version (ops/group_trace.py on CPU tensors)
on the three facts the Hopper kernel's test step rests on, without JAX:

  (a) summing only the unit table's non-zero terms (TERM_ROWS) gives the
      t, normals and counts of the full 10-row contraction, which this
      file keeps as the reference;
  (b) a lane whose running best is at or below t_min is inert: it comes
      out unchanged, and its ray rows change nothing else (no output, no
      visit, no gated sub-group), so the kernel may skip it;
  (c) `tests` counts the lanes of the gated sub-groups above t_min at
      every visit, checked against a brute-force count.

Inputs are seeded random ray groups (origins in [-2, 2]^3, unit
directions) built by the port's own group_inputs, over the scenes of
tests/test_torch_group_trace.py: a subdivision-1 level-3 icosphere with
precomputed and with compressed tables, and a level-2 plane with indexed
compressed records. Every comparison is exact.
"""
import functools

import numpy as np
import pytest
import torch

from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import group_trace

torch.set_num_threads(1)

SCENES = {
    "icosphere": (lambda: procedural.make_icosphere(
        subdivisions=1, level=3, amplitude=0.15), False),
    "icosphere_compressed": (lambda: procedural.make_icosphere(
        subdivisions=1, level=3, amplitude=0.15), True),
    "plane_indexed": (lambda: procedural.make_plane(
        grid=(4, 4), level=2, amplitude=0.2), True),
}
# The reference of (a): every block summed over all ten ray rows.
FULL_ROWS = ((0, 10),) * 5
CFG = RenderConfig(width=48, height=32)


@functools.lru_cache(maxsize=None)
def _scene(name):
    make, comp = SCENES[name]
    return scene_mod.build_device_scene(make(), compressed=comp,
                                        device="cpu")


def _rays(live_frac, g=2, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 2.0, (g, 1024, 3)).astype(np.float32)
    d = rng.normal(size=(g, 1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    live = rng.uniform(size=(g, 1024)) < live_frac
    return tuple(torch.from_numpy(x) for x in (o, d, live))


def _launch(scene, o, d, live):
    """One window holding every cluster: (args, options) of trace_group
    with live lanes at BIG and dead ones at 0."""
    rv, box, _, omin, omax, cl_hit = group_trace.group_inputs(
        scene, o, d, live, CFG)
    lists = group_trace._grouped_cluster_window(scene, omin, omax, cl_hit,
                                                scene.num_clusters)[:3]
    meta, tables, nrm, opts = group_trace.scene_tables(scene)
    t_in = torch.where(live, group_trace.BIG, 0.0).to(torch.float32)
    n_in = torch.zeros((o.shape[0], 3, 1024))
    return [rv, box, *lists, t_in, n_in, meta, tables, nrm, CFG], opts


def _equal(a, b):
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", ["icosphere", "icosphere_compressed"])
def test_term_rows_match_full_contraction(name, monkeypatch):
    args, opts = _launch(_scene(name), *_rays(0.6))
    out = group_trace.trace_group(*args, **opts)
    assert int(out[2].sum()) > 0 and int((out[0] < 1e29).sum()) > 600
    monkeypatch.setattr(group_trace, "TERM_ROWS", FULL_ROWS)
    _equal(out, group_trace.trace_group(*args, **opts))


@pytest.mark.parametrize("start", ["zero", "t_min"])
@pytest.mark.parametrize("name", ["icosphere", "plane_indexed"])
def test_lanes_at_t_min_are_inert(name, start):
    scene = _scene(name)
    o, d, live = _rays(0.6, seed=3)
    args, opts = _launch(scene, o, d, live)
    base = group_trace.trace_group(*args, **opts)
    # Every other lane that hits starts at 0 (a dead lane's carry) or at
    # t_min instead: each would hit again if it were tested.
    hit = (base[0] < 1e29) & live
    pick = hit & (torch.cumsum(hit.flatten().int(), 0).reshape(hit.shape)
                  % 2 == 0)
    assert int(pick.sum()) > 40
    t0 = 0.0 if start == "zero" else CFG.t_min
    args[5] = torch.where(pick, t0, args[5]).to(torch.float32)
    args[6] = torch.where(pick[:, None, :], 0.25, args[6])
    out = group_trace.trace_group(*args, **opts)
    assert torch.equal(out[0][pick], args[5][pick])
    assert torch.equal(out[1].transpose(1, 2)[pick],
                       args[6].transpose(1, 2)[pick])
    # The same launch with those lanes' ray rows swapped among them and
    # reversed: every output and count is unchanged.
    rv = args[0].clone()
    lanes = pick.nonzero()
    rv[lanes[:, 0], :, lanes[:, 1]] = args[0][lanes[:, 0], :,
                                              lanes[:, 1]].flip(0)
    moved = group_trace.trace_group(rv, *args[1:], **opts)
    _equal(out, moved)
    assert int(out[2].sum()) > 0


def _brute_tests(args, opts, monkeypatch):
    """Per group, the brute-force count of
    gated lanes above t_min over the visits: the gated lanes of each
    visit are found from the origin rows the t block is contracted with
    (every random origin is distinct), and their running best at the
    visit is read from t_in, since a live lane stays above t_min (checked
    on the outputs)."""
    rv, t_in = args[0], args[5]
    seen = []
    contract = group_trace._contract

    def spy(qb, r):
        if r.shape[0] == 4:                   # the t block: o and 1 rows
            seen.append(r[0:3])
        return contract(qb, r)

    monkeypatch.setattr(group_trace, "_contract", spy)
    counts = []
    for g in range(rv.shape[0]):
        seen.clear()
        group_trace.trace_group_plain(*args, **opts, groups=[g])
        n = 0
        origins = rv[g, 6:9]                  # (3, 1024)
        for o_rows in seen:
            lanes = ((o_rows[:, :, None] == origins[:, None, :]).all(0)
                     .nonzero()[:, 1])
            assert lanes.numel() == o_rows.shape[1]
            n += int((t_in[g, lanes] > CFG.t_min).sum())
        counts.append(n)
    return counts


@pytest.mark.parametrize("case", ["all_live", "live_5pct", "one_live"])
def test_tests_count_is_brute_force(case, monkeypatch):
    scene = _scene("icosphere")
    o, d, live = _rays(0.05 if case == "live_5pct" else 1.0, seed=5)
    if case == "one_live":
        # The first lane of each group that hits when all are live.
        hit = group_trace.trace_group(*_launch(scene, o, d, live)[0])[0]
        first = (hit < 1e29).int().argmax(dim=1)
        live = torch.zeros_like(live)
        live[torch.arange(live.shape[0]), first] = True
    args, opts = _launch(scene, o, d, live)
    out = group_trace.trace_group(*args, **opts)
    assert bool((out[2] > 0).all())
    # Live lanes end above t_min (a miss at BIG or a hit t > t_min), so
    # each was above it at every visit: the brute count reads t_in.
    assert bool((out[0][live] > CFG.t_min).all())
    brute = _brute_tests(args, opts, monkeypatch)
    assert out[4].tolist() == brute
    if case == "all_live":
        assert torch.equal(out[4], 128 * out[3])
    if case == "one_live":
        assert torch.equal(out[4], out[2])
    print(f"{case}: visits {out[2].tolist()}, gated {out[3].tolist()}, "
          f"tests {out[4].tolist()}")
