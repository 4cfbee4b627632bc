"""The yardstick's arithmetic gives the bounds PERF.md recorded from their
recorded counts (NVIDIA H100 80GB HBM3 runs of chip_smoke.py)."""
from __future__ import annotations

import pytest

from rtbench import roofline


@pytest.mark.parametrize("kind, counts, want_ms, by", [
    # K1a, config 3 at the verify camera: 5,359 unit visits.
    ("k1", dict(visits=5359, moved=0), 0.2579, "operations"),
    # K1b + K1c, config 7's first window: 1,035,542 visits, compressed.
    ("k1", dict(visits=1035542, moved=0, derive=True), 49.9039,
     "operations"),
    # K2, config 5 frame 0, bounce 1: 2,152,696 tested (lane, unit) pairs.
    ("k2", dict(tests=2152696, visits=5144, moved=0), 0.1131, "operations"),
])
def test_recorded_bounds(kind, counts, want_ms, by):
    bound = roofline.k1_bound if kind == "k1" else roofline.k2_bound
    ms, got_by = bound(**counts)
    assert round(ms, 4) == want_ms
    assert got_by == by


def test_operation_counts():
    assert roofline.OPS_PER_RAY_VISIT == 3149
    assert roofline.DERIVE_OPS_PER_LEAF == 66
    assert roofline.K2_OPS_PER_RAY_LEAF == 55


def test_bytes_bound_takes_over():
    ms, by = roofline.k1_bound(visits=1, moved=3_350_000_000)
    assert by == "bytes" and ms == pytest.approx(1.0)
