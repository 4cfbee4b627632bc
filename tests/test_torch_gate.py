"""The port's cell tier and verify plan against bench.py's.

utils/gate.py copies bench.py's subpixel-leaf gate (diff_metrics' 6x6
cell means, main's pixel guard) and its choice of verification size and
mode (_verify_image). On the frame pairs of tests/test_bench_gate.py the
cell counts must be bench.py's; the plan must give bench.py's answers,
read from _verify_image itself with its two renders stubbed.
"""
import sys
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")
import bench  # noqa: E402
from rtmm_tpu.config import RenderConfig  # noqa: E402
from rtmm_tpu_torch.utils import gate  # noqa: E402

torch.set_num_threads(1)
H, W = 270, 480


def _base():
    return np.random.default_rng(0).uniform(0.0, 1.0, (H, W, 3)).astype(
        np.float32)


def _random_pair():
    return _base(), np.random.default_rng(7).uniform(
        0.0, 1.0, (H, W, 3)).astype(np.float32)


def _scattered_flips():
    base = _base()
    rng = np.random.default_rng(1)
    b = base.copy()
    idx = rng.choice(H * W, 985, replace=False)
    ys, xs = idx // W, idx % W
    b[ys, xs] = np.clip(
        base[ys, xs] + rng.uniform(-0.62, 0.62, (985, 3)).astype(np.float32),
        0.0, 1.0)
    return base, b


def _regional_fault():
    base = _base()
    b = base.copy()
    b[100:120, 200:238] = np.clip(base[100:120, 200:238] + 0.48, 0.0, 1.0)
    return base, b


def _uniform_bias():
    base = _base()
    return base, np.clip(base + 0.04, 0.0, 1.0)


def _odd_size_flips():
    """A frame whose sides are not multiples of 6: bench crops to cells."""
    a, b = _scattered_flips()
    return a[:136, :241], b[:136, :241]


PAIRS = {"random": _random_pair, "scattered_flips": _scattered_flips,
         "regional_fault": _regional_fault, "uniform_bias": _uniform_bias,
         "identical": lambda: (_base(), _base()),
         "odd_size": _odd_size_flips}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_cell_tier_equals_bench(name):
    a, b = PAIRS[name]()
    npix, nbig, maxd, ncell, maxc = (np.asarray(x) for x in
                                     bench.diff_metrics(jnp.asarray(a),
                                                        jnp.asarray(b)))
    got = gate.cell_gate(torch.from_numpy(a), torch.from_numpy(b))
    assert got["ncell"] == int(ncell)
    assert abs(got["maxcell"] - float(maxc)) <= 1e-6
    assert (got["npix"], got["nbig"]) == (int(npix), int(nbig))
    assert got["maxdiff"] == float(maxd)
    # main()'s verdict in cell mode.
    ok = int(ncell) <= 8 and int(npix) <= max(a.shape[0] * a.shape[1] // 10,
                                              1)
    assert got["ok"] == ok
    assert got["ok"] == (name in ("identical", "scattered_flips", "odd_size"))


class _Scene(NamedTuple):
    unit_valid: np.ndarray


@pytest.mark.parametrize("n_units", [50_000, 200_000, 1_000_000])
def test_verify_plan_equals_bench(n_units, monkeypatch):
    """bench._verify_image's size and mode for a 1080p config, its two
    renders replaced by blank frames of the size it asks for."""
    from rtmm_tpu.render import renderer

    def blank(scene, ivp, cfg):
        return jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    monkeypatch.setattr(renderer, "render_image", blank)
    cfg = RenderConfig(width=1920, height=1080)
    v = bench._verify_image(_Scene(np.ones(n_units, bool)), cfg)
    vw, vh = map(int, v.get("verify_wh", "1920x1080").split("x"))
    assert gate.verify_plan(n_units, 1920, 1080) == (vw, vh,
                                                     v["verify_mode"])
