"""The kernel-free grouped secondary engine (ops/grouped.py) against the
JAX package's ops/grouped.py.

Rays: 2 groups of seeded random rays (origins in [-2, 2]^3, unit
directions, 60% live) over a subdivision-1 level-3 icosphere, the setup of
the JAX package's own grouped-kernel test, with precomputed and with
compressed tables. Both sides compute the Möller-Trumbore numerators as
float32 matrix products (XLA's at HIGHEST precision, PyTorch's with TF32
off), whose summation order may differ in the last bit; so t agrees to
1e-5 * max(1, t) on common hits, and hit masks and normalised normals
(to 1e-5) on all but 0.1% of live rays (an acceptance flip at a leaf
edge, or a winner flip between two leaves whose t tie to the last bits).
The group keys and the overflow count are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import grouped as jgrouped
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import grouped

torch.set_num_threads(1)

GROUP = grouped.GROUP


def random_rays(g=2, seed=0):
    """(o, d, live) numpy arrays of g seeded random ray groups."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 2.0, (g, GROUP, 3)).astype(np.float32)
    d = rng.normal(size=(g, GROUP, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    live = rng.uniform(size=(g, GROUP)) < 0.6
    return o, d, live


def hold(t, n, t_ref, n_ref, live, rtol):
    """|dt| <= rtol * max(1, t) on common hits; hit masks and normalised
    normals (within rtol) agree on all but 0.1% of live rays — a hit that
    flips at a leaf edge, or a winner that flips between two leaves whose
    t differ in the last bits."""
    hit, hit_ref = (t < 1e29) & live, (t_ref < 1e29) & live
    common = hit & hit_ref
    assert common.sum() > 50
    dt = np.abs(t - t_ref) / np.maximum(1.0, np.abs(t_ref))
    assert dt[common].max() <= rtol

    def unit(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                              1e-20)

    dn = np.abs(unit(n) - unit(n_ref)).max(-1)
    flips = int((hit != hit_ref).sum()) + int((dn[common] > rtol).sum())
    print(f"{int(common.sum())} common hits, {flips} flips, max |dt| "
          f"{dt[common].max():.3e}")
    assert flips <= 0.001 * live.sum(), flips
    return int(common.sum())


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for comp in (False, True):
        out[comp] = (jscene.build_device_scene(
            jproc.make_icosphere(subdivisions=1, level=3, amplitude=0.15),
            compressed=comp),
            scene_mod.build_device_scene(procedural.make_icosphere(
                subdivisions=1, level=3, amplitude=0.15), compressed=comp,
                device="cpu"))
    return out


def test_octant_and_sort_key_exact(scenes):
    ref, port = scenes[False]
    o, d, _ = random_rays(1, seed=5)
    o, d = o[0] * 1.5, d[0]
    d[:16] = 0.0                                    # the > 0 boundary
    np.testing.assert_array_equal(
        grouped._octant(torch.from_numpy(d)).numpy(),
        np.asarray(jgrouped._octant(jnp.asarray(d))))
    np.testing.assert_array_equal(
        grouped._sort_key(torch.from_numpy(o), torch.from_numpy(d),
                          port).numpy(),
        np.asarray(jgrouped._sort_key(jnp.asarray(o), jnp.asarray(d), ref)))
    assert grouped.DEAD_KEY == jgrouped.DEAD_KEY == 512


@pytest.mark.parametrize("compressed", [False, True])
def test_trace_sorted_matches_jax(scenes, compressed):
    ref, port = scenes[compressed]
    o, d, live = random_rays()
    t_ref, n_ref, ovf_ref = jgrouped.trace_sorted(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(live),
        JaxConfig(width=48, height=32))
    t, n, ovf = grouped.trace_sorted(
        port, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(live), RenderConfig(width=48, height=32))
    assert t.shape == (2, GROUP) and n.shape == (2, GROUP, 3)
    hits = hold(t.numpy(), n.numpy(), np.asarray(t_ref), np.asarray(n_ref),
                live, 1e-5)
    print(f"{hits} common hits")
    assert int(ovf) == int(np.asarray(ovf_ref))
    # Dead lanes stay misses.
    assert bool((t.numpy()[~live] >= 1e29).all())


def test_forced_overflow_reports_truncation():
    """A one-entry candidate list over a scene whose units all overlap
    the rays' reach box: the overflow counts the truncated group, as the
    JAX engine's does."""
    mesh_args = dict(grid=(12, 12), level=2, amplitude=0.2)
    ref = jscene.build_device_scene(jproc.make_plane(**mesh_args))
    port = scene_mod.build_device_scene(procedural.make_plane(**mesh_args),
                                        device="cpu")
    assert port.num_units > 1
    o = np.tile(np.asarray([[0.0, 0.0, 2.0]], np.float32), (GROUP, 1))[None]
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (GROUP, 1))[None]
    live = np.ones((1, GROUP), bool)
    cfg = RenderConfig(width=48, height=32)
    t, _, ovf = grouped.trace_sorted(port, torch.from_numpy(o),
                                     torch.from_numpy(d),
                                     torch.from_numpy(live), cfg,
                                     max_group_candidates=1)
    t_ref, _, ovf_ref = jgrouped.trace_sorted(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(live),
        JaxConfig(width=48, height=32), max_group_candidates=1)
    assert int(ovf) == int(np.asarray(ovf_ref)) > 0
    np.testing.assert_array_equal(t.numpy() < 1e29, np.asarray(t_ref) < 1e29)
