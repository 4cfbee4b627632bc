"""The grouped trace kernel's plain version (ops/group_trace.py on CPU
tensors) against the JAX package's engines.

Against rtmm_tpu/ops/pallas_grouped.trace_sorted in interpret mode (the
TPU kernel itself): its Möller-Trumbore products are 3-pass bf16
(about 2^-16 relative), the port's are float32, so t agrees to 1e-4 *
max(1, t) on common hits, normalised normals to 1e-4, hit masks on all
but 0.1% of live rays, and the extra window passes are equal. Against
rtmm_tpu/ops/grouped.trace_sorted (float32 XLA) the same holds at 1e-5.
Scenes: a subdivision-1 level-3 icosphere (precomputed and compressed
records with one shared topology) and a level-2 plane (compressed,
indexed records); a 12x12 level-2 plane traced one cluster per window
covers the window loop.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import grouped as jgrouped
from rtmm_tpu.ops import pallas_grouped
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import group_trace
from test_torch_grouped import hold, random_rays

torch.set_num_threads(1)

SCENES = {
    "icosphere": (lambda m: m.make_icosphere(subdivisions=1, level=3,
                                             amplitude=0.15), False),
    "icosphere_compressed": (lambda m: m.make_icosphere(
        subdivisions=1, level=3, amplitude=0.15), True),
    "plane_indexed": (lambda m: m.make_plane(grid=(4, 4), level=2,
                                             amplitude=0.2), True),
}


def _scenes(name):
    make, comp = SCENES[name]
    ref = jscene.build_device_scene(make(jproc), compressed=comp)
    port = scene_mod.build_device_scene(make(procedural), compressed=comp,
                                        device="cpu")
    return ref, port


def _port(port, o, d, live, **cfg):
    group_trace.reset_launches()
    t, n, extra = group_trace.trace_sorted(
        port, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(live), RenderConfig(width=48, height=32, **cfg))
    # CPU tensors run the plain version: nothing launches.
    assert sum(group_trace.LAUNCHES.values()) == 0
    return t.numpy(), n.numpy(), extra


@pytest.mark.parametrize("name", ["icosphere", "plane_indexed"])
def test_plain_matches_jax_kernel(name):
    ref, port = _scenes(name)
    assert port.compressed == port.indexed == (name == "plane_indexed")
    o, d, live = random_rays()
    t_ref, n_ref, w_ref = pallas_grouped.trace_sorted(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(live),
        JaxConfig(width=48, height=32), interpret=True)
    t, n, extra = _port(port, o, d, live)
    hits = hold(t, n, np.asarray(t_ref), np.asarray(n_ref), live, 1e-4)
    print(f"{name}: {hits} common hits, extra windows {extra}")
    assert extra == int(np.asarray(w_ref))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_matches_jax_grouped(name):
    ref, port = _scenes(name)
    o, d, live = random_rays(seed=1)
    t_ref, n_ref, _ = jgrouped.trace_sorted(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(live),
        JaxConfig(width=48, height=32), max_group_candidates=4096)
    t, n, _ = _port(port, o, d, live)
    hold(t, n, np.asarray(t_ref), np.asarray(n_ref), live, 1e-5)


def test_multi_window_walk():
    """One cluster per window on a two-cluster plane: the carries cross
    windows, groups stay active while a cluster can beat their bound, and
    the result is the all-candidates trace's."""
    mesh_args = dict(grid=(12, 12), level=2, amplitude=0.2)
    ref = jscene.build_device_scene(jproc.make_plane(**mesh_args))
    port = scene_mod.build_device_scene(procedural.make_plane(**mesh_args),
                                        device="cpu")
    assert port.num_clusters >= 2
    o, d, live = random_rays(seed=2)
    t1, n1, extra1 = _port(port, o, d, live, kernel_clusters_per_window=1)
    t_all, n_all, extra_all = _port(port, o, d, live)
    t_ref, n_ref, _ = jgrouped.trace_sorted(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(live),
        JaxConfig(width=48, height=32), max_group_candidates=4096)
    print(f"extra windows: {extra1} at one cluster per window, "
          f"{extra_all} with all clusters")
    assert extra1 > 0 and extra_all == 0
    np.testing.assert_array_equal(t1, t_all)
    np.testing.assert_array_equal(n1, n_all)
    hold(t1, n1, np.asarray(t_ref), np.asarray(n_ref), live, 1e-5)


def test_plain_counts_and_carries():
    """trace_group_plain's per-group counts: a group with an empty list
    passes its carries through with zero counts; a walked group counts
    at least one visit, 1-8 gated sub-groups per visit and at most 128
    tested lanes per gated sub-group."""
    _, port = _scenes("icosphere")
    o, d, live = random_rays(g=3, seed=4)
    live[2] = False                               # an all-dead group
    cfg = RenderConfig(width=48, height=32)
    o, d, live = (torch.from_numpy(x) for x in (o, d, live))
    rv, box, _, omin, omax, cl_hit = group_trace.group_inputs(
        port, o, d, live, cfg)
    assert not bool(cl_hit[2].any())
    lists = group_trace._grouped_cluster_window(port, omin, omax, cl_hit,
                                                port.num_clusters)[:3]
    meta, tables, nrm, opts = group_trace.scene_tables(port)
    t_in = torch.where(live, group_trace.BIG, 0.0)
    n_in = torch.full((3, 3, 1024), 0.5)
    t, n, vis, gated, tests = group_trace.trace_group(
        rv, box, *lists, t_in, n_in, meta, tables, nrm, cfg, **opts)
    assert vis.dtype == gated.dtype == tests.dtype == torch.int32
    assert int(vis[2]) == int(gated[2]) == int(tests[2]) == 0
    assert torch.equal(t[2], t_in[2]) and torch.equal(n[2], n_in[2])
    assert bool((vis[:2] > 0).all())
    assert bool((gated[:2] >= vis[:2]).all())
    assert bool((gated[:2] <= 8 * vis[:2]).all())
    assert bool((tests[:2] > 0).all())
    assert bool((tests[:2] <= 128 * gated[:2]).all())


def test_wrapper_device_and_input_checks():
    _, port = _scenes("icosphere")
    o, d, live = (torch.from_numpy(x) for x in random_rays(g=1))
    cfg = RenderConfig()
    rv, box, _, omin, omax, cl_hit = group_trace.group_inputs(
        port, o, d, live, cfg)
    lists = group_trace._grouped_cluster_window(port, omin, omax, cl_hit,
                                                1)[:3]
    meta, tables, nrm, _ = group_trace.scene_tables(port)
    t_in = torch.zeros((1, 1024))
    n_in = torch.zeros((1, 3, 1024))
    with pytest.raises(TypeError):
        group_trace.trace_group(rv, box, lists[0].long(), *lists[1:], t_in,
                                n_in, meta, tables, nrm, cfg)
    with pytest.raises(ValueError):
        group_trace.trace_group(rv, box[:, :10].contiguous(), *lists, t_in,
                                n_in, meta, tables, nrm, cfg)
    meta_dev = [x.to("meta") for x in (rv, box, *lists, t_in, n_in, meta,
                                       tables, nrm)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        group_trace.trace_group(*meta_dev, cfg)
