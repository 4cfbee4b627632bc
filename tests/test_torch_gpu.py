"""The trace kernels against their plain PyTorch versions, on the card:
the tile trace in every mode (fused with precomputed and compressed
tables, in-kernel raygen or a ray matrix; windowed; raw with both ray
sources) and the instanced frames built on it; the grouped trace (K2) on
random ray groups over precomputed, compressed and compressed indexed
scenes, and path-traced frames through both secondary engines; the
path tracer's bounce kernels pt_primary / pt_bounce against their plain
versions, per call (ragged lane counts, offset bases, pad pixels, every
normals layout, empty states) and over whole frames; the prologue kernels
tile_frusta / cluster_select against their plain versions, bit for bit,
with their launch counts (each list path: the warp's, the block's shared
order, past its capacity; NaN, +inf and tied distances; an apex per row;
tile ranges and every pack), and every prologue path on the card kept
off the plain versions; the
per-ray reference backend on the card against the CPU, the perray engine
against the pallas engine, and the debug render's NaN check.

Marked `gpu`: each test asks the `cuda` fixture for the card and skips
where there is none (the CPU runs only the plain version). On a machine
with the card and without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import (culling, group_trace, prologue, tiled,
                                tile_trace)
from rtmm_tpu_torch.render import instances as inst_mod
from rtmm_tpu_torch.render import pathtrace
from rtmm_tpu_torch.render.renderer import Renderer
from rtmm_tpu_torch.utils import camera
from rtmm_tpu_torch.utils.gate import image_gate

pytestmark = pytest.mark.gpu

SCENES = [  # (subdivisions, level, width, height): the CPU tests' scenes
    (0, 2, 128, 64),
    (1, 3, 256, 64),
]
# Sub-cone grids (sub_frusta, sub_rows) and frame sizes of the kernel's
# ray-to-thread map: the default 4 x 1 grid, and 8 sub-cones in 2 rows on
# a 100x80 frame, whose last tile row and column are partly padded and
# whose corner tiles hold no cluster (rows with ccount 0).
GRIDS = {"sub4": (4, 1, None), "sub8_padded": (8, 2, (100, 80))}


def _grid_cfg(grid, w, h, **kw):
    nsub, nrows, size = GRIDS[grid]
    w, h = size or (w, h)
    return RenderConfig(width=w, height=h, sub_frusta=nsub, sub_rows=nrows,
                        **kw), w, h


def _has_empty_rows(grid, ccount):
    """The padded grid's frames must hold rows with no cluster."""
    if GRIDS[grid][2] is not None:
        assert bool((ccount == 0).any()) and bool((ccount > 0).any())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CPU runs the plain version")
    return torch.device("cuda")


def _ivp(w, h, yaw=25.0):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30.0), np.radians(yaw), 0.0], 3.0)
    return camera.inv_view_proj(tb, w, h)


def _scene(sub, level, device):
    mesh = procedural.make_icosphere(subdivisions=sub, level=level,
                                     amplitude=0.1)
    return scene_mod.build_device_scene(mesh, device=device)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("sub,level,w,h", SCENES)
def test_kernel_matches_plain(cuda, sub, level, w, h, grid):
    scene = _scene(sub, level, cuda)
    cfg, w, h = _grid_cfg(grid, w, h)
    rows = tile_trace.frame_inputs(scene, _ivp(w, h), cfg,
                                   tile_trace.clusters_per_window(scene, cfg))
    _has_empty_rows(grid, rows[1])
    pw, ph = tiled.padded_size(w, h)
    geo = dict(tiles_per_frame=(pw // 32) * (ph // 32), tx=pw // 32,
               pw=pw, ph=ph)
    args = (*rows, scene.cluster_unit_meta, scene.unit_qn, cfg)
    before = tile_trace.LAUNCHES["tile_trace_fused"]
    k_img, k_vis, k_elig = tile_trace.trace_fused(*args, **geo)
    torch.cuda.synchronize()
    assert tile_trace.LAUNCHES["tile_trace_fused"] == before + 1
    p_img, p_vis, p_elig = tile_trace.trace_fused_plain(*args, **geo)
    assert torch.equal(k_vis, p_vis)
    assert torch.equal(k_elig, p_elig)
    assert int(k_vis.sum()) > 0
    gate = image_gate(k_img[0, :h, :w], p_img[0, :h, :w])
    print(f"kernel vs plain: {gate}")
    assert gate["ok"], gate
    # Same float32 operations in the same order (nvcc -fmad=false); only
    # exact-t ties may sum winner normals in another order.
    assert gate["maxdiff"] <= 1e-5, gate


def test_kernel_reciprocal_is_exact(cuda):
    """The tile kernel's branch-free reciprocal equals 1.0f / x on every
    float32 input in its range: normal x with |x| < 2^126, both signs."""
    bad, n = tile_trace.reciprocal_check(cuda)
    assert n == 2 * 252 * 2**23
    assert bad == 0


def test_render_frames_equals_frames(cuda):
    scene = _scene(1, 3, cuda)
    cfg = RenderConfig(width=256, height=64)
    ivps = np.stack([_ivp(256, 64, yaw) for yaw in (10.0, 25.0, 40.0)])
    batch = tile_trace.render_frames(scene, ivps, cfg)
    for k in range(3):
        assert torch.equal(batch[k],
                           tile_trace.render_frame(scene, ivps[k], cfg))



@pytest.mark.parametrize("compressed", [False, True])
def test_batched_prologue_on_card(cuda, compressed, monkeypatch):
    """frames_inputs' rows bit-equal to per-frame frame_inputs' on the
    card, and render_frames in two launch chunks (a 32-row cap: two
    256x64 frames of 16 tiles each per launch) equal to render_frame, one
    fused launch per chunk."""
    mesh = procedural.make_icosphere(subdivisions=1, level=3, amplitude=0.1)
    scene = scene_mod.build_device_scene(mesh, compressed=compressed,
                                         device=cuda)
    cfg = RenderConfig(width=256, height=64)
    kc = tile_trace.clusters_per_window(scene, cfg)
    ivps = np.stack([_ivp(256, 64, yaw) for yaw in (10.0, 25.0, 40.0,
                                                     200.0)])
    got = tile_trace.frames_inputs(scene, ivps, cfg, kc)
    want = [torch.cat(parts) for parts in zip(*(
        tile_trace.frame_inputs(scene, ivp, cfg, kc) for ivp in ivps))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    name = ("tile_trace_fused_compressed" if compressed
            else "tile_trace_fused")
    monkeypatch.setattr(tile_trace, "BATCH_TILE_CAP", 32)
    before = tile_trace.LAUNCHES[name]
    batch = tile_trace.render_frames(scene, ivps, cfg)
    torch.cuda.synchronize()
    assert tile_trace.LAUNCHES[name] == before + 2
    for k in range(4):
        assert torch.equal(batch[k],
                           tile_trace.render_frame(scene, ivps[k], cfg))

def test_wrapper_rejects_bad_input(cuda):
    scene = _scene(0, 2, cuda)
    cfg = RenderConfig(width=128, height=64)
    ccand, ccount, centry, frus = tile_trace.frame_inputs(
        scene, _ivp(128, 64), cfg, tile_trace.clusters_per_window(scene, cfg))
    geo = dict(tiles_per_frame=8, tx=4, pw=128, ph=64)
    with pytest.raises(TypeError):
        tile_trace.trace_fused(ccand.long(), ccount, centry, frus,
                               scene.cluster_unit_meta, scene.unit_qn, cfg,
                               **geo)
    with pytest.raises(ValueError):
        tile_trace.trace_fused(ccand, ccount, centry, frus.cpu(),
                               scene.cluster_unit_meta, scene.unit_qn, cfg,
                               **geo)
    assert culling.TILE_H * culling.TILE_W == 1024


# Compressed scenes: (mesh maker, width, height): indexed records with a
# shared gather matrix (level 2), plain records (level 3) and per-unit
# index rows (mixed levels).
COMPRESSED = {
    "level2_plane": (lambda: procedural.make_plane(
        grid=(8, 8), level=2, amplitude=0.05), 128, 64),
    "level3_plane": (lambda: procedural.make_plane(
        grid=(4, 4), level=3, amplitude=0.05), 128, 64),
    "mixed_levels": (lambda: procedural.make_icosphere(
        subdivisions=1, level=3, amplitude=0.12, mixed_levels=True), 128, 64),
}


def _check_image(k_img, p_img, w, h):
    gate = image_gate(k_img[:h, :w], p_img[:h, :w])
    print(f"kernel vs plain: {gate}")
    assert gate["ok"], gate
    assert gate["maxdiff"] <= 1e-5, gate


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name", sorted(COMPRESSED))
def test_compressed_kernel_matches_plain(cuda, name, grid):
    make, w, h = COMPRESSED[name]
    scene = scene_mod.build_device_scene(make(), compressed=True,
                                         device=cuda)
    cfg, w, h = _grid_cfg(grid, w, h)
    rows = tile_trace.frame_inputs(scene, _ivp(w, h), cfg,
                                   tile_trace.clusters_per_window(scene, cfg))
    _has_empty_rows(grid, rows[1])
    meta, tables, opts = tile_trace.scene_tables(scene)
    pw, ph = tiled.padded_size(w, h)
    geo = dict(tiles_per_frame=(pw // 32) * (ph // 32), tx=pw // 32,
               pw=pw, ph=ph)
    before = tile_trace.LAUNCHES["tile_trace_fused_compressed"]
    k_img, k_vis, k_elig = tile_trace.trace_fused(*rows, meta, tables, cfg,
                                                  **opts, **geo)
    torch.cuda.synchronize()
    assert tile_trace.LAUNCHES["tile_trace_fused_compressed"] == before + 1
    p_img, p_vis, p_elig = tile_trace.trace_fused_plain(
        *rows, meta, tables, cfg, **opts, **geo)
    assert torch.equal(k_vis, p_vis) and torch.equal(k_elig, p_elig)
    assert int(k_vis.sum()) > 0
    _check_image(k_img[0], p_img[0], w, h)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("compressed", [False, True])
def test_windowed_kernel_matches_plain(cuda, compressed, grid):
    """One window's launch at equal carries, then a whole windowed frame
    against the fused frame of the same scene."""
    mesh = procedural.make_icosphere(subdivisions=2, level=3, amplitude=0.1)
    scene = scene_mod.build_device_scene(mesh, compressed=compressed,
                                         device=cuda)
    cfg, w, h = _grid_cfg(grid, 128, 64, kernel_clusters_per_window=2)
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene, _ivp(w, h), cfg)
    meta, tables, opts = tile_trace.scene_tables(scene)
    ccand, ccount, centry, _, _ = tiled.cluster_window(
        scene, fi.apex, fi.cluster_hit, 2)
    _has_empty_rows(grid, ccount)
    n = frus.shape[0]
    carry = (torch.full((n, 1024), tile_trace.BIG, device=cuda),
             torch.zeros((n, 3, 1024), device=cuda),
             torch.zeros(n, dtype=torch.int32, device=cuda),
             torch.zeros(n, dtype=torch.int32, device=cuda))
    name = "tile_trace_windowed" + ("_compressed" if compressed else "")
    before = tile_trace.LAUNCHES[name]
    k = tile_trace.trace_windowed(ccand, ccount, centry, frus, raymat,
                                  carry, meta, tables, cfg, **opts)
    torch.cuda.synchronize()
    assert tile_trace.LAUNCHES[name] == before + 1
    p = tile_trace.trace_windowed_plain(ccand, ccount, centry, frus, raymat,
                                        carry, meta, tables, cfg, **opts)
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    assert int(k[2].sum()) > 0
    assert torch.equal(k[0], p[0])
    assert float((k[1] - p[1]).abs().max()) <= 1e-5
    img, st = tile_trace.render_frame(scene, _ivp(w, h), cfg,
                                      with_stats=True)
    fused, st1 = tile_trace.render_frame(
        scene, _ivp(w, h), dataclasses.replace(
            cfg, kernel_clusters_per_window=RenderConfig()
            .kernel_clusters_per_window), with_stats=True)
    assert st["windows"] > 1 and st1["windows"] == 1
    _check_image(img, fused, w, h)


def test_config7_construction_windows_on_card(cuda):
    """Config 7's construction (a level-3 plane, compressed) at a 200x200
    grid through render_frame in windows of 16 clusters: one windowed
    launch per window, and the first window's launch bit-equal to its
    plain version on the most visited tiles and evenly spaced others."""
    mesh = procedural.make_plane(grid=(200, 200), level=3, amplitude=0.05)
    scene = scene_mod.build_device_scene(mesh, compressed=True, device=cuda)
    w, h = 320, 192
    cfg = RenderConfig(width=w, height=h, kernel_clusters_per_window=16)
    name = "tile_trace_windowed_compressed"
    before = tile_trace.LAUNCHES[name]
    img, st = tile_trace.render_frame(scene, _ivp(w, h), cfg,
                                      with_stats=True)
    torch.cuda.synchronize()
    assert scene.num_clusters == 1250 and st["windows"] > 1
    assert tile_trace.LAUNCHES[name] == before + st["windows"]
    assert bool(torch.isfinite(img).all())
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene, _ivp(w, h), cfg)
    meta, tables, opts = tile_trace.scene_tables(scene)
    ccand, ccount, centry, _, _ = tiled.cluster_window(
        scene, fi.apex, fi.cluster_hit, 16)
    n = frus.shape[0]
    carry = (torch.full((n, 1024), tile_trace.BIG, device=cuda),
             torch.zeros((n, 3, 1024), device=cuda),
             torch.zeros(n, dtype=torch.int32, device=cuda),
             torch.zeros(n, dtype=torch.int32, device=cuda))
    k = tile_trace.trace_windowed(ccand, ccount, centry, frus, raymat,
                                  carry, meta, tables, cfg, **opts)
    nonempty = (ccount > 0).nonzero()[:, 0]
    by_visits = nonempty[torch.argsort(k[2][nonempty], descending=True,
                                       stable=True)]
    rows = sorted(set(by_visits[:4].tolist())
                  | set(nonempty[::max(1, len(nonempty) // 4)].tolist()))
    p = tile_trace.trace_windowed_plain(ccand, ccount, centry, frus, raymat,
                                        carry, meta, tables, cfg, **opts,
                                        rows=rows)
    assert int(k[2][rows].sum()) > 0
    for a, b in zip(k, p):
        assert torch.equal(a[rows], b[rows])


def test_ray_matrix_input_kernel(cuda):
    scene = _scene(1, 3, cuda)
    cfg = RenderConfig(width=256, height=64, kernel_raygen=False)
    img, st = tile_trace.render_frame(scene, _ivp(256, 64), cfg,
                                      with_stats=True)
    ref, st0 = tile_trace.render_frame(
        scene, _ivp(256, 64), RenderConfig(width=256, height=64),
        with_stats=True)
    assert torch.equal(st["kernel_unit_visits"], st0["kernel_unit_visits"])
    _check_image(img, ref, 256, 64)


RING = [inst_mod.Instance.from_euler([1.6, 0.2, 0.1], (0.3, -0.5, 0.2), 0.6),
        inst_mod.Instance.from_euler([-1.1, 0.9, -0.3], (0.1, 2.1, 0.7), 1.3),
        inst_mod.Instance.from_euler([0.1, -1.4, 0.4], (-0.4, 4.0, 0.1),
                                     0.9)]


def _ivp_far(w, h):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30.0), np.radians(20.0), 0.0], 4.5)
    return camera.inv_view_proj(tb, w, h)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("kernel_raygen", [True, False])
def test_raw_kernel_matches_plain(cuda, compressed, kernel_raygen, grid):
    """The rows of a merged launch over three non-identity instances:
    the raw kernel against its plain version, with the in-kernel object
    transform and with a ray-matrix input."""
    mesh = procedural.make_icosphere(subdivisions=1, level=3, amplitude=0.12)
    scene = scene_mod.build_device_scene(mesh, compressed=compressed,
                                         device=cuda)
    cfg, w, h = _grid_cfg(grid, 96, 64, kernel_raygen=kernel_raygen)
    ivp = _ivp_far(w, h)
    world = inst_mod.world_frame(ivp, cfg, cuda)
    launch = inst_mod.merged_launch_inputs(
        scene, *inst_mod.instance_tensors(RING, cuda), ivp, world, cfg)
    _has_empty_rows(grid, launch.ccount)
    meta, tables, opts = tile_trace.scene_tables(scene)
    args = (launch.ccand, launch.ccount, launch.centry, launch.frus, meta,
            tables, cfg)
    name = "tile_trace_raw" + ("_compressed" if compressed else "")
    before = tile_trace.LAUNCHES[name]
    k_out, k_vis, k_elig = tile_trace.trace_raw(*args, raymat=launch.raymat,
                                                **opts)
    torch.cuda.synchronize()
    assert tile_trace.LAUNCHES[name] == before + 1
    p_out, p_vis, p_elig = tile_trace.trace_raw_plain(
        *args, raymat=launch.raymat, **opts)
    assert torch.equal(k_vis, p_vis) and torch.equal(k_elig, p_elig)
    assert int(k_vis.sum()) > 0
    # Same float32 operations in the same order (nvcc -fmad=false); only
    # exact-t ties may sum winner normals in another order.
    assert torch.equal(k_out[:, 0], p_out[:, 0])
    assert float((k_out - p_out).abs().max()) <= 1e-5


def test_instanced_merged_matches_serial_and_baked(cuda):
    scene = _scene(1, 3, cuda)
    w, h = 256, 128
    cfg = RenderConfig(width=w, height=h)
    ivp = _ivp_far(w, h)
    tile_trace.reset_launches()
    merged = inst_mod.render_instanced(scene, RING, ivp, cfg)
    assert tile_trace.LAUNCHES["tile_trace_raw"] == 1
    assert tile_trace.LAUNCHES["tile_trace_windowed"] == 0
    serial = inst_mod.render_instanced(scene, RING, ivp, cfg, serial=True)
    assert tile_trace.LAUNCHES["tile_trace_windowed"] >= len(RING)
    capped = inst_mod.render_instanced(
        scene, RING, ivp, RenderConfig(width=w, height=h,
                                       instance_tile_cap=1))
    baked = tile_trace.render_frame(inst_mod.bake_instances(scene, RING),
                                    ivp, cfg)
    for other in (serial, capped, baked):
        _check_gate(merged, other)


def _check_gate(a, b):
    gate = image_gate(a, b)
    print(gate)
    assert gate["ok"], gate


# Grouped trace (K2): (mesh maker, compressed). The level-3 icosphere's
# compressed records share one corner topology; the level-2 plane's are
# indexed (and span several clusters).
GROUPED = {
    "precomputed": (lambda: procedural.make_icosphere(
        subdivisions=1, level=3, amplitude=0.15), False),
    "compressed_uniform": (lambda: procedural.make_icosphere(
        subdivisions=1, level=3, amplitude=0.15), True),
    "compressed_indexed": (lambda: procedural.make_plane(
        grid=(12, 12), level=2, amplitude=0.2), True),
}


def _random_groups(g, device, seed=0, live_frac=0.6):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 2.0, (g, 1024, 3)).astype(np.float32)
    d = rng.normal(size=(g, 1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    live = rng.uniform(size=(g, 1024)) < live_frac
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device),
            torch.from_numpy(live).to(device))


def _hold_group(k, p):
    """K2 against its plain version: equal visits, gated sub-groups and
    tests (listed lane x unit pairs) per group, t bit for bit; normals
    equal up to 1e-5 (exact-t ties sum their normals in another
    order)."""
    for j in (2, 3, 4):
        assert torch.equal(k[j], p[j])
    assert torch.equal(k[0], p[0])
    err = float((k[1] - p[1]).abs().max())
    print(f"visits {int(k[2].sum())}, gated {int(k[3].sum())}, tests "
          f"{int(k[4].sum())}, normals max |diff| {err:.3e}")
    assert err <= 1e-5
    return int(k[2].sum())


@pytest.mark.parametrize("live_frac", [0.6, 0.05, 1.0],
                         ids=["live60", "live5", "all_live"])
@pytest.mark.parametrize("name", sorted(GROUPED))
def test_group_trace_kernel_matches_plain(cuda, name, live_frac):
    """60% live lanes, a mostly-dead launch (5%: the kernel tests only
    the few listed lanes, each over many leaf slices) and an all-live one
    (two slices per lane at most)."""
    make, comp = GROUPED[name]
    scene = scene_mod.build_device_scene(make(), compressed=comp,
                                         device=cuda)
    cfg = RenderConfig(kernel_clusters_per_window=1)
    o, d, live = _random_groups(4, cuda, live_frac=live_frac)
    rv, box, _, omin, omax, cl_hit = group_trace.group_inputs(
        scene, o, d, live, cfg)
    meta, tables, nrm, opts = group_trace.scene_tables(scene)
    lists = group_trace._grouped_cluster_window(scene, omin, omax, cl_hit,
                                                2)[:3]
    t_in = torch.where(live, group_trace.BIG, 0.0)
    n_in = torch.zeros((4, 3, 1024), device=cuda)
    name_k = "group_trace_compressed" if comp else "group_trace"
    before = group_trace.LAUNCHES[name_k]
    k = group_trace.trace_group(rv, box, *lists, t_in, n_in, meta, tables,
                                nrm, cfg, **opts)
    torch.cuda.synchronize()
    assert group_trace.LAUNCHES[name_k] == before + 1
    p = group_trace.trace_group_plain(rv, box, *lists, t_in, n_in, meta,
                                      tables, nrm, cfg, **opts)
    assert _hold_group(k, p) > 0
    # tests counts the live lanes of the gated sub-groups: with every lane
    # live it is 128 per gated sub-group.
    if live_frac == 1.0:
        assert torch.equal(k[4], 128 * k[3])
    # The whole window loop, the kernel against the same loop on the CPU
    # scene (plain version).
    t_k, n_k, extra_k = group_trace.trace_sorted(scene, o, d, live, cfg)
    cpu = scene_mod.build_device_scene(make(), compressed=comp,
                                       device="cpu")
    t_p, n_p, extra_p = group_trace.trace_sorted(cpu, o.cpu(), d.cpu(),
                                                 live.cpu(), cfg)
    assert extra_k == extra_p
    hit = t_k.cpu() < 1e29
    assert torch.equal(hit, t_p < 1e29) and int(hit.sum()) > 50
    assert float((t_k.cpu() - t_p).abs().max()) <= 1e-5
    assert float((n_k.cpu() - n_p).abs().max()) <= 1e-5


def test_group_trace_rejects_bad_input(cuda):
    scene = _scene(0, 2, cuda)
    cfg = RenderConfig()
    o, d, live = _random_groups(1, cuda)
    rv, box, _, omin, omax, cl_hit = group_trace.group_inputs(
        scene, o, d, live, cfg)
    meta, tables, nrm, _ = group_trace.scene_tables(scene)
    lists = group_trace._grouped_cluster_window(scene, omin, omax, cl_hit,
                                                1)[:3]
    t_in = torch.zeros((1, 1024), device=cuda)
    n_in = torch.zeros((1, 3, 1024), device=cuda)
    with pytest.raises(ValueError):
        group_trace.trace_group(rv, box.cpu(), *lists, t_in, n_in, meta,
                                tables, nrm, cfg)
    with pytest.raises(TypeError):
        group_trace.trace_group(rv, box, lists[0].long(), *lists[1:], t_in,
                                n_in, meta, tables, nrm, cfg)


@pytest.mark.parametrize("compressed", [False, True])
def test_pathtrace_frame_on_card(cuda, compressed):
    """One path-traced frame through the pallas engine (the tile kernel's
    raw mode, then K2) against the grouped engine on the card and the
    pallas engine's plain versions on the CPU."""
    make = lambda: procedural.make_icosphere(  # noqa: E731
        subdivisions=0, level=3, amplitude=0.1)
    scene = scene_mod.build_device_scene(make(), compressed=compressed,
                                         device=cuda)
    cfg = RenderConfig(width=96, height=64, sub_frusta=8)
    pt = pathtrace.PathTraceConfig(bounces=2, samples_per_pixel=2,
                                   engine="pallas")
    ivp = _ivp(96, 64)
    group_trace.reset_launches()
    img, stats = pathtrace.PathTracer(scene, cfg, pt).render(ivp)
    torch.cuda.synchronize()
    assert sum(group_trace.LAUNCHES.values()) >= 2
    live = stats["live_rays_per_bounce"].cpu()
    assert bool(torch.isfinite(img).all()) and live[0] > 0
    assert bool((live[1:] <= live[:-1]).all())
    grouped_img, gst = pathtrace.PathTracer(scene, cfg, dataclasses.replace(
        pt, engine="grouped")).render(ivp)
    cpu = scene_mod.build_device_scene(make(), compressed=compressed,
                                       device="cpu")
    plain_img, pst = pathtrace.PathTracer(cpu, cfg, pt).render(ivp)
    for other, ost in ((grouped_img, gst), (plain_img.to(cuda), pst)):
        diff = (img - other).abs().amax(-1)
        print(f"over 4/255: {int((diff > 4 / 255).sum())}, live "
              f"{live.tolist()} vs {ost['live_rays_per_bounce'].tolist()}")
        assert int((diff > 4 / 255).sum()) <= 64
        assert int((diff > 0.25).sum()) <= 16
        assert float((ost["live_rays_per_bounce"].cpu() - live).abs().max()
                     ) <= 4


def _pt_state(rng, n, dev):
    """A bounce's state on the card: unnormalised normals (some zero, two
    NaN), unit rays, alive and hit masks, origins, t (misses at BIG, hits
    at 0 dead) and radiance."""
    def t(x):
        return torch.from_numpy(np.array(x)).to(dev)

    bn = (rng.normal(size=(n, 3)) * 2.5).astype(np.float32)
    bn[:8] = 0.0
    bn[8:16] = [0.0, 0.0, 0.9]
    bn[16:18] = np.nan
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    alive = rng.random(n) < 0.7
    tt = rng.uniform(0.0, 3.0, n).astype(np.float32)
    tt[rng.random(n) < 0.3] = np.float32(1e30)
    tt[18:24] = 0.0
    return dict(bn=t(bn), d=t(d), alive=t(alive),
                hit=t(alive & (rng.random(n) < 0.6)),
                o=t(rng.normal(size=(n, 3)).astype(np.float32)),
                t=t(tt),
                rad=t(rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)))


def _pt_same(k, p, dirs=()) -> bool:
    """Kernel outputs against plain ones: bit for bit (NaN where NaN),
    the entries in `dirs` (directions) bit for bit or within 2 ulp of 1
    (cos / sin); uniforms compared as words."""
    eps = float(np.finfo(np.float32).eps)
    assert len(k) == len(p)
    for j, (a, b) in enumerate(zip(k, p)):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype == torch.float32 and j not in dirs:
            same = (a.view(torch.int32) == b.view(torch.int32)) | (
                torch.isnan(a) & torch.isnan(b))
            if not bool(same.all()):
                return False
        elif j in dirs:
            if not torch.equal(torch.isnan(a), torch.isnan(b)):
                return False
            if a.numel() and float((a - b).nan_to_num(0.0).abs().max()) > (
                    2 * eps):
                return False
        elif not torch.equal(a, b):
            return False
    return True


@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_path_shade_kernels_match_plain(cuda, seed):
    """pt_primary and pt_bounce against their plain versions on the card,
    on a 480x288 frame's lanes (total 139,264, 2 samples) and a bounce of
    131,072 sorted lanes with K2's normals layout: uniforms, origins,
    radiance, hit and alive bit for bit; directions bit for bit or within
    2 ulp of 1 (cos / sin); one launch counted per call."""
    from rtmm_tpu_torch.ops import path_shade
    rng = np.random.default_rng(seed % 89)
    sc = path_shade.shading_consts(RenderConfig())
    n, total, spp = 138240, 139264, 2
    st = _pt_state(rng, n, cuda)
    args = (seed, total, spp, st["bn"], st["d"], st["o"], st["t"], st["hit"],
            sc)
    path_shade.reset_launches()
    k = path_shade.primary(*args, with_u=True)
    p = path_shade.primary_plain(*args, with_u=True)
    assert _pt_same(k, p, dirs=(2,))
    m, group = 131072, 1024
    sb = _pt_state(rng, m, cuda)
    idx = torch.randperm(spp * total, device=cuda)[:m].to(torch.int32)
    bn = sb["bn"].reshape(-1, group, 3).transpose(1, 2).contiguous()
    bargs = (seed, 2, total, bn.transpose(1, 2), sb["d"], sb["o"], sb["t"],
             sb["alive"], sb["rad"], idx, sc)
    k = path_shade.bounce(*bargs, with_u=True)
    p = path_shade.bounce_plain(*bargs, with_u=True)
    assert _pt_same(k, p, dirs=(3,))
    k = path_shade.bounce(*bargs, spawn=False)
    assert _pt_same(k, p[:2])
    torch.cuda.synchronize()
    assert path_shade.LAUNCHES == {"pt_primary": 1, "pt_bounce": 2}


# (pixels n, total, samples, offset of the base in lanes): lane counts
# that are not a multiple of 4 or 32, a base 12 bytes off a 16-byte
# boundary, pad pixels, 1 to 4 samples, no pixel at all.
PT_PRIMARY_CASES = [(2999, 3072, 1, 1), (1001, 1003, 4, 1), (37, 37, 2, 0),
                    (255, 1024, 2, 3), (0, 5, 2, 0), (513, 600, 0, 0)]
# (lanes, normals layout, offset, spawn, hit given).
PT_BOUNCE_CASES = [(3001, "rows", 1, True, False), (37, "rows", 1, True, True),
                   (2048, "k2", 0, False, False), (4096, "grouped", 0, True,
                                                   False),
                   (1003, "rows", 3, False, True), (0, "rows", 0, True, False)]


@pytest.mark.parametrize("case", range(len(PT_PRIMARY_CASES)))
def test_pt_primary_edges_match_plain(cuda, case):
    """pt_primary against its plain version on ragged lane counts, an
    offset base, pad pixels, 0 to 4 samples and zero / NaN normals."""
    from rtmm_tpu_torch.ops import path_shade
    n, total, spp, off = PT_PRIMARY_CASES[case]
    st = {k: v[off:] for k, v in _pt_state(np.random.default_rng(case),
                                           n + off, cuda).items()}
    args = (3, total, spp, st["bn"], st["d"], st["o"], st["t"], st["hit"],
            path_shade.shading_consts(RenderConfig()))
    for with_u in (False, True):
        k = path_shade.primary(*args, with_u=with_u)
        p = path_shade.primary_plain(*args, with_u=with_u)
        assert _pt_same(k, p, dirs=(2,)), (case, with_u)


@pytest.mark.parametrize("case", range(len(PT_BOUNCE_CASES)))
def test_pt_bounce_edges_match_plain(cuda, case):
    """pt_bounce against its plain version on ragged lane counts, an
    offset base, every normals layout, the last bounce's form, the per-ray
    engine's hit mask, zero / NaN normals and an empty state."""
    from rtmm_tpu_torch.ops import path_shade
    n, layout, off, spawn, given = PT_BOUNCE_CASES[case]
    rng = np.random.default_rng(10 + case)
    st = {k: v[off:] for k, v in _pt_state(rng, n + off, cuda).items()}
    bn = st["bn"]
    if layout == "k2":
        bn = bn.reshape(-1, 1024, 3).transpose(1, 2).contiguous()
        bn = bn.transpose(1, 2)
    elif layout == "grouped":
        bn = bn.reshape(-1, 1024, 3)
    idx = torch.from_numpy(rng.permutation(8192)[:n].astype(np.int32)).to(
        cuda)
    args = (5, 1, 4096, bn, st["d"], st["o"], st["t"], st["alive"],
            st["rad"], idx, path_shade.shading_consts(RenderConfig()))
    kw = dict(hit=st["hit"] if given else None, spawn=spawn)
    for with_u in ((False, True) if spawn else (False,)):
        k = path_shade.bounce(*args, **kw, with_u=with_u)
        p = path_shade.bounce_plain(*args, **kw, with_u=with_u)
        assert _pt_same(k, p, dirs=(3,)), (case, with_u)


@pytest.mark.parametrize("engine", ["pallas", "grouped"])
def test_pathtrace_kernels_equal_plain_frame(cuda, engine, monkeypatch):
    """A path-traced frame with pt_primary / pt_bounce against the same
    frame with their plain versions on the card's tensors: within config
    5's gate (bit for bit where cos / sin agree), live counts equal; one
    pt_primary and one pt_bounce per bounce."""
    from rtmm_tpu_torch.ops import path_shade
    scene = _scene(0, 3, cuda)
    cfg = RenderConfig(width=96, height=64, sub_frusta=8)
    pt = pathtrace.PathTraceConfig(bounces=3, samples_per_pixel=2,
                                   engine=engine)
    tracer = pathtrace.PathTracer(scene, cfg, pt)
    ivp = _ivp(96, 64)
    path_shade.reset_launches()
    img, st = tracer.render(ivp)
    torch.cuda.synchronize()
    assert path_shade.LAUNCHES == {"pt_primary": 1, "pt_bounce": 3}
    monkeypatch.setattr(path_shade, "primary", path_shade.primary_plain)
    monkeypatch.setattr(path_shade, "bounce", path_shade.bounce_plain)
    plain, pst = tracer.render(ivp)
    gate = image_gate(img, plain, per=500, big_per=500)
    print(f"bit-equal {torch.equal(img, plain)}; {gate}")
    assert gate["ok"]
    assert torch.equal(st["live_rays_per_bounce"],
                       pst["live_rays_per_bounce"])


def test_perray_backend_on_card_matches_cpu(cuda):
    """The per-ray reference backend (ops/traversal.py) on the card
    against the same code on the CPU, at 128x96: hit masks equal, t
    within 1e-5, and the same steps."""
    from rtmm_tpu_torch.ops import raygen, traversal

    make = lambda: procedural.make_icosphere(  # noqa: E731
        subdivisions=1, level=3, amplitude=0.12)
    gpu = scene_mod.build_device_scene(make(), hierarchy=True, device=cuda)
    cpu = scene_mod.build_device_scene(make(), hierarchy=True, device="cpu")
    cfg = RenderConfig(width=128, height=96)
    o, d = raygen.generate_rays(_ivp(128, 96), 128, 96, device="cpu")
    t_g, n_g, h_g, s_g = traversal.trace_with_steps(gpu, o.to(cuda),
                                                    d.to(cuda), cfg)
    t_c, n_c, h_c, s_c = traversal.trace_with_steps(cpu, o, d, cfg)
    assert torch.equal(h_g.cpu(), h_c) and int(h_c.sum()) > 1000
    assert float((t_g.cpu() - t_c).abs().max()) <= 1e-5
    assert float((n_g.cpu() - n_c)[h_c].abs().max()) <= 1e-5
    assert torch.equal(s_g.cpu(), s_c)
    img_g = Renderer(gpu, dataclasses.replace(cfg, pipeline="ray")).render(
        _ivp(128, 96))
    img_k = Renderer(gpu, cfg).render(_ivp(128, 96))
    assert int(((img_g - img_k).abs().amax(-1) > 1e-3).sum()) == 0


def test_perray_engine_on_card_matches_pallas(cuda):
    """The path tracer's perray engine against the pallas engine (K1d
    primaries, K2 bounces) at 64x48: the engine budgets of the JAX
    package's comparison (at most 5 pixels over 1e-4, live counts within
    4)."""
    scene = scene_mod.build_device_scene(
        procedural.make_icosphere(subdivisions=0, level=3, amplitude=0.1),
        hierarchy=True, device=cuda)
    cfg = RenderConfig(width=64, height=48, sub_frusta=8)
    pt = pathtrace.PathTraceConfig(bounces=2, samples_per_pixel=2,
                                   engine="perray")
    a, sa = pathtrace.PathTracer(scene, cfg, pt).render(_ivp(64, 48))
    b, sb = pathtrace.PathTracer(scene, cfg, dataclasses.replace(
        pt, engine="pallas")).render(_ivp(64, 48))
    npix = int(((a - b).abs().amax(-1) > 1e-4).sum())
    assert npix <= 5, npix
    assert float((sa["live_rays_per_bounce"]
                  - sb["live_rays_per_bounce"]).abs().max()) <= 4
    assert not bool(sa["overflow_groups_per_bounce"].any())


def test_debug_render_on_card_raises_on_nan(cuda):
    from rtmm_tpu_torch.utils.debug import debug_render

    scene = _scene(1, 3, cuda)
    cfg = RenderConfig(width=128, height=64)
    img = debug_render(scene, _ivp(128, 64), cfg)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    lv = scene.leaf_verts.clone()
    lv.reshape(-1)[int(torch.nonzero(lv.reshape(-1))[7])] = float("nan")
    with pytest.raises(FloatingPointError, match="leaf_verts"):
        debug_render(dataclasses.replace(scene, leaf_verts=lv),
                     _ivp(128, 64), cfg)


@pytest.mark.parametrize("shape,backend", [((1, 1), "nccl"),
                                           ((2, 1), "gloo")],
                         ids=["1x1_nccl", "2x1_gloo"])
def test_sharded_trace_matches_single_card(cuda, shape, backend):
    """render_tiled_sharded(backend="pallas") over NCCL (one rank) and
    over gloo (two ranks sharing the card): each rank's tile rows are bit
    for bit the single-card windowed trace's (t, summed normals, visits),
    and every rank launched the windowed kernel (K1b) once per window."""
    from rtmm_tpu_torch.ops import _build
    from rtmm_tpu_torch.parallel import entry, launch

    _build.build_all()      # in the parent, before the ranks start
    w, h = 256, 64
    cfg = RenderConfig(width=w, height=h, kernel_clusters_per_window=1)
    scene = _scene(1, 3, "cpu")                       # 2 clusters
    job = dict(shape=shape, device="cuda", scene="s", cfg=cfg,
               ivp=_ivp(w, h), pipeline="tile", backend="pallas")
    results = [r[0] for r in launch.spawn(
        entry.render_jobs, shape[0] * shape[1], "cuda",
        args=({"s": scene_mod.scene_arrays(scene)}, [job]), timeout_s=300)]
    scene_c = _scene(1, 3, cuda)
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene_c, _ivp(w, h), cfg)
    t0, n0, vis0, _, windows = tile_trace.trace_windows(
        scene_c, fi, frus, raymat, cfg, 1)
    t0, n0, vis0 = (t0.cpu().numpy(), n0.transpose(1, 2).cpu().numpy(),
                    vis0.cpu().numpy())
    for r in results:
        tr = r["trace"]
        rows = slice(tr["tile0"], tr["tile0"] + tr["t"].shape[0])
        # The backend the launcher chose: NCCL for one rank, gloo for
        # ranks that share a card (the ids name the one-card case).
        assert r["backend"] == launch.choose_backend(len(results), "cuda")
        assert r["chosen"] == ("tile-sharded", "pallas")
        # Per window one trace launch and one cluster_select, beside the
        # rank's tile_frusta and the cull's cluster_select.
        assert r["launches"] == {"tile_trace_windowed": tr["windows"],
                                 "tile_frusta": 1,
                                 "cluster_select": 1 + tr["windows"]}
        assert tr["windows"] >= 2
        np.testing.assert_array_equal(tr["t"], t0[rows])
        np.testing.assert_array_equal(tr["n"], n0[rows])
        np.testing.assert_array_equal(tr["visits"], vis0[rows])
    assert sum(int(r["trace"]["visits"].sum()) for r in results) == int(
        vis0.sum()) > 0
    assert windows >= 2


def test_bench_row_on_card(cuda, capsys):
    """python3 -m rtmm_tpu_torch.bench --config 2 on the card: rc 0, a
    positive value, the pin's 95 visits, bench.py's verify within budget,
    bench.py's keys, and the orbit through one batched fused launch."""
    import json

    from rtmm_tpu_torch import bench

    capsys.readouterr()
    assert bench.main(["--config", "2"]) == 0
    out = capsys.readouterr()
    row = json.loads(out.out.strip().splitlines()[-1])
    assert tuple(row) == bench.ROW_KEYS["image"]
    assert row["value"] > 0
    assert row["visits"] == row["visits_expected"] == 95
    assert row["verify_mode"] == "pixel"
    assert row["verify_npix"] <= row["verify_budget"]
    assert row["verify_nbig"] <= row["verify_big_budget"]
    launches = json.loads(next(
        line for line in out.err.splitlines()
        if line.startswith("[bench launches] "))[len("[bench launches] "):])
    # 256 frames of 64 tiles in one launch per call: warm-up + 4 calls,
    # each with its prologue's tile_frusta and cluster_select launch.
    once = {"tile_frusta": 1, "cluster_select": 1}
    assert launches["orbit"] == {"tile_trace_fused": 5,
                                 **{k: 5 for k in once}}
    assert launches["visits"] == {"tile_trace_fused": 1, **once}


# ----------------------------------------------------------------------
# The prologue kernels (csrc/prologue.cu) against their plain versions.

def _bits_equal(a, b):
    """Equal shapes, dtypes and bits (float32 compared as int32); None
    matches None."""
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _orbit(w, h, n, dist=3.0):
    return np.stack([_ivp(w, h, 25.0 + 360.0 / n * k) for k in range(n)])


@pytest.mark.parametrize("pack", [None, "plain", "raygen"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tile_frusta_matches_plain(cuda, grid, pack):
    """A 4-frame 1080p chunk (the padded grid at 100x80), every output
    bit for bit; a tile range of the plain pack too."""
    cfg, w, h = _grid_cfg(grid, 1920, 1080)
    pw, ph = tiled.padded_size(w, h)
    ivps = torch.as_tensor(_orbit(w, h, 4), dtype=torch.float32,
                           device=cuda)
    box = torch.tensor([-2.0, -2.0, -2.0, 2.0, 2.0, 2.0], device=cuda)
    n_all = (pw // 32) * (ph // 32)
    ranges = [None] + ([(3, n_all - 5)] if pack != "raygen" else [])
    for tiles in ranges:
        for m in (ivps, ivps[1]):
            args = (m, w, h, pw, ph, cfg.sub_frusta, cfg.sub_rows)
            kw = dict(tiles=tiles, pack=pack, scene_aabb=box)
            before = prologue.LAUNCHES["tile_frusta"]
            k = prologue.tile_frusta(*args, **kw)
            torch.cuda.synchronize()
            assert prologue.LAUNCHES["tile_frusta"] == before + 1
            p = prologue.tile_frusta_plain(*args, **kw)
            for a, b in zip(k, p):
                assert _bits_equal(a, b)


def _select_case(cuda, name):
    """(scene, cfg, frames) of a cluster_select case: config 3's asset
    (20 clusters) and config 6's plane (200 clusters) at 1080p."""
    if name == "config3":
        mesh = procedural.make_icosphere(subdivisions=3, level=3,
                                         amplitude=0.12)
    else:
        mesh = procedural.make_plane(grid=(160, 160), level=2,
                                     amplitude=0.05)
    return (scene_mod.build_device_scene(mesh, device=cuda),
            RenderConfig(width=1920, height=1080), 8)


@pytest.mark.parametrize("name", ["config3", "config6"])
def test_cluster_select_matches_plain_on_chunks(cuda, name):
    """The fused chunk's cull + select, and frames_inputs' rows, bit for
    bit against the plain versions."""
    scene, cfg, n = _select_case(cuda, name)
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    ivps = torch.as_tensor(_orbit(cfg.width, cfg.height, n),
                           dtype=torch.float32, device=cuda)
    fr = prologue.tile_frusta(ivps, cfg.width, cfg.height, pw, ph,
                              cfg.sub_frusta, cfg.sub_rows)
    kc = tile_trace.clusters_per_window(scene, cfg)
    args = (fr.apex, fr.normals.reshape(-1, 4, 3), scene.cluster_aabb_min,
            scene.cluster_aabb_max, scene.cluster_valid, kc)
    kw = dict(rows_per_apex=fr.normals.shape[1], want_hit=True,
              want_any=True)
    before = prologue.LAUNCHES["cluster_select"]
    k = prologue.cluster_select(*args, **kw)
    torch.cuda.synchronize()
    assert prologue.LAUNCHES["cluster_select"] == before + 1
    p = prologue.cluster_select_plain(*args, **kw)
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    assert int(k.ccount.sum()) > 0 and int(k.ccount.max()) <= kc
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prologue, "tile_frusta", prologue.tile_frusta_plain)
        mp.setattr(prologue, "cluster_select", prologue.cluster_select_plain)
        want = tile_trace.frames_inputs(scene, ivps, cfg, kc)
    got = tile_trace.frames_inputs(scene, ivps, cfg, kc)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)


def test_cluster_select_windows_on_card(cuda):
    """Two windows of config 7's construction cut to a 160x160 grid (800
    clusters) in windows of 16: lists, masks and bounds bit for bit, and
    more clusters surviving than a window takes."""
    mesh = procedural.make_plane(grid=(160, 160), level=3, amplitude=0.05)
    scene = scene_mod.build_device_scene(mesh, compressed=True, device=cuda)
    cfg = RenderConfig(width=1920, height=1080,
                       kernel_clusters_per_window=16)
    fi, _, _ = tile_trace.ray_frame_inputs(scene, _ivp(1920, 1080), cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prologue, "tile_frusta", prologue.tile_frusta_plain)
        mp.setattr(prologue, "cluster_select", prologue.cluster_select_plain)
        fi_p, _, _ = tile_trace.ray_frame_inputs(scene, _ivp(1920, 1080),
                                                 cfg)
    assert _bits_equal(fi.cluster_hit, fi_p.cluster_hit)
    assert _bits_equal(fi.frus, fi_p.frus)
    remaining = fi.cluster_hit
    assert int(remaining.sum(dim=1).max()) > 16
    for _ in range(2):
        args = (fi.apex[None], None, scene.cluster_aabb_min,
                scene.cluster_aabb_max, None, 16)
        kw = dict(remaining=remaining, rows_per_apex=remaining.shape[0],
                  window=True)
        k = prologue.cluster_select(*args, **kw)
        p = prologue.cluster_select_plain(*args, **kw)
        for a, b in zip(k, p):
            assert _bits_equal(a, b)
        assert bool(torch.isfinite(k.next_bound).any())
        remaining = k.new_remaining


@pytest.mark.parametrize("kc", [7, 1500, 5000])
def test_cluster_select_ties_and_chunks(cuda, kc):
    """5,000 boxes on a lattice (many equal distances: ties go to the
    lower index), lists longer than one sorted chunk (1,500 > 1,024) and
    as long as the scene (5,000): the window form bit for bit."""
    g = np.random.default_rng(3)
    c = 5000
    lo = np.round(g.uniform(-4, 4, (c, 3)) * 2) / 2
    lo = torch.tensor(lo, dtype=torch.float32, device=cuda)
    hi = lo + 0.25
    apex = torch.tensor([[0.1, 0.3, -0.2], [2.0, 0.0, 0.5]], device=cuda)
    remaining = torch.tensor(g.random((6, c)) < 0.7, device=cuda)
    args = (apex, None, lo, hi, None, kc)
    kw = dict(remaining=remaining, rows_per_apex=3, window=True)
    k = prologue.cluster_select(*args, **kw)
    p = prologue.cluster_select_plain(*args, **kw)
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    ties = k.centry[:, 1:] == k.centry[:, :-1]
    assert kc == 7 or bool((ties & torch.isfinite(k.centry[:, 1:])).any())


def _special_boxes(g, c, dev):
    """c boxes with equal distances (a lattice, and boxes around the
    apexes: distance 0), +inf distances (a coordinate at +inf) and NaN
    distances (a NaN coordinate)."""
    lo = np.round(g.uniform(-4, 4, (c, 3)) * 2) / 2
    hi = lo + 0.25
    k = max(1, c // 10)
    pick = g.choice(c, 3 * k, replace=False)
    lo[pick[:k], 0] = hi[pick[:k], 0] = np.inf
    lo[pick[k:2 * k], 1] = np.nan
    lo[pick[2 * k:]], hi[pick[2 * k:]] = -50.0, 50.0
    return (torch.tensor(lo, dtype=torch.float32, device=dev),
            torch.tensor(hi, dtype=torch.float32, device=dev))


def _select_matches_plain(args, kw):
    """cluster_select on the card: one launch, every output bit for bit
    the plain version's (NaN entries with their bits)."""
    before = prologue.LAUNCHES["cluster_select"]
    k = prologue.cluster_select(*args, **kw)
    torch.cuda.synchronize()
    assert prologue.LAUNCHES["cluster_select"] == before + 1
    p = prologue.cluster_select_plain(*args, **kw)
    for f, a, b in zip(prologue.Selection._fields, k, p):
        assert _bits_equal(a, b), f
    return k


# Cluster counts of the three list paths: the warp's (C <= 32), the
# block's shared-memory order, and past its capacity, the per-row select.
SELECT_PATHS = {"warp": 24, "block": 700, "past_capacity": None}


@pytest.mark.parametrize("path", sorted(SELECT_PATHS))
def test_prologue_select_nan_inf_ties(cuda, path):
    """Boxes at NaN, +inf and equal distances on each list path: the cull
    alone (hit mask; any-hit), the cull with its lists, hit and any-hit
    masks and cleared rows; two windows over a remaining mask, kc below
    C; rows sharing an apex."""
    g = np.random.default_rng(11)
    c = SELECT_PATHS[path] or prologue.select_capacity() + 1000
    lo, hi = _special_boxes(g, c, cuda)
    apex = torch.tensor(g.uniform(-1, 1, (2, 3)), dtype=torch.float32,
                        device=cuda)
    rows = 2 * 24
    planes = torch.tensor(g.normal(size=(rows, 4, 3)), dtype=torch.float32,
                          device=cuda)
    valid = torch.tensor(g.random(c) < 0.9, device=cuda)
    row_valid = torch.tensor(g.random(rows) < 0.8, device=cuda)
    for want in ("hit", "any"):  # the cull alone, its clusters split
        _select_matches_plain(   # over blocks for the hit mask
            (apex, planes, lo, hi, valid, 0),
            {"rows_per_apex": 24, "row_valid": row_valid,
             f"want_{want}": True})
    for kc in (min(c, 7), c // 3, c):
        sel = _select_matches_plain(
            (apex, planes, lo, hi, valid, kc),
            dict(rows_per_apex=24, row_valid=row_valid, want_hit=True,
                 want_any=True))
    assert bool(torch.isnan(sel.centry).any())
    assert bool(torch.isinf(sel.centry).any())
    remaining = torch.tensor(g.random((rows, c)) < 0.4, device=cuda)
    kc = max(2, c // 8)
    for _ in range(2):
        sel = _select_matches_plain(
            (apex, None, lo, hi, None, kc),
            dict(remaining=remaining, rows_per_apex=24, window=True))
        remaining = sel.new_remaining
    assert bool(remaining.any())


@pytest.mark.parametrize("kc", [50, 1100])
def test_prologue_select_past_shared_capacity(cuda, kc):
    """40,000 clusters, past the shared-memory order's capacity, over 64
    rows: the per-row radix select, lists shorter and longer than 1,024,
    the cull form and two windows, bit for bit."""
    c = 40000
    assert c > prologue.select_capacity()
    g = np.random.default_rng(12)
    lo = torch.tensor(g.uniform(-8, 8, (c, 3)), dtype=torch.float32,
                      device=cuda)
    hi = lo + torch.tensor(g.uniform(0.01, 0.3, (c, 1)),
                           dtype=torch.float32, device=cuda)
    apex = torch.tensor([[0.2, -0.1, 0.3], [1.0, 2.0, -0.5]], device=cuda)
    planes = torch.tensor(g.normal(size=(64, 4, 3)), dtype=torch.float32,
                          device=cuda)
    valid = torch.ones(c, dtype=torch.bool, device=cuda)
    _select_matches_plain((apex, planes, lo, hi, valid, kc),
                          dict(rows_per_apex=32, want_any=True))
    remaining = torch.tensor(g.random((64, c)) < 0.2, device=cuda)
    for _ in range(2):
        sel = _select_matches_plain(
            (apex, None, lo, hi, None, kc),
            dict(remaining=remaining, rows_per_apex=32, window=True))
        remaining = sel.new_remaining
    assert int(sel.ccount.min()) == kc


@pytest.mark.parametrize("c", [24, 700])
def test_prologue_select_own_apex_per_row(cuda, c):
    """rows_per_apex = 1 (the merged instanced rows: an apex per row), on
    the warp and block paths, with cleared rows."""
    g = np.random.default_rng(13)
    lo, hi = _special_boxes(g, c, cuda)
    rows = 37
    apex = torch.tensor(g.uniform(-1, 1, (rows, 3)), dtype=torch.float32,
                        device=cuda)
    planes = torch.tensor(g.normal(size=(rows, 4, 3)), dtype=torch.float32,
                          device=cuda)
    valid = torch.tensor(g.random(c) < 0.9, device=cuda)
    row_valid = torch.tensor(g.random(rows) < 0.7, device=cuda)
    for kc in (5, c):
        _select_matches_plain((apex, planes, lo, hi, valid, kc),
                              dict(row_valid=row_valid, want_hit=True))


@pytest.mark.parametrize("grid", [(4, 1), (8, 2), (1, 1)])
def test_prologue_frusta_tile_ranges(cuda, grid):
    """Tile ranges that start and end inside a tile row and inside a
    block's 8 x 4 group, one tile, every pack form (raygen on the whole
    frame), bit for bit."""
    nsub, nrows = grid
    w, h = 1000, 600
    pw, ph = tiled.padded_size(w, h)
    n_all = (pw // 32) * (ph // 32)
    ivps = torch.as_tensor(_orbit(w, h, 3), dtype=torch.float32,
                           device=cuda)
    box = torch.tensor([-2.0, -2.0, -2.0, 2.0, 2.0, 2.0], device=cuda)
    for pack in (None, "plain", "raygen"):
        ranges = [None] if pack == "raygen" else [
            None, (0, 1), (37, 1), (5, 70), (33, n_all - 40), (n_all - 9, 9)]
        for tiles in ranges:
            args = (ivps, w, h, pw, ph, nsub, nrows)
            kw = dict(tiles=tiles, pack=pack, scene_aabb=box)
            before = prologue.LAUNCHES["tile_frusta"]
            k = prologue.tile_frusta(*args, **kw)
            torch.cuda.synchronize()
            assert prologue.LAUNCHES["tile_frusta"] == before + 1
            p = prologue.tile_frusta_plain(*args, **kw)
            for a, b in zip(k, p):
                assert _bits_equal(a, b), (pack, tiles)


def test_instanced_rows_on_card(cuda):
    """The merged launch's inputs (instance cull, row select) and the
    serial path's cull bit for bit against the plain versions."""
    scene = _scene(1, 3, cuda)
    cfg = RenderConfig(width=480, height=288)
    ivp = _ivp_far(480, 288)
    rot, trn, scl = inst_mod.instance_tensors(RING * 4, cuda)

    def inputs():
        world = inst_mod.world_frame(ivp, cfg, cuda)
        cam = inst_mod._object_camera(scene, rot[1], trn[1], scl[1], world)
        return (*world, *inst_mod.merged_launch_inputs(
            scene, rot, trn, scl, ivp, world, cfg), *cam)

    prologue.reset_launches()
    got = inputs()
    torch.cuda.synchronize()
    assert prologue.LAUNCHES == {"tile_frusta": 1, "cluster_select": 3}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prologue, "tile_frusta", prologue.tile_frusta_plain)
        mp.setattr(prologue, "cluster_select", prologue.cluster_select_plain)
        want = inputs()
    for a, b in zip(got, want):
        assert _bits_equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_reference_backends_launch_no_prologue_kernel(cuda):
    """The XLA tile backend and the candidate counts, the references the
    kernels' frames are held against, keep the plain prologue on the
    card: no prologue kernel launches."""
    scene = _scene(1, 3, cuda)
    w, h = 256, 128
    cfg = RenderConfig(width=w, height=h)
    prologue.reset_launches()
    img = tiled.render_tiled(scene, _ivp(w, h), cfg)
    tiled.candidate_counts(scene, _ivp(w, h), cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())
    assert prologue.LAUNCHES == {"tile_frusta": 0, "cluster_select": 0}


def test_prologue_paths_stay_off_the_plain_versions(cuda, monkeypatch):
    """On the card every prologue path launches the kernels: the plain
    versions raise if a CUDA tensor reaches them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain prologue")

    monkeypatch.setattr(prologue, "tile_frusta_plain", refuse)
    monkeypatch.setattr(prologue, "cluster_select_plain", refuse)
    scene = _scene(1, 3, cuda)
    w, h = 256, 128
    prologue.reset_launches()
    tile_trace.render_frames(scene, _orbit(w, h, 3), RenderConfig(
        width=w, height=h))
    assert prologue.LAUNCHES == {"tile_frusta": 1, "cluster_select": 1}
    prologue.reset_launches()
    _, st = tile_trace.render_frame(_scene(2, 3, cuda), _ivp(w, h),
                                    RenderConfig(width=w, height=h,
                                                 kernel_clusters_per_window=2),
                                    with_stats=True)
    assert st["windows"] > 1
    assert prologue.LAUNCHES == {"tile_frusta": 1,
                                 "cluster_select": 1 + st["windows"]}
    prologue.reset_launches()
    tile_trace.render_frame(scene, _ivp(w, h), RenderConfig(
        width=w, height=h, kernel_raygen=False))
    assert prologue.LAUNCHES == {"tile_frusta": 1, "cluster_select": 2}
    prologue.reset_launches()
    inst_mod.render_instanced(scene, RING, _ivp_far(w, h),
                              RenderConfig(width=w, height=h))
    assert prologue.LAUNCHES == {"tile_frusta": 1, "cluster_select": 2}
    prologue.reset_launches()
    inst_mod.render_instanced(scene, RING, _ivp_far(w, h),
                              RenderConfig(width=w, height=h), serial=True)
    assert prologue.LAUNCHES["tile_frusta"] == 1
    assert prologue.LAUNCHES["cluster_select"] >= len(RING) + 1
    with pytest.raises(ValueError):
        prologue.cluster_select(torch.zeros((1, 3), device=cuda), None,
                                scene.cluster_aabb_min,
                                scene.cluster_aabb_max, None, 2)
