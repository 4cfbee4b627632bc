"""The trace kernels against their plain PyTorch versions, on the card:
the tile trace in every mode (fused with precomputed and compressed
tables, in-kernel raygen or a ray matrix; windowed; raw with both ray
sources) and the instanced frames built on it; the grouped trace (K2) on
random ray groups over precomputed, compressed and compressed indexed
scenes, and path-traced frames through both secondary engines.

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
from rtmm_tpu_torch.ops import culling, group_trace, tiled, tile_trace
from rtmm_tpu_torch.render import instances as inst_mod
from rtmm_tpu_torch.render import pathtrace
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
