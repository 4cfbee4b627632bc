"""The prologue kernels' wrappers (ops/prologue.py: tile_frusta,
cluster_select) on the CPU, where they run their plain versions.

  (a) against the JAX package: the frusta against culling.tile_frustums /
      tile_sub_frustums and the raygen pack, the lists of a batch of
      frames against render_pallas_frames' jax.vmap(frame_inputs) with
      jax.lax.top_k (rtmm_tpu/ops/pallas_tiled.py:1490-1509),
      tiled.cluster_window over two windows, and the instanced cull and
      top-k (rtmm_tpu/render/instances.py:478-554) on the port's
      object-space cameras. Tolerances are tests/test_torch_prologue.py's
      (queue 3 of ROADMAP.md): apex, cull, lists and counts exact; plane
      normals within 2 ulp of 1, centry within 2 ulp (XLA's CPU FMA
      contraction), its +inf tail exact;
  (b) ties go to the lower cluster index, and a window with more
      survivors than kc clears exactly the selected ones and bounds the
      rest (numpy's lexicographic order as the reference);
  (c) the wrappers' plain path gives, bit for bit, the rows the port's
      prologue gave before the kernels (frames_inputs, cluster_window and
      the merged launch's world frame and lists): that composition, with
      its .sum(-1) dots, is kept below;
  (d) the rules the kernels rest on (csrc/prologue.cu runs only on the
      card): a row's list is its apex's (distance, index) order filtered
      by the row's held mask, then the +inf keys and the NaN keys in index
      order, and a window keeps the held keys after the kc-th, held with
      hypothesis against cluster_select_plain; and every tile's corner
      directions are those of the frame's shared corner lattice, bit for
      bit, so each corner is computed once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import culling as jculling
from rtmm_tpu.ops import tiled as jtiled
from rtmm_tpu.utils import cache as jcache
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import scene as scene_mod
from rtmm_tpu_torch.ops import _f32, culling, prologue, tiled, tile_trace
from rtmm_tpu_torch.render import instances as inst_mod
from rtmm_tpu_torch.utils import camera

# One intra-op thread, as in tests/test_torch_prologue.py: a multi-threaded
# PyTorch op right after a JAX computation was seen to glitch.
torch.set_num_threads(1)

W, H = 200, 80          # padded to 224x96: 7 x 3 tiles, the last partial
PW, PH = 224, 96
EPS = 2.0 ** -24        # ulp of values in [0.5, 1)
GRIDS = [(4, 1), (8, 2)]

MESHES = {
    "icosphere1_level3": lambda: jproc.make_icosphere(
        subdivisions=1, level=3, amplitude=0.1),
    # Flat: seen from straight above, the boxes around the apex's foot
    # are at equal distances (ties).
    "plane32_flat": lambda: jproc.make_plane(grid=(32, 32), level=2,
                                             amplitude=0.0),
}


def _camera(pitch, yaw, dist, w=W, h=H):
    tb = camera.Trackball()
    tb.set_camera([0.0, 0.0, 0.0], [np.radians(pitch), np.radians(yaw), 0.0],
                  dist)
    return camera.inv_view_proj(tb, w, h)


_rng = np.random.default_rng(14)
IVPS = np.stack([_camera(-90.0, 0.0, 3.0)]
                + [_camera(float(_rng.uniform(-70, 70)),
                           float(_rng.uniform(0, 360)),
                           float(_rng.uniform(2.0, 4.0))) for _ in range(3)])


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, the port's scene on the same tables)."""
    out = {}
    for name, make in MESHES.items():
        ref = jscene.build_device_scene(make(), hierarchy=False)
        arrays = {k: np.asarray(v) for k, v in (
            (f, getattr(ref, f)) for f in ref.__dataclass_fields__)
            if v is not None and k not in jcache._META_FIELDS}
        arrays.update(jcache._meta_arrays(ref))
        out[name] = ref, scene_mod.scene_from_arrays(arrays, device="cpu")
    return out


def _ulps(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    a = np.asarray(a, np.float32).ravel().view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).ravel().view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _bits(x) -> bytes:
    return np.asarray(x).tobytes()


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert _bits(a.contiguous().numpy()) == _bits(b.contiguous().numpy())


def _entries_close(got, want):
    """centry: the +inf tail exact, the finite entries within 2 ulp."""
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert _ulps(got[fin], want[fin]) <= 2


# ----------------------------------------------------------------------
# (a) against the JAX package.

@pytest.mark.parametrize("n_sub,n_rows", GRIDS)
def test_tile_frusta_matches_jax(scenes, n_sub, n_rows):
    box = scenes["icosphere1_level3"][1].exit_aabb
    fr = prologue.tile_frusta(IVPS, W, H, PW, PH, n_sub, n_rows,
                              pack="raygen", scene_aabb=box)
    jivp = jnp.asarray(IVPS, jnp.float32)
    apex, normals = jax.vmap(lambda m: jculling.tile_frustums(
        m, W, H, PW, PH))(jivp)
    sub = jax.vmap(lambda m: jculling.tile_sub_frustums(
        m, W, H, PW, PH, n_sub=n_sub, n_rows=n_rows))(jivp)
    np.testing.assert_array_equal(fr.apex.numpy().view(np.int32),
                                  np.asarray(apex).view(np.int32))
    assert np.abs(fr.normals.numpy() - np.asarray(normals)).max() <= 4 * EPS
    assert np.abs(fr.sub_normals.numpy() - np.asarray(sub)).max() <= 4 * EPS
    assert fr.frus.shape == (4, 21, tiled.frustum_pack_len(n_sub, True))
    planes = slice(3, 3 + 12 * n_sub)
    np.testing.assert_array_equal(fr.frus[..., :3].numpy(),
                                  np.broadcast_to(np.asarray(apex)[:, None],
                                                  (4, 21, 3)))
    _same_bits(fr.frus[..., planes], fr.sub_normals.reshape(4, 21, -1))
    np.testing.assert_array_equal(
        fr.frus[..., planes.stop + 2:planes.stop + 18].numpy(),
        np.broadcast_to(IVPS.reshape(4, 1, 16).astype(np.float32),
                        (4, 21, 16)))


def _jax_batch_lists(ref, ivps, kc):
    """The batched prologue's lists as render_pallas_frames builds them:
    jax.vmap of build_frame_inputs, aabb_distance and jax.lax.top_k."""
    jcfg = JaxConfig(width=W, height=H)

    def frame(ivp):
        fi = jtiled.build_frame_inputs(ref, ivp, jcfg, need_q_frame=False,
                                       need_rays=False)
        cl_dist = jculling.aabb_distance(fi.apex, ref.cluster_aabb_min,
                                         ref.cluster_aabb_max)
        key = jnp.where(fi.cluster_hit, -cl_dist[None, :], -jnp.inf)
        negd, cidx = jax.lax.top_k(key, kc)
        sel = negd > -jnp.inf
        return (cidx.astype(jnp.int32), sel.sum(axis=1).astype(jnp.int32),
                jnp.where(sel, -negd, jnp.inf).astype(jnp.float32),
                fi.cluster_hit)

    out = jax.vmap(frame)(jnp.asarray(ivps, jnp.float32))
    return [np.asarray(x).reshape((-1,) + x.shape[2:]) for x in out]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_batch_lists_match_jax_top_k(scenes, name):
    ref, scene = scenes[name]
    kc = scene.num_clusters
    fr = prologue.tile_frusta(IVPS, W, H, PW, PH, 4, 1)
    sel = prologue.cluster_select(
        fr.apex, fr.normals.reshape(-1, 4, 3), scene.cluster_aabb_min,
        scene.cluster_aabb_max, scene.cluster_valid, kc, rows_per_apex=21,
        want_hit=True, want_any=True)
    ccand, ccount, centry, hit = _jax_batch_lists(ref, IVPS, kc)
    assert sel.ccand.numpy().tobytes() == ccand.tobytes()
    assert sel.ccount.numpy().tobytes() == ccount.tobytes()
    _entries_close(sel.centry.numpy(), centry)
    np.testing.assert_array_equal(sel.hit.numpy(), hit)
    np.testing.assert_array_equal(sel.any.numpy(), hit.any(axis=1))
    assert int(sel.ccount.sum()) > 0


def test_cluster_window_two_windows_match_jax(scenes):
    """Windows of 3 clusters, twice, from the same cull on both sides."""
    ref, scene = scenes["plane32_flat"]
    cfg = RenderConfig(width=W, height=H)
    ivp = IVPS[1]
    fi = tiled.build_frame_inputs(scene, ivp, cfg, need_rays=False,
                                  kernels=True)
    jfi = jtiled.build_frame_inputs(ref, jnp.asarray(ivp), JaxConfig(
        width=W, height=H), need_q_frame=False, need_rays=False)
    np.testing.assert_array_equal(fi.cluster_hit.numpy(),
                                  np.asarray(jfi.cluster_hit))
    rem, jrem = fi.cluster_hit, jfi.cluster_hit
    assert int(rem.sum(dim=1).max()) > 3
    for _ in range(2):
        got = tiled.cluster_window(scene, fi.apex, rem, 3)
        want = jtiled.cluster_window(ref, jfi.apex, jrem, 3)
        assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
        assert got[1].numpy().tobytes() == np.asarray(want[1]).tobytes()
        _entries_close(got[2].numpy(), want[2])
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        _entries_close(got[4].numpy(), want[4])
        rem, jrem = got[3], want[3]
    assert bool(rem.any())


RING = [inst_mod.Instance.from_euler([1.5 * np.cos(a), 1.5 * np.sin(a),
                                      0.1], (0.1, a, 0.2), 0.9)
        for a in (0.0, 2.1, 4.2)]


def test_instanced_cull_and_top_k_match_jax(scenes):
    """instance_cull's any-hit and the merged rows' lists against the JAX
    package's vmapped cull and per-row top_k (instances.py:478-554), both
    on the port's object-space cameras."""
    ref, scene = scenes["icosphere1_level3"]
    cfg = RenderConfig(width=W, height=H)
    ivp = _camera(-30.0, 25.0, 5.0)
    rot, trn, scl = inst_mod.instance_tensors(RING, "cpu")
    world = inst_mod.world_frame(ivp, cfg, "cpu")
    _, apex_o, normals_o, tile_sees = inst_mod.instance_cull(
        scene, rot, trn, scl, world)
    launch = inst_mod.merged_launch_inputs(scene, rot, trn, scl, ivp, world,
                                           cfg)
    ja, jn = jnp.asarray(apex_o.numpy()), jnp.asarray(normals_o.numpy())
    hit = jax.vmap(lambda a, nm: jculling.cull_units(
        a, nm, ref.cluster_aabb_min, ref.cluster_aabb_max,
        ref.cluster_valid))(ja, jn)
    np.testing.assert_array_equal(tile_sees.numpy(),
                                  np.asarray(hit.any(axis=2)))
    cl_dist = jculling.aabb_distance(ja[:, None, :], ref.cluster_aabb_min,
                                     ref.cluster_aabb_max)
    ri, rt = launch.row_inst.numpy(), launch.row_tile.numpy()
    ckey = jnp.where(hit[ri, rt] & launch.row_valid.numpy()[:, None],
                     -cl_dist[ri], -jnp.inf)
    negd, cidx = jax.lax.top_k(ckey, scene.num_clusters)
    csel = negd > -jnp.inf
    assert launch.ccand.numpy().tobytes() == np.asarray(
        cidx, np.int32).tobytes()
    np.testing.assert_array_equal(launch.ccount.numpy(),
                                  np.asarray(csel.sum(axis=1)))
    _entries_close(launch.centry.numpy(),
                   np.where(csel, -negd, np.inf).astype(np.float32))
    assert int(launch.ccount.sum()) > 0


# ----------------------------------------------------------------------
# (b) ties and windows, against numpy's lexicographic order.

def _boxes(centers, half=0.25):
    c = torch.tensor(centers, dtype=torch.float32)
    return c - half, c + half


def _lex_lists(dist, remaining, kc):
    """(ccand, ccount, centry): per row the first kc of (key, index),
    key = dist where remaining else +inf."""
    out = []
    for rem in remaining:
        key = np.where(rem, dist, np.inf)
        order = np.lexsort((np.arange(key.size), key))[:kc]
        out.append((order, int(np.isfinite(key[order]).sum()), key[order]))
    return [np.stack(x) for x in zip(*out)]


def test_ties_go_to_the_lower_index():
    """Twelve boxes on a ring around the apex (equal distances) and four
    farther ones, two rows with different remaining sets."""
    ang = np.arange(12) * np.pi / 6
    ring = np.stack([2 * np.cos(ang), 2 * np.sin(ang), 0 * ang], 1)
    far = [[5.0, 0.0, 0.0], [0.0, 5.0, 0.0], [-5.0, 0.0, 0.0], [3.0, 4.0, 0]]
    lo, hi = _boxes(np.concatenate([far[:2], ring, far[2:]]))
    apex = torch.zeros((1, 3))
    dist = culling.aabb_distance(apex, lo, hi).numpy()
    remaining = np.ones((2, 16), bool)
    remaining[1, [3, 4, 9]] = False
    for kc in (5, 16):
        sel = prologue.cluster_select(apex, None, lo, hi, None, kc,
                                      remaining=torch.tensor(remaining),
                                      rows_per_apex=2)
        ccand, ccount, centry = _lex_lists(dist, remaining, kc)
        np.testing.assert_array_equal(sel.ccand.numpy(), ccand)
        np.testing.assert_array_equal(sel.ccount.numpy(), ccount)
        np.testing.assert_array_equal(sel.centry.numpy(), centry)
        top = jax.lax.top_k(jnp.where(jnp.asarray(remaining),
                                      -jnp.asarray(dist), -jnp.inf), kc)[1]
        np.testing.assert_array_equal(sel.ccand.numpy(), np.asarray(top))
    # Equal distances among the ring's boxes: ascending index among them.
    assert len(set(dist[2:14].tolist())) < 12
    assert sel.ccand[0, :5].tolist() == sorted(sel.ccand[0, :5].tolist())


def test_window_with_more_survivors_than_kc():
    """40 boxes, 3 rows, windows of 6 until none remains: each window
    takes the next 6 in (distance, index) order, new_remaining keeps
    exactly those after them, next_bound is their nearest distance."""
    g = np.random.default_rng(5)
    centers = np.round(g.uniform(-6, 6, (40, 3)) * 2) / 2
    lo, hi = _boxes(centers)
    apex = torch.tensor([[0.3, -0.2, 0.1]])
    dist = culling.aabb_distance(apex, lo, hi).numpy()
    remaining = torch.tensor(g.random((3, 40)) < 0.8)
    order = [np.lexsort((np.arange(40), np.where(r, dist, np.inf)))
             [:int(r.sum())] for r in remaining.numpy()]
    taken = [[] for _ in range(3)]
    rem = remaining
    while bool(rem.any()):
        sel = prologue.cluster_select(apex, None, lo, hi, None, 6,
                                      remaining=rem, rows_per_apex=3,
                                      window=True)
        for r in range(3):
            n = int(sel.ccount[r])
            taken[r] += sel.ccand[r, :n].tolist()
            left = order[r][len(taken[r]):]
            np.testing.assert_array_equal(
                np.flatnonzero(sel.new_remaining[r].numpy()), np.sort(left))
            want = dist[left].min() if left.size else np.inf
            assert float(sel.next_bound[r]) == want
            assert n == min(6, int(rem[r].sum()))
        rem = sel.new_remaining
    for r in range(3):
        assert taken[r] == order[r].tolist()


# ----------------------------------------------------------------------
# (c) the prologue as the port composed it before the kernels.

def _old_dot(a, b):
    return (a * b).sum(-1)


def _old_cone_grid_normals(m, width, height, rw, rh, n_rows, n_cols):
    tx, ty = rw // culling.TILE_W, rh // culling.TILE_H
    ndc_x, ndc_y = culling._corner_ndc(width, height, rw, rh, n_rows, n_cols,
                                       m.device)
    mg = m[..., None, None, None, None, :, :]

    def unproj(z):
        p = [mg[..., i, 0] * ndc_x + mg[..., i, 1] * ndc_y
             + (mg[..., i, 2] * z + mg[..., i, 3]) for i in range(4)]
        return torch.stack([p[0] / p[3], p[1] / p[3], p[2] / p[3]], dim=-1)

    d = unproj(1.0) - unproj(0.0)
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    tl, tr = d[..., :-1, :-1, :], d[..., :-1, 1:, :]
    br, bl = d[..., 1:, 1:, :], d[..., 1:, :-1, :]
    n = culling._cross(torch.stack([tl, tr, br, bl], dim=-2),
                       torch.stack([tr, br, bl, tl], dim=-2))
    dc = (tl + tr + br + bl)[..., None, :]
    sign = torch.sign((n * dc).sum(-1, keepdim=True))
    n = n * torch.where(sign == 0.0, 1.0, sign)
    return n.reshape(*m.shape[:-2], ty * tx, n_rows * n_cols, 4, 3)


def _old_frusta(m, width, height, rw, rh, n_sub, n_rows):
    def unproject(px, py, z):
        u = _f32.div(_f32.const(px, m), float(width))
        v = _f32.div(_f32.const(py, m), float(height))
        ndc_x, ndc_y = u * 2.0 - 1.0, -(v * 2.0 - 1.0)
        p = [m[..., i, 0] * ndc_x + m[..., i, 1] * ndc_y
             + (m[..., i, 2] * z + m[..., i, 3]) for i in range(4)]
        return torch.stack([p[0] / p[3], p[1] / p[3], p[2] / p[3]], dim=-1)

    o1, o2 = unproject(0.0, 0.0, 0.0), unproject(float(rw), float(rh), 0.0)
    d1 = unproject(0.0, 0.0, 1.0) - o1
    d2 = unproject(float(rw), float(rh), 1.0) - o2
    a, b, c = _old_dot(d1, d1), _old_dot(d1, d2), _old_dot(d2, d2)
    w = o1 - o2
    d, e = _old_dot(d1, w), _old_dot(d2, w)
    den = a * c - b * b
    den = torch.where(torch.abs(den) < 1e-12, _f32.const(1e-12, den), den)
    s, t = (b * e - c * d) / den, (a * e - b * d) / den
    apex = 0.5 * ((o1 + s[..., None] * d1) + (o2 + t[..., None] * d2))
    tiles = (rw // culling.TILE_W) * (rh // culling.TILE_H)
    normals = _old_cone_grid_normals(m, width, height, rw, rh, 1, 1)
    sub = _old_cone_grid_normals(m, width, height, rw, rh, n_rows,
                                 n_sub // n_rows)
    return apex, normals.reshape(*m.shape[:-2], tiles, 4, 3), sub


def _old_cull(apex, normals, lo, hi, valid):
    n = normals[..., None, :]
    a = apex[..., None, :]
    pmin = (lo - a)[..., None, None, :, :]
    pmax = (hi - a)[..., None, None, :, :]
    pvert = torch.where(n >= 0.0, pmax, pmin)
    return (~((n * pvert).sum(-1) < 0.0).any(dim=-2)) & valid


def _old_distance(apex, lo, hi):
    x = torch.clamp_min(torch.maximum(lo - apex, apex - hi), 0.0)
    return torch.sqrt((x * x).sum(-1))


def _old_cluster_window(scene, apex, remaining, kc):
    cl_dist = _old_distance(apex[..., None, :], scene.cluster_aabb_min,
                            scene.cluster_aabb_max)
    cidx, sel, skey, new_rem, bound = tiled._select_nearest_clusters(
        cl_dist[..., None, :], remaining, kc)
    return (cidx.contiguous(), sel.sum(dim=-1).to(torch.int32),
            skey.contiguous(), new_rem, bound)


def _old_frames_inputs(scene, ivps, cfg, kc):
    m = torch.as_tensor(ivps, dtype=torch.float32)
    apex, normals, sub = _old_frusta(m, cfg.width, cfg.height, PW, PH,
                                     cfg.sub_frusta, cfg.sub_rows)
    hit = _old_cull(apex, normals, scene.cluster_aabb_min,
                    scene.cluster_aabb_max, scene.cluster_valid)
    fi = tiled.FrameInputs(None, None, apex, normals, hit, sub,
                           scene.exit_aabb)
    frus = tiled.frustum_scalars(fi, raygen_ivp=m, tx=PW // culling.TILE_W)
    lists = _old_cluster_window(scene, apex, hit, kc)[:3]
    return tuple(x.flatten(0, 1) for x in (*lists, frus))


@pytest.mark.parametrize("pack,tiles", [("plain", None), ("plain", (2, 15)),
                                        ("raygen", None)])
def test_packed_frusta_share_the_pack(scenes, pack, tiles):
    """With a pack the sub-cone planes live once, inside it: sub_normals
    is a view of the pack, bit for bit the unpacked call's planes."""
    box = scenes["icosphere1_level3"][1].exit_aabb
    args = (IVPS, W, H, PW, PH, 4, 1)
    fr = prologue.tile_frusta(*args, tiles=tiles, pack=pack, scene_aabb=box)
    bare = prologue.tile_frusta(*args, tiles=tiles)
    assert bare.frus is None
    assert fr.sub_normals.untyped_storage().data_ptr() == (
        fr.frus.untyped_storage().data_ptr())
    for got, want in zip(fr[:3], bare[:3]):
        _same_bits(got, want)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_frame_inputs_kernels_flag(scenes, name):
    """kernels=True and False run one body over the two prologue pairs:
    the same frusta and cull; only the kernel route builds the pack."""
    scene = scenes[name][1]
    cfg = RenderConfig(width=W, height=H)
    for ivp, tiles in ((IVPS[1], None), (IVPS[3], (4, 9)), (IVPS, None)):
        rays = ivp.ndim == 2
        k = tiled.build_frame_inputs(scene, ivp, cfg, need_rays=rays,
                                     tiles=tiles, kernels=True)
        p = tiled.build_frame_inputs(scene, ivp, cfg, need_rays=rays,
                                     tiles=tiles)
        for f in ("raymat", "dirs", "apex", "normals", "cluster_hit",
                  "sub_normals", "scene_aabb"):
            if getattr(p, f) is None:
                assert getattr(k, f) is None
            else:
                _same_bits(getattr(k, f), getattr(p, f))
        assert p.frus is None
        _same_bits(k.frus, tiled.frustum_scalars(p))


@pytest.mark.parametrize("n_sub,n_rows", GRIDS)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_plain_path_equals_old_composition(scenes, name, n_sub, n_rows):
    scene = scenes[name][1]
    cfg = RenderConfig(width=W, height=H, sub_frusta=n_sub, sub_rows=n_rows)
    kc = tile_trace.clusters_per_window(scene, cfg)
    for got, want in zip(tile_trace.frames_inputs(scene, IVPS, cfg, kc),
                         _old_frames_inputs(scene, IVPS, cfg, kc)):
        _same_bits(got, want)
    # A ray-matrix frame's cull and two windows of 2 clusters.
    fi = tiled.build_frame_inputs(scene, IVPS[2], cfg, kernels=True)
    apex, normals, sub = _old_frusta(torch.as_tensor(IVPS[2]), W, H, PW, PH,
                                     n_sub, n_rows)
    hit = _old_cull(apex, normals, scene.cluster_aabb_min,
                    scene.cluster_aabb_max, scene.cluster_valid)
    for got, want in ((fi.apex, apex), (fi.normals, normals),
                      (fi.sub_normals, sub), (fi.cluster_hit, hit)):
        _same_bits(got, want)
    _same_bits(fi.frus, tiled.frustum_scalars(fi))
    rem, old_rem = hit, hit
    for _ in range(2):
        got = tiled.cluster_window(scene, fi.apex, rem, 2)
        want = _old_cluster_window(scene, apex, old_rem, 2)
        for g, w in zip(got, want):
            _same_bits(g, w)
        rem, old_rem = got[3], want[3]


def test_merged_rows_equal_old_composition(scenes):
    scene = scenes["icosphere1_level3"][1]
    cfg = RenderConfig(width=W, height=H)
    ivp = _camera(-30.0, 25.0, 5.0)
    rot, trn, scl = inst_mod.instance_tensors(RING * 2, "cpu")
    world = inst_mod.world_frame(ivp, cfg, "cpu")
    apex, normals, sub = _old_frusta(torch.as_tensor(ivp), W, H, PW, PH,
                                     cfg.sub_frusta, cfg.sub_rows)
    for got, want in ((world.apex, apex), (world.normals, normals),
                      (world.sub_normals, sub)):
        _same_bits(got, want)
    launch = inst_mod.merged_launch_inputs(scene, rot, trn, scl, ivp, world,
                                           cfg)
    # The merged lists as the port composed them: the (N, tiles, C) cull,
    # then each row's gathered hits and distances through the select.
    inv_s = _f32.rdiv(1.0, scl)
    apex_o = inst_mod._rot_t(rot, world.apex - trn) * inv_s[:, None]
    normals_o = inst_mod._rot_t(rot[:, None, None], world.normals[None])
    hit = _old_cull(apex_o, normals_o, scene.cluster_aabb_min,
                    scene.cluster_aabb_max, scene.cluster_valid)
    rows = inst_mod.assign_rows(hit.any(dim=2), launch.row_inst.shape[0])
    for got, want in zip((launch.row_inst, launch.row_tile,
                          launch.row_valid, launch.n_seen,
                          launch.overflow), rows):
        _same_bits(got, want)
    cl_dist = _old_distance(apex_o[:, None, :], scene.cluster_aabb_min,
                            scene.cluster_aabb_max)
    row_hit = hit[launch.row_inst, launch.row_tile] & launch.row_valid[:,
                                                                       None]
    cidx, csel, centry, _, _ = tiled._select_nearest_clusters(
        cl_dist[launch.row_inst], row_hit, tile_trace.clusters_per_window(
            scene, cfg))
    _same_bits(launch.ccand, cidx.contiguous())
    _same_bits(launch.ccount, csel.sum(dim=1).to(torch.int32))
    _same_bits(launch.centry, centry.contiguous())
    # The serial path's cull.
    cam = inst_mod._object_camera(scene, rot[1], trn[1], scl[1], world)
    _same_bits(cam.cluster_hit, _old_cull(
        cam.apex, cam.normals, scene.cluster_aabb_min,
        scene.cluster_aabb_max, scene.cluster_valid))
    assert int(launch.ccount.sum()) > 0


def test_wrappers_refuse_bad_input(scenes):
    scene = scenes["icosphere1_level3"][1]
    with pytest.raises(ValueError):
        prologue.tile_frusta(IVPS, W, H, PW, PH, 4, 1, tiles=(3, 5),
                             pack="raygen", scene_aabb=scene.exit_aabb)
    with pytest.raises(ValueError):
        prologue.tile_frusta(IVPS, W, H, PW, PH, 3, 2)
    with pytest.raises(ValueError):
        prologue.cluster_select(torch.zeros((1, 3)), None,
                                scene.cluster_aabb_min,
                                scene.cluster_aabb_max, None, 2)
    with pytest.raises(ValueError):
        prologue.cluster_select(
            torch.zeros((2, 3)), torch.zeros((3, 4, 3)),
            scene.cluster_aabb_min, scene.cluster_aabb_max,
            scene.cluster_valid, 2)


# ----------------------------------------------------------------------
# (d) the rules of the kernels' design, on the plain version.

def _model_lists(dist, held, kc, window):
    """The kernel's decomposition of one row: the apex's order (finite
    distances by (distance, index)) filtered by the row's held mask, then
    the +inf keys (not held, or held at +inf) and the NaN keys (held at
    NaN), each in index order; for a window, the held clusters whose key
    is after the kc-th selected one. Returns (ccand, ccount, centry,
    new_remaining, next_bound)."""
    idx = np.arange(dist.size)
    finite = np.isfinite(dist)
    order = idx[np.lexsort((idx, np.where(finite, dist, 0.0), ~finite))]
    chosen = [c for c in order if finite[c] and held[c]]
    inf_keys = [c for c in idx if not held[c] or dist[c] == np.inf]
    nan_keys = [c for c in idx if held[c] and np.isnan(dist[c])]
    cand = (chosen + inf_keys + nan_keys)[:kc]
    entry = [dist[c] if (finite[c] and held[c]) or np.isnan(dist[c])
             and held[c] else np.inf for c in cand]
    new_rem = np.zeros(dist.size, bool)
    bound = np.float32(np.inf)
    if window and len(chosen) >= kc:
        kth = chosen[kc - 1]
        with np.errstate(invalid="ignore"):
            new_rem = held & ((dist > dist[kth])
                              | ((dist == dist[kth]) & (idx > kth)))
        if new_rem.any():
            bound = dist[new_rem].min()
    return (np.array(cand), min(len(chosen), kc),
            np.array(entry, np.float32), new_rem, bound)


def _bits_np(x):
    return np.asarray(x, np.float32).view(np.int32)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), n_cl=st.integers(1, 40),
       n_apex=st.integers(1, 3), rows_per_apex=st.integers(1, 4),
       kc_frac=st.floats(0.0, 1.0), cull=st.booleans())
def test_lists_are_the_apex_order_filtered(seed, n_cl, n_apex,
                                           rows_per_apex, kc_frac, cull):
    """Random boxes on a half-unit lattice (equal distances), some at
    +inf or NaN and some around the apex (distance 0); rows that hold few
    clusters; kc below and at C; two windows: the plain version's lists,
    counts, entries, cleared masks and bounds are the model's."""
    g = np.random.default_rng(seed)
    centers = np.round(g.uniform(-3, 3, (n_cl, 3)) * 2) / 2
    lo, hi = centers - 0.25, centers + 0.25
    kind = g.integers(0, 6, n_cl)
    lo[kind == 0, 0] = hi[kind == 0, 0] = np.inf
    lo[kind == 1, 1] = np.nan
    lo[kind == 2], hi[kind == 2] = -9.0, 9.0
    lo = torch.tensor(lo, dtype=torch.float32)
    hi = torch.tensor(hi, dtype=torch.float32)
    apex = torch.tensor(np.round(g.uniform(-1, 1, (n_apex, 3)) * 2) / 2,
                        dtype=torch.float32)
    rows = n_apex * rows_per_apex
    kc = max(1, int(round(kc_frac * n_cl)))
    dist = culling.aabb_distance(apex[:, None, :], lo, hi).numpy()
    if cull:
        planes = torch.tensor(g.normal(size=(rows, 4, 3)),
                              dtype=torch.float32)
        valid = torch.tensor(g.random(n_cl) < 0.9)
        row_valid = torch.tensor(g.random(rows) < 0.8)
        sel = prologue.cluster_select(
            apex, planes, lo, hi, valid, kc, row_valid=row_valid,
            rows_per_apex=rows_per_apex, want_hit=True)
        passes = [(sel, sel.hit.numpy())]
    else:
        remaining = torch.tensor(g.random((rows, n_cl))
                                 < g.choice([0.1, 0.5, 0.9]))
        passes = []
        for _ in range(2):
            sel = prologue.cluster_select(
                apex, None, lo, hi, None, kc, remaining=remaining,
                rows_per_apex=rows_per_apex, window=True)
            passes.append((sel, remaining.numpy()))
            remaining = sel.new_remaining
    for sel, held in passes:
        for r in range(rows):
            cand, count, entry, new_rem, bound = _model_lists(
                dist[r // rows_per_apex], held[r], kc, not cull)
            np.testing.assert_array_equal(sel.ccand[r].numpy(), cand)
            assert int(sel.ccount[r]) == count
            np.testing.assert_array_equal(_bits_np(sel.centry[r]),
                                          _bits_np(entry))
            if not cull:
                np.testing.assert_array_equal(sel.new_remaining[r].numpy(),
                                              new_rem)
                assert _bits_np(sel.next_bound[r]) == _bits_np(bound)


def _corner_dirs(m, ndc_x, ndc_y):
    """culling._cone_grid_normals' corner directions: unproject(1) -
    unproject(0), divided by its norm (the square root taken in float64
    and rounded, correctly rounded as on the card)."""
    def unproj(z):
        p = [m[i, 0] * ndc_x + m[i, 1] * ndc_y + (m[i, 2] * z + m[i, 3])
             for i in range(4)]
        return torch.stack([p[0] / p[3], p[1] / p[3], p[2] / p[3]], dim=-1)

    d = unproj(1.0) - unproj(0.0)
    norm = torch.sqrt((d * d).sum(-1, keepdim=True).double()).float()
    return d / norm


@pytest.mark.parametrize("grid", [(4, 1), (8, 2), (1, 1), (8, 1)])
def test_tile_corners_are_one_lattice(grid):
    """Corner (r, c) of tile (i, j) is pixel (32 j + c sw, 32 i + r sh),
    the integer pixel of the frame's corner lattice at (i nrows + r, j
    ncols + c): the per-tile NDC that tile_frusta_plain reads
    (culling._corner_ndc) and the directions made from them equal the
    lattice's, bit for bit, so a corner shared by four tiles is computed
    once."""
    n_sub, n_rows = grid
    n_cols = n_sub // n_rows
    tx, ty = PW // culling.TILE_W, PH // culling.TILE_H
    ndc_x, ndc_y = torch.broadcast_tensors(*culling._corner_ndc(
        W, H, PW, PH, n_rows, n_cols, torch.device("cpu")))
    sw, sh = culling.TILE_W // n_cols, culling.TILE_H // n_rows
    px = torch.arange(tx * n_cols + 1, dtype=torch.float32) * sw
    py = torch.arange(ty * n_rows + 1, dtype=torch.float32) * sh
    lat_x = (_f32.div(px, float(W)) * 2.0 - 1.0)[None, :].expand(
        py.numel(), -1)
    lat_y = (-(_f32.div(py, float(H)) * 2.0 - 1.0))[:, None].expand(
        -1, px.numel())
    rr = (torch.arange(ty)[:, None, None, None] * n_rows
          + torch.arange(n_rows + 1)[None, None, :, None])
    cc = (torch.arange(tx)[None, :, None, None] * n_cols
          + torch.arange(n_cols + 1)[None, None, None, :])
    assert torch.equal(lat_x[rr, cc].view(torch.int32),
                       ndc_x.view(torch.int32))
    assert torch.equal(lat_y[rr, cc].view(torch.int32),
                       ndc_y.view(torch.int32))
    for ivp in IVPS:
        m = torch.as_tensor(ivp, dtype=torch.float32)
        per_tile = _corner_dirs(m, ndc_x, ndc_y)
        lattice = _corner_dirs(m, lat_x, lat_y)
        assert torch.equal(lattice[rr, cc].view(torch.int32),
                           per_tile.view(torch.int32))
