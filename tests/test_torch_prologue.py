"""The port's frame prologue against the JAX package's, on the CPU.

Exactness per function. XLA's CPU compiler always allows floating-point
contraction, so JAX there rounds a*b+c once (a fused multiply-add) where
PyTorch's eager ops round twice; where a function's result cancels
products of larger operands (cross products, moments) the two differ by
an ulp of those operands, not of the result. So:

  exact         origins, apex, scene_exit_aabb, cull_units, frame_t_num,
                the frustum pack's apex / raygen / box scalars, and the
                cluster lists (ccand, ccount, centry) — including ties;
  <= 2 ulp      ray directions and aabb_distance (a 3-term sum of
                squares under a square root, accumulated with FMA by XLA);
  <= 2 ulp of 1 tile / sub-tile frustum plane normals and the plane part
                of the frustum pack (cross products of unit directions);
  <= 4 ulp of the apex magnitude   the ray matrix's moment and shift rows.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import culling as jculling
from rtmm_tpu.ops import raygen as jraygen
from rtmm_tpu.ops import tiled as jtiled
from rtmm_tpu.utils import cache as jcache
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import scene as scene_mod
from rtmm_tpu_torch.ops import culling, raygen, tiled, tile_trace
from rtmm_tpu_torch.utils import camera

# One intra-op thread: the suite runs several pytest workers on one shared
# CPU, and with JAX in the same process the first multi-threaded PyTorch
# op after a JAX computation was seen to compute part of its range wrong
# (about one process in twenty; never single-threaded).
torch.set_num_threads(1)

W, H = 256, 96
PW, PH = 256, 96
EPS = 2.0 ** -24        # ulp of values in [0.5, 1)


def _ulps(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    a = np.asarray(a, np.float32).ravel().view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).ravel().view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _camera(pitch, yaw, dist):
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(pitch), np.radians(yaw), 0.0], dist)
    return camera.inv_view_proj(tb, W, H)


# Seeded cameras: pitch, yaw, distance.
_rng = np.random.default_rng(7)
CAMERAS = [(-30.0, 25.0, 3.0)] + [
    (float(_rng.uniform(-60, 60)), float(_rng.uniform(0, 360)),
     float(_rng.uniform(2.0, 4.0))) for _ in range(2)]


def _jax_cluster_lists(apex, cl_min, cl_max, hit, kc):
    """pallas_tiled.render_pallas's cluster top-k (:1390-1395)."""
    cl_dist = jculling.aabb_distance(apex, cl_min, cl_max)
    key = jnp.where(hit, -cl_dist[None, :], -jnp.inf)
    negd, cidx = jax.lax.top_k(key, kc)
    sel = negd > -jnp.inf
    centry = jnp.where(sel, -negd, jnp.inf).astype(jnp.float32)
    return (np.asarray(cidx, np.int32),
            np.asarray(sel.sum(axis=1), np.int32), np.asarray(centry))


@pytest.fixture(scope="module")
def scenes():
    mesh = jproc.make_icosphere(subdivisions=1, level=3, amplitude=0.1)
    ref = jscene.build_device_scene(mesh, hierarchy=False)
    arrays = {k: np.asarray(v) for k, v in (
        (f, getattr(ref, f)) for f in ref.__dataclass_fields__)
        if v is not None and k not in jcache._META_FIELDS}
    arrays.update(jcache._meta_arrays(ref))
    return ref, scene_mod.scene_from_arrays(arrays, device="cpu")


@pytest.fixture(scope="module")
def jax_ref(scenes):
    """Every JAX prologue output for every camera, computed once (the
    eager JAX ops compile once per shape)."""
    ref = scenes[0]
    out = []
    for cam in CAMERAS:
        ivp = jnp.asarray(_camera(*cam))
        r = {}
        r["origins"], r["dirs"] = jraygen.generate_rays(ivp, W, H, PW, PH)
        r["apex"], r["normals"] = jculling.tile_frustums(ivp, W, H, PW, PH)
        for n_sub, n_rows in ((4, 1), (8, 2)):
            r[f"sub{n_sub}"] = jculling.tile_sub_frustums(
                ivp, W, H, PW, PH, n_sub=n_sub, n_rows=n_rows)
        r["cull"] = jculling.cull_units(r["apex"], r["normals"],
                                        ref.unit_aabb_min, ref.unit_aabb_max,
                                        ref.unit_valid)
        r["dist"] = jculling.aabb_distance(r["apex"], ref.unit_aabb_min,
                                           ref.unit_aabb_max)
        r["exit"] = jtiled.scene_exit_aabb(ref)
        r["t_num"] = jtiled.frame_t_num(ref, r["apex"])
        jcfg = JaxConfig(width=W, height=H)
        fi = jtiled.build_frame_inputs(ref, ivp, jcfg, need_q_frame=False,
                                       need_rays=True)
        r["raymat"], r["cluster_hit"] = fi.raymat, fi.cluster_hit
        r["frus"] = jtiled.frustum_scalars(
            jtiled.build_frame_inputs(ref, ivp, jcfg, need_q_frame=False,
                                      need_rays=False),
            raygen_ivp=ivp.astype(jnp.float32), tx=PW // 32)
        r["lists"] = _jax_cluster_lists(fi.apex, ref.cluster_aabb_min,
                                        ref.cluster_aabb_max, fi.cluster_hit,
                                        ref.num_clusters)
        out.append({k: (v if k == "lists" else np.asarray(v))
                    for k, v in r.items()})
    return out


CAMS = range(len(CAMERAS))


@pytest.mark.parametrize("cam", CAMS)
def test_generate_rays(jax_ref, cam):
    r = jax_ref[cam]
    o1, d1 = raygen.generate_rays(_camera(*CAMERAS[cam]), W, H, PW, PH,
                                  device="cpu")
    assert _ulps(r["origins"], o1) == 0
    assert _ulps(r["dirs"], d1) <= 2


@pytest.mark.parametrize("cam", CAMS)
def test_tile_frustums_and_sub_frustums(jax_ref, cam):
    r, ivp = jax_ref[cam], _camera(*CAMERAS[cam])
    a1, n1 = culling.tile_frustums(ivp, W, H, PW, PH, device="cpu")
    assert _ulps(r["apex"], a1) == 0
    assert n1.shape == (PW // 32 * PH // 32, 4, 3)
    assert np.abs(r["normals"] - _np(n1)).max() <= 2 * 2 * EPS
    for n_sub, n_rows in ((4, 1), (8, 2)):
        s1 = culling.tile_sub_frustums(ivp, W, H, PW, PH, n_sub=n_sub,
                                       n_rows=n_rows, device="cpu")
        assert s1.shape == (PW // 32 * PH // 32, n_sub, 4, 3)
        assert np.abs(r[f"sub{n_sub}"] - _np(s1)).max() <= 2 * 2 * EPS


@pytest.mark.parametrize("cam", CAMS)
def test_cull_distance_exit_box(scenes, jax_ref, cam):
    port, r = scenes[1], jax_ref[cam]
    a1, n1 = culling.tile_frustums(_camera(*CAMERAS[cam]), W, H, PW, PH,
                                   device="cpu")
    h1 = culling.cull_units(a1, n1, port.unit_aabb_min, port.unit_aabb_max,
                            port.unit_valid)
    np.testing.assert_array_equal(r["cull"], _np(h1))
    assert _np(h1).any()
    d1 = culling.aabb_distance(a1, port.unit_aabb_min, port.unit_aabb_max)
    assert _ulps(r["dist"], d1) <= 2
    assert _ulps(r["exit"], tiled.scene_exit_aabb(port)) == 0
    assert _ulps(r["t_num"], tiled.frame_t_num(port, a1)) == 0


@pytest.mark.parametrize("cam", CAMS)
def test_frame_inputs_and_frustum_pack(scenes, jax_ref, cam):
    port, r, ivp = scenes[1], jax_ref[cam], _camera(*CAMERAS[cam])
    cfg = RenderConfig(width=W, height=H)
    fi1 = tiled.build_frame_inputs(port, ivp, cfg, need_rays=True)
    np.testing.assert_array_equal(r["cluster_hit"], _np(fi1.cluster_hit))
    r0, r1 = r["raymat"], _np(fi1.raymat)
    assert r1.shape == r0.shape == (PW // 32 * PH // 32, 1024, 8)
    assert _ulps(r0[..., 0:3], r1[..., 0:3]) <= 2
    tol = 4 * float(np.spacing(np.float32(max(1.0, np.abs(r["apex"]).max()))))
    assert np.abs(r0[..., 3:7] - r1[..., 3:7]).max() <= tol
    np.testing.assert_array_equal(r0[..., 7], r1[..., 7])

    f0 = r["frus"]
    f1 = _np(tiled.frustum_scalars(
        tiled.build_frame_inputs(port, ivp, cfg, need_rays=False),
        raygen_ivp=torch.as_tensor(ivp, dtype=torch.float32), tx=PW // 32))
    assert f1.shape == f0.shape == (PW // 32 * PH // 32,
                                    tiled.frustum_pack_len(4, True))
    planes = slice(3, 3 + 4 * 12)
    assert _ulps(f0[:, :3], f1[:, :3]) == 0
    assert _ulps(f0[:, planes.stop:], f1[:, planes.stop:]) == 0
    assert np.abs(f0[:, planes] - f1[:, planes]).max() <= 2 * 2 * EPS


@pytest.mark.parametrize("cam", CAMS)
def test_cluster_lists_exact(scenes, jax_ref, cam):
    port = scenes[1]
    fi1 = tiled.build_frame_inputs(port, _camera(*CAMERAS[cam]),
                                   RenderConfig(width=W, height=H),
                                   need_rays=False)
    got = tile_trace.cluster_lists(port, fi1, port.num_clusters)
    for w, g in zip(jax_ref[cam]["lists"], got):
        assert w.tobytes() == _np(g).tobytes()
    assert int(got[1].sum()) > 0


def test_cluster_lists_tie_order():
    """Equal distances keep the lower cluster index first (jax.lax.top_k's
    documented tie rule); unhit clusters trail with +inf entries."""
    # Seven boxes around an apex at the origin; boxes 1, 3, 4 and 6 lie at
    # exactly distance 2, box 0 at 3, box 2 at 1, box 5 is not hit by
    # tile 0. Every operation on these values is exact in float32.
    lo = np.array([[3, -1, -1], [2, -1, -1], [-1, 1, -1], [-1, 2, -1],
                   [-1, -1, 2], [-4, -1, -1], [-1, -1, -3]], np.float32)
    hi = lo + np.array([1, 2, 2], np.float32)
    hi[3] = lo[3] + [2, 1, 2]
    hi[4] = lo[4] + [2, 2, 1]
    hi[6] = lo[6] + [2, 2, 1]
    hit = np.ones((3, 7), bool)
    hit[0, 5] = False
    hit[1, :] = False
    hit[2, [1, 6]] = False
    apex = np.zeros(3, np.float32)
    fake_scene = types.SimpleNamespace(cluster_aabb_min=torch.from_numpy(lo),
                                       cluster_aabb_max=torch.from_numpy(hi))
    fake_fi = types.SimpleNamespace(apex=torch.from_numpy(apex),
                                    cluster_hit=torch.from_numpy(hit))
    want = {}
    for kc in (7, 4):
        want[kc] = _jax_cluster_lists(jnp.asarray(apex), jnp.asarray(lo),
                                      jnp.asarray(hi), jnp.asarray(hit), kc)
        got = tile_trace.cluster_lists(fake_scene, fake_fi, kc)
        for w, g in zip(want[kc], got):
            assert w.tobytes() == _np(g).tobytes()
    assert want[7][0][0].tolist() == [2, 1, 3, 4, 6, 0, 5]
    assert want[7][2][0].tolist()[:6] == [1, 2, 2, 2, 2, 3]
    assert want[7][1].tolist() == [6, 0, 5]
    assert want[4][1].tolist() == [4, 0, 4]
