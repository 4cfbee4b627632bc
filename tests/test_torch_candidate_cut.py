"""The per-ray backend's candidate cut, on bench config 3's scene, in the
JAX package and in the port.

trace_with_steps keeps the cfg.max_candidates (8) nearest base-triangle
AABBs a ray enters and traces only those. On config 3's 1,280-triangle
icosphere some rays enter up to 23, and a few of them lose their hit to
the cut. The JAX package cuts the same way: on the rays that enter more
than 8 AABBs, JAX's trace_with_steps at 8 candidates and at every
candidate loses the same hits as the port's, and the two agree ray for
ray (hit masks equal, t within 1e-5 relative) at both counts.

Frame: config 3's verify camera (pitch -30, yaw 25, distance 3) at
480x270, a sixteenth of the 1080p frame's rays over the same view. The
AABB counts are taken only on the rays that enter the scene's box (a ray
that misses it enters no triangle's box).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import raygen as jraygen
from rtmm_tpu.ops import traversal as jtrav
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import _f32, intersect, traversal
from rtmm_tpu_torch.utils import camera
from rtmm_tpu_torch.utils.gate import image_gate

torch.set_num_threads(1)

W, H = 480, 270
CONFIG3 = dict(subdivisions=3, level=3, amplitude=0.12)


def _over_limit_rays(scene, o, d, limit):
    """Indices of the rays that enter more than `limit` triangle AABBs,
    and the most AABBs any ray enters."""
    valid = scene.tri_valid
    lo = scene.aabb_min[valid].amin(dim=0)
    hi = scene.aabb_max[valid].amax(dim=0)
    safe = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    near, _t = intersect.ray_aabb(o, _f32.rdiv(1.0, safe), lo, hi)
    sel = torch.nonzero(near)[:, 0]
    enters = traversal.aabb_hit_counts(scene, o[sel], d[sel])
    return sel[enters > limit].numpy(), int(enters.max())


def test_jax_loses_the_same_hits_at_the_cut():
    port = scene_mod.build_device_scene(procedural.make_icosphere(**CONFIG3),
                                        hierarchy=True, device="cpu")
    ref = jscene.build_device_scene(jproc.make_icosphere(**CONFIG3))
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30.0), np.radians(25.0), 0.0], 3.0)
    o, d = (np.array(x) for x in jraygen.generate_rays(
        jnp.asarray(camera.inv_view_proj(tb, W, H), jnp.float32), W, H))
    limit = RenderConfig().max_candidates
    assert limit == JaxConfig().max_candidates == 8
    sel, k_all = _over_limit_rays(port, torch.from_numpy(o),
                                  torch.from_numpy(d), limit)
    o, d = o[sel], d[sel]
    assert len(sel) > 1000 and k_all > limit
    out = {}
    for k in (limit, k_all):
        jcfg = JaxConfig(width=W, height=H, max_candidates=k)
        jt, _jn, jh, _js = (np.asarray(x) for x in jax.jit(
            lambda s, a, b: jtrav.trace_with_steps(s, a, b, jcfg))(
                ref, jnp.asarray(o), jnp.asarray(d)))
        t, _n, hit, _s = (x.numpy() for x in traversal.trace_with_steps(
            port, torch.from_numpy(o), torch.from_numpy(d),
            RenderConfig(width=W, height=H, max_candidates=k)))
        np.testing.assert_array_equal(hit, jh)
        np.testing.assert_allclose(t, jt, rtol=1e-5)
        out["jax", k], out["port", k] = (jt, jh), (t, hit)
    cut = {}
    for side in ("jax", "port"):
        (t8, h8), (tk, hk) = out[side, limit], out[side, k_all]
        # A hit the cut loses, or one it moves to a farther surface.
        cut[side] = (hk & ~h8) | (hk & h8 & (t8 > tk))
        assert not bool((h8 & ~hk).any())
    print(f"{len(sel)} of {W * H} rays enter more than {limit} AABBs (at "
          f"most {k_all}); the cut changes {int(cut['jax'].sum())} of "
          f"their hits in JAX, {int(cut['port'].sum())} in the port")
    assert cut["jax"].any()
    np.testing.assert_array_equal(cut["port"], cut["jax"])


def test_image_gate_mask():
    """The gate restricted to a mask counts and budgets only its pixels."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.random((40, 50, 3), dtype=np.float32))
    b = a.clone()
    b[:5, :, 0] += 0.5                     # 250 big pixels in rows 0-4
    full = image_gate(a, b)
    assert (full["npix"], full["nbig"], full["ok"]) == (250, 250, False)
    mask = torch.ones((40, 50), dtype=torch.bool)
    mask[:5] = False
    part = image_gate(a, b, mask=mask)
    assert (part["npix"], part["nbig"], part["maxdiff"]) == (0, 0, 0.0)
    assert part["ok"] and part["budget"] == 64 and part["big_budget"] == 16
    mask[0, :3] = True
    part = image_gate(a, b, mask=mask)
    assert (part["npix"], part["nbig"], part["ok"]) == (3, 3, True)
    none = image_gate(a, b, mask=torch.zeros((40, 50), dtype=torch.bool))
    assert none["ok"] and none["maxdiff"] == 0.0
