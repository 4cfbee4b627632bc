"""The path tracer's bounce kernels' plain versions (ops/path_shade.py)
against the JAX package's expressions, on the CPU.

pt_spawn's draw is jax.random's threefry: spawn_plain's uniforms must be
bit-equal to JAX's rand2 (rtmm_tpu/render/pathtrace.py:342-350), on lanes
of both samples and a lane count that is not a power of two (a 480x288
frame padded to a GROUP multiple: total 139,264). The float outputs are
held to the JAX package's own expressions (_cosine_dir, _normalize_flip,
_direct_light and the bounce lines :472-487, the primaries :263-293 and
:355-373) within the XLA-on-CPU class of ROADMAP queue 3: directions and
normals within 2 ulp of 1 (cos / sin, and the CPU's square roots, round
differently in the two libraries), origins within 2 ulp of their
magnitude, radiance within 5.3e-6 (the shading tolerance); the masks of
the lanes each output touches must be equal. No Pallas and no interpret
mode: JAX's expressions run op by op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.render import pathtrace as jpt
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import _build, path_shade
from rtmm_tpu_torch.render import pathtrace
from rtmm_tpu_torch.utils import camera

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
DIR_TOL = 2 * EPS          # directions and normals: 2 ulp of 1
RAD_TOL = 5.3e-6           # shading (ROADMAP queue 3, XLA's CPU FMA class)
TOTAL = 139264             # 480 x 288 = 138,240 pixels, padded to 1024s
N = 6144                   # lanes of every case: one shape for JAX's code
PIX, PIX_TOTAL, SPP = 2999, 3072, 2    # the primaries: 2 x 3,072 = N lanes
SEEDS = [0, 2**31 - 1]
CFG, JCFG = RenderConfig(), JaxConfig()
ALBEDO = np.asarray(CFG.mesh_color, np.float32)
BG = np.asarray(CFG.background, np.float32)


@jax.jit
def _jax_rand2(kb, lanes, total):
    return jax.vmap(lambda g: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(kb, g // total), g % total),
        (2,)))(lanes)


def _jax_u(seed, bounce, lanes, total):
    kb = jax.random.fold_in(jax.random.key(seed), bounce)
    return np.asarray(_jax_rand2(kb, jnp.asarray(lanes), total))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _lanes(rng, total, spp=2, k=N):
    """Sampled global lanes of both samples, with the edges of each."""
    edges = [0, 1, total - 1, total, total + 1, spp * total - 1]
    pick = rng.choice(spp * total, size=k - len(edges), replace=False)
    return np.concatenate([edges, pick]).astype(np.int32)


def _state(rng, n=N):
    """A bounce's sorted state: unnormalised normals, rays, hits, t."""
    bn = (rng.normal(size=(n, 3)) * 2.5).astype(np.float32)
    bn[:8] = 0.0                                  # misses carry no normal
    bn[8:16] = [0.0, 0.0, 0.9]                    # the basis switch
    alive = rng.random(n) < 0.7
    hit = alive & (rng.random(n) < 0.6)
    return dict(bn=bn, d=_unit(rng, n), alive=alive, hit=hit,
                o=rng.normal(size=(n, 3)).astype(np.float32),
                t=rng.uniform(0.0, 3.0, n).astype(np.float32),
                rad=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_spawn_bounce(seed, bounce, lanes, st):
    """pathtrace.py:481-487: the bounce's next rays."""
    nrm = jpt._normalize_flip(jnp.asarray(st["bn"]), jnp.asarray(st["d"]))
    hit, d = jnp.asarray(st["hit"]), jnp.asarray(st["d"])
    u = _jax_u(seed, bounce, lanes, TOTAL)
    hit_pos = jnp.asarray(st["o"]) + jnp.where(hit, st["t"], 0.0)[:, None] * d
    return dict(nrm=np.asarray(nrm), u=u,
                o=np.asarray(hit_pos + 1e-4 * nrm),
                d=np.asarray(jnp.where(hit[:, None], jpt._cosine_dir(
                    jnp.asarray(u), nrm), d)))


def _jax_spawn_primaries(seed, st):
    """pathtrace.py:285-293 (pad_to) and :355-373 (tile_s, the spawn) over
    the first PIX rows of st."""
    pad = PIX_TOTAL - PIX
    nrm0 = np.asarray(jpt._normalize_flip(jnp.asarray(st["bn"]),
                                          jnp.asarray(st["d"])))[:PIX]
    borigin0 = (st["o"] + st["t"][:, None] * st["d"]).astype(np.float32)

    def tile_s(x, value=0.0):
        x = jnp.pad(jnp.asarray(x[:PIX]),
                    ((0, pad),) + ((0, 0),) * (x.ndim - 1),
                    constant_values=value)
        return jnp.tile(x, (SPP,) + (1,) * (x.ndim - 1))

    u = _jax_u(seed, 0, np.arange(SPP * PIX_TOTAL, dtype=np.int32),
               PIX_TOTAL)
    d = jnp.where(tile_s(st["hit"])[:, None], jpt._cosine_dir(
        jnp.asarray(u), tile_s(nrm0)), tile_s(st["d"], 1.0))
    return dict(nrm0=nrm0, borigin0=borigin0[:PIX], u=u,
                o=np.asarray(tile_s(borigin0)), d=np.asarray(d))


def _jax_shade(form, st):
    """pathtrace.py:265-267 (the primaries) or :472-477 (bounce 2, the
    throughput albedo ** 2)."""
    bn, d, hit = (jnp.asarray(st[k]) for k in ("bn", "d", "hit"))
    albedo, bg = jnp.asarray(ALBEDO), jnp.asarray(BG)
    nrm = jpt._normalize_flip(bn, d)
    direct = jpt._direct_light(nrm, albedo, JCFG)
    if form == "primary":
        rad = jnp.where(hit[:, None], direct, bg)
    else:
        escaped = jnp.asarray(st["alive"]) & ~hit
        tp = albedo ** 2
        rad = jnp.asarray(st["rad"]) + jnp.where(escaped[:, None], tp * bg,
                                                 0.0)
        rad = rad + jnp.where(hit[:, None], tp * direct, 0.0)
    return dict(rad=np.asarray(rad), nrm=np.asarray(nrm))


@pytest.fixture(scope="module")
def ref():
    """Every case's inputs (numpy, from a seed) and the JAX package's
    outputs on them, computed once: the JAX caches are cleared after each
    test, and every case shares one shape, so each expression compiles
    once for the file."""
    cases = {}
    for seed in SEEDS:
        for bounce in (0, 1, 2):
            rng = np.random.default_rng(seed % 97 + bounce)
            lanes = _lanes(rng, TOTAL)
            st = _state(rng)
            cases["u", seed, bounce] = dict(
                lanes=lanes, st=st, nrm=_unit(rng, N),
                u=_jax_u(seed, bounce, lanes, TOTAL))
        rng = np.random.default_rng(5 + seed % 7)
        lanes, st = _lanes(rng, TOTAL), _state(rng)
        cases["bounce", seed] = dict(lanes=lanes, st=st,
                                     **_jax_spawn_bounce(seed, 1, lanes, st))
        st = _state(np.random.default_rng(11 + seed % 5))
        cases["primary", seed] = dict(st=st, **_jax_spawn_primaries(seed, st))
    for form, rs in (("bounce", 3), ("primary", 4)):
        st = _state(np.random.default_rng(rs))
        cases["shade", form] = dict(st=st, **_jax_shade(form, st))
    return cases


@pytest.mark.parametrize("bounce", [0, 1, 2])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_bit_equal_to_jax(ref, seed, bounce):
    c = ref["u", seed, bounce]
    lanes, st = c["lanes"], c["st"]
    _, _, u = path_shade.spawn_plain(
        seed, bounce, TOTAL, _t(c["nrm"]), _t(st["hit"]), _t(st["o"]),
        _t(st["d"]), idx=_t(lanes), t=_t(st["t"]), with_u=True)
    got = u.numpy()
    assert got.dtype == np.float32 and got.shape == (len(lanes), 2)
    np.testing.assert_array_equal(got.view(np.int32), c["u"].view(np.int32))
    assert (lanes >= TOTAL).sum() > len(lanes) // 3     # sample 1 covered


@pytest.mark.parametrize("seed", SEEDS)
def test_spawn_bounce_matches_jax(ref, seed):
    c = ref["bounce", seed]
    st = c["st"]
    o, d, u = path_shade.spawn_plain(
        seed, 1, TOTAL, _t(c["nrm"]), _t(st["hit"]), _t(st["o"]),
        _t(st["d"]), idx=_t(c["lanes"]), t=_t(st["t"]), with_u=True)
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  c["u"].view(np.int32))
    assert np.abs(d.numpy() - c["d"]).max() <= DIR_TOL
    assert (np.abs(o.numpy() - c["o"]).max()
            <= 2 * EPS * np.abs(c["o"]).max())
    # Dead lanes keep their direction, bit for bit.
    dead = ~st["hit"]
    np.testing.assert_array_equal(d.numpy()[dead], st["d"][dead])


@pytest.mark.parametrize("seed", SEEDS)
def test_spawn_primaries_match_jax(ref, seed):
    """The primary form: 2 samples over 2,999 pixels padded to 3,072
    lanes each; pad lanes dead with o 0 and d 1.0."""
    c = ref["primary", seed]
    st = c["st"]
    o, d, u = path_shade.spawn_plain(
        seed, 0, PIX_TOTAL, _t(c["nrm0"]), _t(st["hit"][:PIX]),
        _t(c["borigin0"]), _t(st["d"][:PIX]), lanes=SPP * PIX_TOTAL,
        with_u=True)
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  c["u"].view(np.int32))
    np.testing.assert_array_equal(o.numpy(), c["o"])
    assert np.abs(d.numpy() - c["d"]).max() <= DIR_TOL
    pads = np.zeros(PIX_TOTAL, bool)
    pads[PIX:] = True
    pads = np.tile(pads, SPP)
    assert (d.numpy()[pads] == 1.0).all() and (o.numpy()[pads] == 0.0).all()


@pytest.mark.parametrize("form", ["primary", "bounce"])
def test_shade_matches_jax(ref, form):
    c = ref["shade", form]
    st = c["st"]
    if form == "primary":
        rad, nrm = path_shade.shade_plain(_t(st["bn"]), _t(st["d"]),
                                          _t(st["hit"]), ALBEDO, BG, CFG)
    else:
        tp = pathtrace._albedo_power(ALBEDO, 2)
        rad, nrm = path_shade.shade_plain(
            _t(st["bn"]), _t(st["d"]), _t(st["hit"]), ALBEDO, BG, CFG,
            alive=_t(st["alive"]), rad=_t(st["rad"]), tp_b=tp)
    rad_ref = c["rad"]
    assert np.abs(rad.numpy() - rad_ref).max() <= RAD_TOL
    assert np.abs(nrm.numpy() - c["nrm"]).max() <= DIR_TOL
    if form == "bounce":
        # The same lanes gain radiance (escaped: the background; hits: a
        # non-zero direct light); the others keep theirs bit for bit.
        changed = (rad.numpy() != st["rad"]).any(-1)
        np.testing.assert_array_equal(changed,
                                      (rad_ref != st["rad"]).any(-1))
        assert 0 < changed.sum() < st["alive"].sum()
        np.testing.assert_array_equal(rad.numpy()[~changed],
                                      st["rad"][~changed])


def _scene_and_ivp():
    mesh = procedural.make_plane(grid=(2, 2), level=2, amplitude=0.2)
    scene = scene_mod.build_device_scene(mesh, device="cpu")
    tb = camera.Trackball()
    tb.set_camera([0, 0, 0], [np.radians(-30), np.radians(20), 0.0], 3.0)
    return scene, camera.inv_view_proj(tb, 40, 24)


def test_cpu_frame_builds_no_library(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU frame loaded csrc/{name}.cu")

    monkeypatch.setattr(_build, "load", no_build)
    path_shade.reset_launches()
    scene, ivp = _scene_and_ivp()
    cfg = RenderConfig(width=40, height=24)
    img, st = pathtrace.PathTracer(scene, cfg, pathtrace.PathTraceConfig(
        bounces=2, samples_per_pixel=2)).render(ivp)
    assert img.shape == (24, 40, 3) and bool(torch.isfinite(img).all())
    live = st["live_rays_per_bounce"]
    assert live[0] > 0 and bool((live[1:] <= live[:-1]).all())
    assert sum(path_shade.LAUNCHES.values()) == 0


@pytest.mark.parametrize("kernel", ["spawn", "shade"])
def test_cuda_call_without_card_raises(monkeypatch, kernel):
    """A CUDA tensor goes to the kernel, never to the plain version: with
    no library to load the wrapper raises. The CUDA tensors are fake (no
    card here), so nothing launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_card(name):
        raise RuntimeError(f"no card to build csrc/{name}.cu for")

    def plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load", no_card)
    monkeypatch.setattr(path_shade, "_lib", path_shade._lib.__wrapped__)
    monkeypatch.setattr(path_shade, "spawn_plain", plain)
    monkeypatch.setattr(path_shade, "shade_plain", plain)
    n = 2048
    with FakeTensorMode():
        f3 = torch.zeros((n, 3), device="cuda")
        hit = torch.zeros(n, dtype=torch.bool, device="cuda")
        with pytest.raises(RuntimeError, match="no card"):
            if kernel == "spawn":
                path_shade.spawn(0, 1, 1024, f3, hit, f3, f3,
                                 idx=torch.zeros(n, dtype=torch.int32,
                                                 device="cuda"),
                                 t=torch.zeros(n, device="cuda"))
            else:
                path_shade.shade(f3, f3, hit, ALBEDO, BG, CFG)


def test_wrappers_reject_bad_input():
    st = _state(np.random.default_rng(1), 64)
    bn, d, hit = _t(st["bn"]), _t(st["d"]), _t(st["hit"])
    with pytest.raises(TypeError):
        path_shade.shade(bn, d, hit.to(torch.int32), ALBEDO, BG, CFG)
    with pytest.raises(ValueError, match="alive and tp_b"):
        path_shade.shade(bn, d, hit, ALBEDO, BG, CFG, rad=bn)
    with pytest.raises(ValueError, match="primary form"):
        path_shade.spawn(0, 0, 48, bn, hit, bn, d, lanes=100)
    with pytest.raises(ValueError, match="bounce form"):
        path_shade.spawn(0, 1, 64, bn, hit, bn, d, t=_t(st["t"]))
