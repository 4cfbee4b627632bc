"""The path tracer's bounce kernels' plain versions (ops/path_shade.py)
against the JAX package's expressions, on the CPU.

The draw is jax.random's threefry: spawn_plain's uniforms must be
bit-equal to JAX's rand2 (rtmm_tpu/render/pathtrace.py:342-350), on lanes
of both samples and a lane count that is not a power of two (a 480x288
frame padded to a GROUP multiple: total 139,264). The float outputs are
held to the JAX package's own expressions (_cosine_dir, _normalize_flip,
_direct_light; the primaries' shading :265-267, bounce origin :279, pad
:285-292 and spawn :364-373; the bounce lines :472-487) within the
XLA-on-CPU class of ROADMAP queue 3: directions and normals within 2 ulp
of 1 (cos / sin, and the CPU's square roots, round differently in the two
libraries), origins within 2 ulp of their magnitude, radiance within
5.3e-6 (the shading tolerance); the masks of the lanes each output
touches must be equal. pt_primary's and pt_bounce's plain versions,
primary_plain and bounce_plain, are held to the same lines composed, and
bounce_plain reads the trace's normals in every engine's layout. No
Pallas and no interpret mode: JAX's expressions run op by op.
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
# Directions drawn around a normal the two packages normalise apart (by up
# to DIR_TOL): the two errors add.
DIR_TOL_COMPOSED = 2 * DIR_TOL
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


def _pad_tile(x, value=0.0):
    """pathtrace.py:285-292 (pad_to) and :352-353 (tile_s) over the first
    PIX rows of x."""
    x = jnp.pad(jnp.asarray(x[:PIX]),
                ((0, PIX_TOTAL - PIX),) + ((0, 0),) * (x.ndim - 1),
                constant_values=value)
    return jnp.tile(x, (SPP,) + (1,) * (x.ndim - 1))


def _jax_primary(seed, st):
    """pathtrace.py:265-267 (the primaries' shading), :279 (the bounce
    origin) and :364-373 (the spawn) over the first PIX rows of st: what
    pt_primary computes."""
    bn, d, o, t = (jnp.asarray(st[k][:PIX]) for k in ("bn", "d", "o", "t"))
    hit = jnp.asarray(st["hit"][:PIX])
    nrm0 = jpt._normalize_flip(bn, d)
    rad0 = jnp.where(hit[:, None], jpt._direct_light(
        nrm0, jnp.asarray(ALBEDO), JCFG), jnp.asarray(BG))
    borigin0 = o + t[:, None] * d + 1e-4 * nrm0
    u = _jax_u(seed, 0, np.arange(SPP * PIX_TOTAL, dtype=np.int32),
               PIX_TOTAL)
    dd = jnp.where(_pad_tile(st["hit"])[:, None], jpt._cosine_dir(
        jnp.asarray(u), _pad_tile(np.asarray(nrm0))), _pad_tile(st["d"], 1.0))
    return dict(rad0=np.asarray(rad0), u=u,
                o=np.asarray(_pad_tile(np.asarray(borigin0))),
                d=np.asarray(dd), alive=np.asarray(_pad_tile(st["hit"])))


def _bounce_state(rng):
    """A bounce's state whose t holds misses (BIG) and hits at 0, so that
    hit = alive & (t < BIG) & (t > 0) has lanes of each kind."""
    st = _state(rng)
    st["t"][rng.random(N) < 0.3] = np.float32(pathtrace.BIG)
    st["t"][16:24] = 0.0
    return st


def _jax_bounce(seed, bounce, lanes, st):
    """pathtrace.py:449 and :472-487: the hit mask, the bounce radiance
    and the next rays, what pt_bounce computes."""
    t, alive = jnp.asarray(st["t"]), jnp.asarray(st["alive"])
    d, o = jnp.asarray(st["d"]), jnp.asarray(st["o"])
    albedo, bg = jnp.asarray(ALBEDO), jnp.asarray(BG)
    hit = alive & (t < jpt.BIG) & (t > 0.0)
    nrm = jpt._normalize_flip(jnp.asarray(st["bn"]), d)
    tp = albedo ** bounce
    rad = jnp.asarray(st["rad"]) + jnp.where((alive & ~hit)[:, None],
                                             tp * bg, 0.0)
    rad = rad + jnp.where(hit[:, None],
                          tp * jpt._direct_light(nrm, albedo, JCFG), 0.0)
    u = _jax_u(seed, bounce, lanes, TOTAL)
    hit_pos = o + jnp.where(hit, t, 0.0)[:, None] * d
    return dict(rad=np.asarray(rad), hit=np.asarray(hit), u=u,
                o=np.asarray(hit_pos + 1e-4 * nrm),
                d=np.asarray(jnp.where(hit[:, None], jpt._cosine_dir(
                    jnp.asarray(u), nrm), d)))


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
        cases["pt_primary", seed] = _jax_primary(seed, st)
        rng = np.random.default_rng(13 + seed % 3)
        lanes, st = _lanes(rng, TOTAL), _bounce_state(rng)
        cases["pt_bounce", seed] = dict(lanes=lanes, st=st,
                                        **_jax_bounce(seed, 2, lanes, st))
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
        tp = path_shade.albedo_power(ALBEDO, 2)
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


def _ulp_of_max(got, want) -> bool:
    return np.abs(got - want).max() <= 2 * EPS * np.abs(want).max()


SC = path_shade.shading_consts(CFG)


@pytest.mark.parametrize("seed", SEEDS)
def test_primary_plain_matches_jax(ref, seed):
    """pt_primary's plain version: 2 samples over 2,999 pixels padded to
    3,072 lanes each, against the JAX package's primaries (shading,
    bounce origin, pad and spawn)."""
    c, st = ref["pt_primary", seed], ref["primary", seed]["st"]
    rad0, o, d, alive, u = path_shade.primary_plain(
        seed, PIX_TOTAL, SPP, *(_t(st[k][:PIX]) for k in
                                ("bn", "d", "o", "t", "hit")), SC,
        with_u=True)
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  c["u"].view(np.int32))
    np.testing.assert_array_equal(alive.numpy(), c["alive"])
    assert np.abs(rad0.numpy() - c["rad0"]).max() <= RAD_TOL
    assert _ulp_of_max(o.numpy(), c["o"])
    assert np.abs(d.numpy() - c["d"]).max() <= DIR_TOL_COMPOSED
    pads = ~np.tile(np.arange(PIX_TOTAL) < PIX, SPP)
    assert (d.numpy()[pads] == 1.0).all() and (o.numpy()[pads] == 0.0).all()
    # No samples: the radiance alone.
    rad_only = path_shade.primary_plain(
        seed, PIX_TOTAL, 0, *(_t(st[k][:PIX]) for k in
                              ("bn", "d", "o", "t", "hit")), SC)
    assert torch.equal(rad_only[0], rad0) and rad_only[1].shape == (0, 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_bounce_plain_matches_jax(ref, seed):
    """pt_bounce's plain version against the JAX package's bounce lines
    (bounce 2): hit from t (misses at BIG, hits at 0 dead), radiance, next
    rays and uniforms; the last bounce's form (no spawn) returns the same
    radiance and hit."""
    c = ref["pt_bounce", seed]
    st = {k: _t(v) for k, v in c["st"].items()}
    args = (st["bn"], st["d"], st["o"], st["t"], st["alive"], st["rad"],
            _t(c["lanes"]), SC)
    rad, hit, o, d, u = path_shade.bounce_plain(seed, 2, TOTAL, *args,
                                                with_u=True)
    np.testing.assert_array_equal(hit.numpy(), c["hit"])
    assert 0 < c["hit"].sum() < (c["st"]["alive"] & (c["st"]["t"] > 0)
                                 & (c["st"]["t"] < 1e30)).sum() + 1
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  c["u"].view(np.int32))
    assert np.abs(rad.numpy() - c["rad"]).max() <= RAD_TOL
    assert _ulp_of_max(o.numpy(), c["o"])
    assert np.abs(d.numpy() - c["d"]).max() <= DIR_TOL_COMPOSED
    last = path_shade.bounce_plain(seed, 2, TOTAL, *args, spawn=False)
    assert len(last) == 2
    assert torch.equal(last[0], rad) and torch.equal(last[1], hit)


@pytest.mark.parametrize("layout", ["k2", "grouped", "perray_hit"])
def test_bounce_plain_reads_normals_in_place(ref, layout):
    """bounce_plain on the trace's normals as each engine returns them
    equals it on the contiguous (n, 3) rows, bit for bit: K2's (G, 3,
    GROUP) buffer seen transposed, the grouped engine's (G, GROUP, 3);
    the per-ray engine's hit mask (already alive & hit) given."""
    c = ref["pt_bounce", SEEDS[0]]
    st = {k: _t(v) for k, v in c["st"].items()}
    group = pathtrace.GROUP
    bn, hit = st["bn"], None
    if layout == "k2":
        bn = bn.reshape(-1, group, 3).transpose(1, 2).contiguous()
        bn = bn.transpose(1, 2)
        assert not bn.is_contiguous()
    elif layout == "grouped":
        bn = bn.reshape(-1, group, 3)
    else:
        hit = st["alive"] & (st["t"] < pathtrace.BIG) & (st["t"] > 0.0)
    lanes = _t(c["lanes"])
    want = path_shade.bounce_plain(0, 2, TOTAL, st["bn"], st["d"], st["o"],
                                   st["t"], st["alive"], st["rad"], lanes,
                                   SC)
    got = path_shade.bounce(0, 2, TOTAL, bn, st["d"], st["o"], st["t"],
                            st["alive"], st["rad"], lanes, SC, hit=hit)
    assert len(got) == 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("kernel", ["primary", "bounce", "bounce_last"])
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
    monkeypatch.setattr(path_shade, "primary_plain", plain)
    monkeypatch.setattr(path_shade, "bounce_plain", plain)
    n = 2048
    with FakeTensorMode():
        f3 = torch.zeros((n, 3), device="cuda")
        f1 = torch.zeros(n, device="cuda")
        hit = torch.zeros(n, dtype=torch.bool, device="cuda")
        with pytest.raises(RuntimeError, match="no card"):
            if kernel == "primary":
                path_shade.primary(0, n, 2, f3, f3, f3, f1, hit, SC)
            else:
                path_shade.bounce(
                    0, 1, 1024, f3.reshape(2, 1024, 3), f3, f3, f1, hit, f3,
                    torch.zeros(n, dtype=torch.int32, device="cuda"), SC,
                    spawn=kernel == "bounce")


@pytest.mark.parametrize("kernel", ["primary", "bounce"])
def test_wrappers_reject_bad_input(kernel):
    st = _state(np.random.default_rng(1), 64)
    bn, d, o, hit = _t(st["bn"]), _t(st["d"]), _t(st["o"]), _t(st["hit"])
    t, alive, rad = _t(st["t"]), _t(st["alive"]), _t(st["rad"])
    idx = torch.arange(64, dtype=torch.int32)
    if kernel == "primary":
        with pytest.raises(TypeError):
            path_shade.primary(0, 64, 2, bn, d, o, t, hit.to(torch.int32), SC)
        with pytest.raises(ValueError, match="n <= total"):
            path_shade.primary(0, 48, 2, bn, d, o, t, hit, SC)
        with pytest.raises(ValueError, match="contiguous"):
            path_shade.primary(0, 64, 2, bn, d.T.contiguous().T, o, t, hit,
                               SC)
    else:
        with pytest.raises(TypeError):
            path_shade.bounce(0, 1, 64, bn, d, o, t, alive,
                              rad, idx.to(torch.int64), SC)
        with pytest.raises(ValueError, match="power of two"):
            path_shade.bounce(0, 1, 64, bn[:48].reshape(4, 12, 3), d[:48],
                              o[:48], t[:48], alive[:48], rad[:48], idx[:48],
                              SC)
        with pytest.raises(ValueError, match="only with spawn"):
            path_shade.bounce(0, 1, 64, bn, d, o, t, alive, rad, idx, SC,
                              spawn=False, with_u=True)
        # The last bounce reads neither o nor idx.
        rad1, hit1 = path_shade.bounce(0, 1, 64, bn, d, None, t, alive, rad,
                                       None, SC, spawn=False)
        assert rad1.shape == (64, 3) and hit1.dtype == torch.bool
