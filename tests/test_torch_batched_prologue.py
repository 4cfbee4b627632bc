"""The frame prologue of a batch of frames in one pass
(tile_trace.frames_inputs), on the CPU.

  (a) its rows are bit-equal to the per-frame rows (frame_inputs, one
      call per frame, concatenated), for 1, 3 and 5 frames, on the
      two-cluster icosphere and on a flat plane of 8 clusters seen from
      above (equal cluster distances: ties), with a camera whose tiles
      see no cluster;
  (b) against the JAX package's batched prologue, render_pallas_frames'
      jax.vmap(frame_inputs) rebuilt from its public pieces
      (rtmm_tpu/ops/pallas_tiled.py:1490-1509) and run op by op, as
      tests/test_torch_prologue.py runs the per-frame prologue: ccand,
      ccount and the pack's apex / raygen / box scalars exact; the plane
      part within 2 ulp of 1 and centry within 2 ulp with its +inf tail
      exact. Both are XLA's CPU FMA contraction: jnp.linalg.norm is a
      jitted function, so XLA sums aabb_distance's squares as a chain of
      fused multiply-adds where PyTorch rounds each product (at cameras 3
      and 4 below JAX's distances are that chain's, 1 ulp from the
      port's). Under jit the apex takes the contraction too.
  (c) the ops it dispatches do not grow with the frame count;
  (d) render_frames over several launch chunks equals render_frame frame
      by frame.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu.ops import culling as jculling
from rtmm_tpu.ops import tiled as jtiled
from rtmm_tpu.utils import cache as jcache
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import scene as scene_mod
from rtmm_tpu_torch.ops import tiled, tile_trace
from rtmm_tpu_torch.utils import camera

# One intra-op thread, as in tests/test_torch_prologue.py: a multi-threaded
# PyTorch op right after a JAX computation was seen to glitch.
torch.set_num_threads(1)

W, H = 200, 80          # padded to 224x96: 7 x 3 tiles, the last partial
EPS = 2.0 ** -24        # ulp of values in [0.5, 1)

MESHES = {
    "icosphere1_level3": lambda: jproc.make_icosphere(
        subdivisions=1, level=3, amplitude=0.1),
    # Flat: every cluster box lies in z = 0, so seen from straight above
    # the boxes around the apex's foot are at equal distances.
    "plane32_flat": lambda: jproc.make_plane(grid=(32, 32), level=2,
                                             amplitude=0.0),
}


def _camera(pitch, yaw, dist, look_at=(0.0, 0.0, 0.0), w=W, h=H):
    tb = camera.Trackball()
    tb.set_camera(list(look_at), [np.radians(pitch), np.radians(yaw), 0.0],
                  dist)
    return tb, camera.inv_view_proj(tb, w, h)


def _away_camera():
    """The verify camera moved 10 units along its own view direction, so
    that the scene lies behind it: no tile sees a cluster."""
    tb, _ = _camera(-30.0, 25.0, 3.0)
    return _camera(-30.0, 25.0, 3.0, tuple(10.0 * tb.forward()))[1]


_rng = np.random.default_rng(12)
# From straight above first (the ties), then the away camera, then seeded.
IVPS = np.stack(
    [_camera(-90.0, 0.0, 3.0)[1], _away_camera()]
    + [_camera(float(_rng.uniform(-70, 70)), float(_rng.uniform(0, 360)),
               float(_rng.uniform(2.0, 4.0)))[1] for _ in range(3)])


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


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.int32)


def _per_frame(scene, ivps, cfg, kc):
    per = [tile_trace.frame_inputs(scene, ivp, cfg, kc) for ivp in ivps]
    return [torch.cat(parts) for parts in zip(*per)]


@pytest.mark.parametrize("n_frames", [1, 3, 5])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_batched_rows_equal_per_frame_rows(scenes, name, n_frames):
    scene = scenes[name][1]
    cfg = RenderConfig(width=W, height=H)
    kc = tile_trace.clusters_per_window(scene, cfg)
    ivps = IVPS[:n_frames]
    got = tile_trace.frames_inputs(scene, ivps, cfg, kc)
    want = _per_frame(scene, ivps, cfg, kc)
    n_tiles = 7 * 3
    assert got[0].shape == (n_frames * n_tiles, kc)
    assert got[3].shape == (n_frames * n_tiles,
                            tiled.frustum_pack_len(cfg.sub_frusta, True))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.is_contiguous()
        np.testing.assert_array_equal(_bits(g), _bits(w))
    ccount = got[1].reshape(n_frames, n_tiles)
    assert int(ccount[0].sum()) > 0
    if n_frames > 1:
        assert int(ccount[1].sum()) == 0      # the away camera
    if name == "plane32_flat":
        centry = got[2][:n_tiles]
        ties = (centry[:, 1:] == centry[:, :-1]) & torch.isfinite(
            centry[:, 1:])
        assert bool(ties.any())


def _ulps(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    a = a.ravel().view(np.int32).astype(np.int64)
    b = b.ravel().view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _jax_frames_inputs(ref, ivps, kc):
    """render_pallas_frames' batched prologue (pallas_tiled.py:1490-1509,
    kernel_raygen): jax.vmap of frame_inputs."""
    jcfg = JaxConfig(width=W, height=H)
    pw, _ = jtiled.padded_size(W, H)

    def frame_inputs(ivp):
        fi = jtiled.build_frame_inputs(ref, ivp, jcfg, need_q_frame=False,
                                       need_rays=False)
        frus = jtiled.frustum_scalars(fi, raygen_ivp=ivp.astype(jnp.float32),
                                      tx=pw // 32)
        cl_dist = jculling.aabb_distance(fi.apex, ref.cluster_aabb_min,
                                         ref.cluster_aabb_max)
        key = jnp.where(fi.cluster_hit, -cl_dist[None, :], -jnp.inf)
        negd, cidx = jax.lax.top_k(key, kc)
        sel = negd > -jnp.inf
        centry = jnp.where(sel, -negd, jnp.inf).astype(jnp.float32)
        return (cidx.astype(jnp.int32), sel.sum(axis=1).astype(jnp.int32),
                centry, frus)

    out = jax.vmap(frame_inputs)(jnp.asarray(ivps, jnp.float32))
    return [np.asarray(x).reshape((-1,) + x.shape[2:]) for x in out]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_batched_rows_match_jax_vmap(scenes, name):
    ref, scene = scenes[name]
    cfg = RenderConfig(width=W, height=H)
    kc = tile_trace.clusters_per_window(scene, cfg)
    got = [x.numpy() for x in tile_trace.frames_inputs(scene, IVPS, cfg,
                                                        kc)]
    want = _jax_frames_inputs(ref, IVPS, kc)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got[1].sum() > 0
    hit = np.isfinite(want[2])
    np.testing.assert_array_equal(np.isfinite(got[2]), hit)
    assert _ulps(got[2][hit], want[2][hit]) <= 2
    f1, f0 = got[3], want[3]
    assert f1.shape == f0.shape
    planes = slice(3, 3 + cfg.sub_frusta * 12)
    np.testing.assert_array_equal(f1[:, :3].view(np.int32),
                                  f0[:, :3].view(np.int32))
    np.testing.assert_array_equal(f1[:, planes.stop:].view(np.int32),
                                  f0[:, planes.stop:].view(np.int32))
    assert np.abs(f1[:, planes] - f0[:, planes]).max() <= 2 * 2 * EPS


class _OpCounter(TorchDispatchMode):
    """Counts every ATen op dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_op_count_does_not_grow_with_frames(scenes):
    scene = scenes["icosphere1_level3"][1]
    cfg = RenderConfig(width=W, height=H)
    kc = tile_trace.clusters_per_window(scene, cfg)
    ivps = np.concatenate([IVPS, IVPS[2:5]])            # 8 frames
    tile_trace.frames_inputs(scene, ivps[:1], cfg, kc)  # shape-only caches
    counts = {}
    for n in (1, 8):
        with _OpCounter() as c:
            tile_trace.frames_inputs(scene, ivps[:n], cfg, kc)
        counts[n] = c.ops
    print({n: sum(c.values()) for n, c in counts.items()})
    assert counts[8] == counts[1]
    assert sum(counts[1].values()) > 100


def test_render_frames_over_chunks_equals_frames(scenes, monkeypatch):
    """Four 128x64 frames (8 tiles each) under a 16-row launch cap: two
    chunks of two frames, each one fused launch over both frames' rows."""
    scene = scenes["icosphere1_level3"][1]
    cfg = RenderConfig(width=128, height=64)
    ivps = np.stack([_camera(-30.0, yaw, 3.0, w=128, h=64)[1]
                     for yaw in (10.0, 25.0, 40.0, 200.0)])
    launched = []
    trace_fused = tile_trace.trace_fused

    def spy(ccand, *args, **kw):
        launched.append(ccand.shape[0])
        return trace_fused(ccand, *args, **kw)

    monkeypatch.setattr(tile_trace, "BATCH_TILE_CAP", 16)
    monkeypatch.setattr(tile_trace, "trace_fused", spy)
    batch = tile_trace.render_frames(scene, ivps, cfg)
    assert launched == [16, 16]
    assert batch.shape == (4, 64, 128, 3)
    for k in range(4):
        assert torch.equal(batch[k],
                           tile_trace.render_frame(scene, ivps[k], cfg))
    assert len(launched) == 6
