"""The trace kernel against its plain PyTorch version, on the card.

Marked `gpu`: each test asks the `cuda` fixture for the card and skips
where there is none (the CPU runs only the plain version). On a machine
with the card and without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.ops import culling, tiled, tile_trace
from rtmm_tpu_torch.utils import camera
from rtmm_tpu_torch.utils.gate import image_gate

pytestmark = pytest.mark.gpu

SCENES = [  # (subdivisions, level, width, height): the CPU tests' scenes
    (0, 2, 128, 64),
    (1, 3, 256, 64),
]


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


@pytest.mark.parametrize("sub,level,w,h", SCENES)
def test_kernel_matches_plain(cuda, sub, level, w, h):
    scene = _scene(sub, level, cuda)
    cfg = RenderConfig(width=w, height=h)
    rows = tile_trace.frame_inputs(scene, _ivp(w, h), cfg,
                                   tile_trace._window(scene, cfg))
    pw, ph = tiled.padded_size(w, h)
    geo = dict(tiles_per_frame=(pw // 32) * (ph // 32), tx=pw // 32,
               pw=pw, ph=ph)
    args = (*rows, scene.cluster_unit_meta, scene.unit_qn, cfg)
    before = tile_trace.LAUNCHES
    k_img, k_vis, k_elig = tile_trace.trace_fused(*args, **geo)
    torch.cuda.synchronize()
    assert tile_trace.LAUNCHES == before + 1
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
        scene, _ivp(128, 64), cfg, tile_trace._window(scene, cfg))
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
