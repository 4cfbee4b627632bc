"""The port's viewer (viewer.py): the input-parity checks of the JAX
package's tests/test_viewer.py (keyboard and resize paths of the
reference Window, framework/src/window.cpp:122-210) on the port's
Viewer, headless, rendering through the per-ray backend as there; and the
headless orbit, which writes PNG frames."""
import numpy as np
import pytest
import torch

from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.io import image as image_io
from rtmm_tpu_torch.models import procedural, scene as scene_mod
from rtmm_tpu_torch.render.renderer import Renderer
from rtmm_tpu_torch.viewer import Viewer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def viewer():
    mesh = procedural.make_plane(grid=(1, 1), level=1, amplitude=0.1)
    scene = scene_mod.build_device_scene(mesh, hierarchy=True, device="cpu")
    return Viewer(Renderer(scene, RenderConfig(width=32, height=16,
                                               pipeline="ray")))


def test_key_rotate_and_zoom(viewer):
    yaw0 = float(viewer.trackball.rotation_euler[1])
    assert viewer.on_key("left")
    assert float(viewer.trackball.rotation_euler[1]) > yaw0
    d0 = viewer.trackball.distance
    assert viewer.on_key("+")
    assert viewer.trackball.distance < d0            # zoom in


def test_key_reset_restores_home(viewer):
    viewer.on_key("left")
    viewer.on_key("up")
    viewer.on_key("-")
    viewer.on_key("r")
    look, rot, dist = viewer._home
    np.testing.assert_allclose(viewer.trackball.rotation_euler, rot)
    np.testing.assert_allclose(viewer.trackball.look_at, look)
    assert viewer.trackball.distance == dist


def test_key_quit_and_callback_fanout(viewer):
    seen = []
    viewer.register_key_callback(seen.append)
    assert viewer.on_key("x")
    assert not viewer.on_key("q")
    assert not viewer.on_key("escape")
    assert seen == ["x", "q", "escape"]


def test_resize_recreates_pipeline(viewer):
    viewer.on_resize(64, 24)
    assert (viewer.renderer.cfg.width, viewer.renderer.cfg.height) == (64, 24)
    # Zero-area resize (minimized window) is ignored, as the reference's
    # getRenderDimension clamps (window.cpp:220-227).
    viewer.on_resize(0, 24)
    assert viewer.renderer.cfg.width == 64
    img = viewer.renderer.render_u8(np.eye(4, dtype=np.float32))
    assert img.shape == (24, 64, 3)


def test_headless_orbit_writes_frames(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("MPLBACKEND", raising=False)
    mesh = procedural.make_icosphere(subdivisions=0, level=1, amplitude=0.1)
    scene = scene_mod.build_device_scene(mesh, device="cpu")
    v = Viewer(Renderer(scene, RenderConfig(width=48, height=32)))
    yaw0 = float(v.trackball.rotation_euler[1])
    v.run(frames_if_headless=3, out_dir=str(tmp_path))
    assert "wrote 3 orbit frames" in capsys.readouterr().out
    frames = [image_io.read_png(str(tmp_path / f"view_{i:04d}.png"))
              for i in range(3)]
    assert all(f.shape == (32, 48, 3) for f in frames)
    assert len(np.unique(frames[0].reshape(-1, 3), axis=0)) > 1
    assert not np.array_equal(frames[0], frames[1])  # the camera orbits
    np.testing.assert_allclose(float(v.trackball.rotation_euler[1]),
                               yaw0 - 2 * np.pi)
