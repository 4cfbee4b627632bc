"""Interactive viewer — the Window/Trackball analog (SURVEY L5).

The reference opens a Win32 window with mouse-driven trackball input
(framework/src/window.cpp, trackball.cpp). A headless host has no display
server, so this viewer uses matplotlib's event loop when a display is
available (same control scheme: LMB-drag rotate, RMB-drag translate,
scroll zoom) and otherwise renders an orbit sequence of PNG frames.
matplotlib is imported only for the window; the headless orbit needs
none.
"""
from __future__ import annotations

import os

import numpy as np

from .config import RenderConfig
from .io import image as image_io
from .render.renderer import Renderer
from .utils import camera


class Viewer:
    def __init__(self, renderer: Renderer, trackball=None):
        self.renderer = renderer
        self.trackball = trackball or camera.Trackball()
        self._drag_button = None
        self._prev = (0.0, 0.0)
        # Callback fan-out, mirroring the reference Window's registration
        # model (framework/include/framework/window.h:17-83: key / mouse
        # callbacks registered by the app, dispatched from WndProc).
        self._key_callbacks: list = []
        self._home = (np.array(self.trackball.look_at, np.float64).copy(),
                      np.array(self.trackball.rotation_euler,
                               np.float64).copy(),
                      float(self.trackball.distance))

    def register_key_callback(self, fn) -> None:
        """fn(key: str) is invoked on every key press (the analog of
        Window::registerKeyCallback, framework/src/window.cpp:122-146)."""
        self._key_callbacks.append(fn)

    def on_key(self, key: str) -> bool:
        """Built-in key bindings + registered callback fan-out. Returns
        False when the key requests closing the viewer ('q'/'escape')."""
        for fn in self._key_callbacks:
            fn(key)
        step = np.radians(5.0)
        if key in ("q", "escape"):
            return False
        if key == "r":                     # reset camera to start pose
            look, rot, dist = self._home
            self.trackball.set_camera(look.copy(), rot.copy(), dist)
        elif key == "left":
            self.trackball.rotation_euler[1] += step
        elif key == "right":
            self.trackball.rotation_euler[1] -= step
        elif key == "up":
            self.trackball.rotation_euler[0] += step
        elif key == "down":
            self.trackball.rotation_euler[0] -= step
        elif key in ("+", "="):
            self.trackball.zoom(1.0)
        elif key == "-":
            self.trackball.zoom(-1.0)
        return True

    def on_resize(self, width: int, height: int) -> None:
        """Swapchain-resize analog (framework/src/window.cpp:173-182):
        recreate the render pipeline at the new dimensions. Zero-area
        resizes (minimized window) are ignored, as the reference's
        getRenderDimension clamps (window.cpp:220-227)."""
        if width < 1 or height < 1:
            return
        self.renderer.resize(int(width), int(height))

    def _frame(self) -> np.ndarray:
        cfg = self.renderer.cfg
        ivp = camera.inv_view_proj(self.trackball, cfg.width, cfg.height,
                                   cfg.fov_y_degrees, cfg.near, cfg.far)
        return self.renderer.render_u8(ivp)

    def run(self, frames_if_headless: int = 12,
            out_dir: str = "frames") -> None:
        if os.environ.get("DISPLAY") or os.environ.get("MPLBACKEND"):
            try:
                self._run_matplotlib()
                return
            except Exception as exc:   # pragma: no cover - env dependent
                print(f"interactive viewer unavailable ({exc}); "
                      "falling back to orbit frames")
        self._run_orbit(frames_if_headless, out_dir)

    def _run_orbit(self, frames: int, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        for i in range(frames):
            img = self._frame()
            image_io.write_png(os.path.join(out_dir, f"view_{i:04d}.png"),
                               img)
            self.trackball.rotation_euler[1] -= np.radians(360.0 / frames)
        print(f"wrote {frames} orbit frames to {out_dir}/")

    def _run_matplotlib(self) -> None:   # pragma: no cover - needs display
        import matplotlib.pyplot as plt

        # Size the canvas to the configured render resolution and fill it
        # with the image axes — otherwise the first resize_event (fired
        # when the window maps at matplotlib's default ~640x480 figsize)
        # would silently resize the pipeline to the canvas.
        cfg0 = self.renderer.cfg
        dpi = 100.0
        fig = plt.figure(figsize=(cfg0.width / dpi, cfg0.height / dpi),
                         dpi=dpi)
        ax = fig.add_axes((0.0, 0.0, 1.0, 1.0))
        im = ax.imshow(self._frame())
        ax.set_axis_off()

        def redraw():
            im.set_data(self._frame())
            fig.canvas.draw_idle()

        def on_press(event):
            self._drag_button = event.button
            self._prev = (event.x, event.y)

        def on_release(_event):
            self._drag_button = None

        def on_move(event):
            if self._drag_button is None or event.x is None:
                return
            dx = event.x - self._prev[0]
            dy = event.y - self._prev[1]
            self._prev = (event.x, event.y)
            if self._drag_button == 1:
                self.trackball.rotate(dx, dy)      # trackball.cpp:145-148
            elif self._drag_button == 3:
                self.trackball.translate(dx, dy)   # trackball.cpp:150-154
            redraw()

        def on_scroll(event):
            self.trackball.zoom(event.step)        # trackball.cpp:159-163
            redraw()

        def on_key(event):                         # window.cpp:122-146
            if event.key is None:
                return
            if not self.on_key(event.key):
                plt.close(fig)
                return
            redraw()

        def on_resize(event):                      # window.cpp:173-182
            # Figure inches * dpi -> framebuffer pixels.
            w = int(event.width)
            h = int(event.height)
            if (w, h) != (self.renderer.cfg.width, self.renderer.cfg.height):
                self.on_resize(w, h)
                redraw()

        fig.canvas.mpl_connect("button_press_event", on_press)
        fig.canvas.mpl_connect("button_release_event", on_release)
        fig.canvas.mpl_connect("motion_notify_event", on_move)
        fig.canvas.mpl_connect("scroll_event", on_scroll)
        fig.canvas.mpl_connect("key_press_event", on_key)
        fig.canvas.mpl_connect("resize_event", on_resize)
        plt.show()


def view(asset: str, width: int = 512, height: int = 512,
         tessellated: bool = False, device="cuda") -> None:
    """Convenience entry: load an asset and open the viewer."""
    from .app import load_asset
    from .models import scene as scene_mod

    mesh = load_asset(asset)
    scene = scene_mod.build_device_scene(mesh, tessellated=tessellated,
                                         device=device)
    cfg = RenderConfig(width=width, height=height)
    Viewer(Renderer(scene, cfg)).run()
