"""Closed loop of one viewer through Renderer + FramePipeline.

The reference application's window (src/application.cpp:41, :240): one
camera per frame, moved by a trackball drag each frame (pitch and yaw
by 0.3 degree a pixel, trackball.cpp:136-141), each frame submitted to a
FramePipeline of `depth` frames in flight (GPUState.cpp:115-148) and read
back as a host u8 array. A frame's latency runs from the submit of its
camera to the return of its host frame. A few pixels of every returned
frame are gathered for the check.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import harness, sampling
from rtbench.reference import camera, render

DEG_PER_PIXEL = 0.3


class Driver:
    def __init__(self, cell, seed: int, scene, device):
        from rtmm_tpu_torch.config import RenderConfig
        from rtmm_tpu_torch.render.renderer import FramePipeline, Renderer
        t = cell.traffic
        self.device = torch.device(device)
        self.width, self.height = int(t["width"]), int(t["height"])
        self.pipe = FramePipeline(
            Renderer(scene, RenderConfig(width=self.width,
                                         height=self.height)),
            depth=int(t["depth"]))
        self.pitch0, self.dist = float(t["pitch_deg"]), float(t["distance"])
        self.drag = (float(t["drag_dx_px"]), float(t["drag_dy_px"]),
                     float(t["drag_period_frames"]))
        self.yaw0 = float(harness.rng(seed, 1).uniform(0.0, 360.0))
        self.pools = sampling.pixel_pools(seed, self.width, self.height, 1,
                                          int(t["check_per_frame"]))
        self.submitted = 0
        self.rendered = 0
        self.submit_at: list[float] = []
        self.ivps: list[np.ndarray] = []
        self.latency_ms: list[float] = []
        self.submit_ms: list[float] = []
        self.samples = sampling.Samples()
        self.in_window = False

    def camera(self, n: int) -> np.ndarray:
        """Frame n's matrix: the drag's yaw and pitch after n frames."""
        dx, dy, period = self.drag
        yaw = self.yaw0 - DEG_PER_PIXEL * dx * n
        pitch = self.pitch0 - DEG_PER_PIXEL * dy * period / (2 * np.pi) * \
            np.sin(2 * np.pi * n / period)
        return camera.inv_view_projs(np.clip(pitch, -90.0, 90.0), yaw,
                                     self.dist, self.width, self.height)[0]

    def _returned(self, frame: np.ndarray, now: float) -> None:
        n = self.rendered
        if self.in_window:
            self.latency_ms.append((now - self.submit_at[n]) * 1e3)
            pix = self.pools[n % sampling.POOLS, 0]
            self.samples.add(self.ivps[n], pix[None],
                             frame.reshape(-1, 3)[pix][None])
        self.rendered += 1

    def step(self) -> None:
        ivp = self.camera(self.submitted)
        self.ivps.append(ivp)
        t0 = time.perf_counter()
        self.submit_at.append(t0)
        out = self.pipe.submit(ivp)
        now = time.perf_counter()
        if self.in_window:
            self.submit_ms.append((now - t0) * 1e3)
        self.submitted += 1
        if out is not None:
            self._returned(out, now)

    def warm_up(self) -> None:
        for _ in range(4):
            self.step()
        self.finish()

    def finish(self) -> None:
        for out in self.pipe.drain():
            self._returned(out, time.perf_counter())

    def release(self) -> None:
        self.pipe = None

    def mark(self) -> dict:
        return {"frames": self.rendered}

    def rays(self, a: dict, b: dict) -> int:
        return (b["frames"] - a["frames"]) * self.width * self.height

    def reference_pixels(self, caster, drawn: dict):
        """(reference u8 pixels, {}): a primary frame has no subsets."""
        return render.primary_pixels(
            caster, torch.from_numpy(drawn["ivps"]),
            torch.from_numpy(drawn["px"]), torch.from_numpy(drawn["py"]),
            self.width, self.height), {}
