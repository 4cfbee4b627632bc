"""Closed loop of orbit calls through tile_trace.render_frames.

One client renders calls of `frames_per_call` orbit frames back to back:
cameras built on the host (pitch, distance, a full turn in equal steps
from a start yaw drawn from the seed, the start moved by `yaw_step_deg`
each call), the batch rendered, quantised to u8 and reduced to a
checksum on the device; the checksum read back ends the call. A few
pixels of every frame are gathered on the device for the check.
"""
from __future__ import annotations

import numpy as np
import torch

from rtbench import harness, sampling
from rtbench.reference import camera, render


class Driver:
    def __init__(self, cell, seed: int, scene, device):
        from rtmm_tpu_torch.config import RenderConfig
        from rtmm_tpu_torch.ops import tile_trace
        from rtmm_tpu_torch.render import renderer
        t = cell.traffic
        self.tile_trace, self.quantize = tile_trace, renderer._quantize
        self.scene, self.device = scene, torch.device(device)
        self.width, self.height = int(t["width"]), int(t["height"])
        self.cfg = RenderConfig(width=self.width, height=self.height)
        self.frames = int(t["frames_per_call"])
        self.pitch, self.dist = float(t["pitch_deg"]), float(t["distance"])
        self.yaw_step = float(t["yaw_step_deg"])
        self.yaw0 = float(harness.rng(seed, 1).uniform(0.0, 360.0))
        self.pools_host = sampling.pixel_pools(
            seed, self.width, self.height, self.frames,
            int(t["check_per_frame"]))
        self.pools = torch.from_numpy(self.pools_host).to(self.device)
        self.calls = 0
        self.rendered = 0
        self.samples = sampling.Samples()
        self.in_window = False

    def cameras(self, call: int) -> np.ndarray:
        yaws = (self.yaw0 + call * self.yaw_step
                + 360.0 / self.frames * np.arange(self.frames))
        return camera.inv_view_projs(self.pitch, yaws, self.dist,
                                     self.width, self.height)

    def step(self) -> None:
        ivps = self.cameras(self.calls)
        u8 = self.quantize(self.tile_trace.render_frames(
            self.scene, torch.from_numpy(ivps).to(self.device), self.cfg))
        checksum = u8[..., ::64, ::64, :].sum(dtype=torch.int32)
        if self.in_window:
            pool = self.calls % sampling.POOLS
            flat = u8.reshape(self.frames, -1, 3)
            idx = self.pools[pool]
            self.samples.add(ivps, self.pools_host[pool], flat.gather(
                1, idx[..., None].expand(-1, -1, 3)))
        if int(checksum) <= 0:
            raise RuntimeError("orbit checksum is 0: nothing rendered")
        self.calls += 1
        self.rendered += self.frames

    def warm_up(self) -> None:
        for _ in range(2):
            self.step()

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        self.scene = None

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
