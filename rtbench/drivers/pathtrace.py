"""Closed loop of path-traced frames through PathTracer.render.

One client renders a frame at a time: an orbit camera each frame (a full
turn in `orbit_frames` steps from a start yaw drawn from the seed, moved
by `yaw_step_deg` each turn), `bounces` bounces of `spp` samples with the
sample seed drawn from the seed, the image quantised to u8 on the device.
Rays per frame are the primaries plus, per sample, each bounce's rays
still alive after the bounce before it (the renderer's live counts). A
few pixels of every frame are gathered on the device for the check.
"""
from __future__ import annotations

import numpy as np
import torch

from rtbench import harness, sampling
from rtbench.reference import camera, render


class Driver:
    def __init__(self, cell, seed: int, scene, device):
        from rtmm_tpu_torch.config import RenderConfig
        from rtmm_tpu_torch.render import pathtrace, renderer
        t = cell.traffic
        self.quantize = renderer._quantize
        self.device = torch.device(device)
        self.width, self.height = int(t["width"]), int(t["height"])
        self.spp, self.bounces = int(t["spp"]), int(t["bounces"])
        self.pt_seed = int(harness.rng(seed, 3).integers(0, 2**31))
        self.tracer = pathtrace.PathTracer(
            scene, RenderConfig(width=self.width, height=self.height,
                                sub_frusta=int(t["sub_frusta"])),
            pathtrace.PathTraceConfig(
                bounces=self.bounces, samples_per_pixel=self.spp,
                seed=self.pt_seed, ray_chunk=int(t["ray_chunk"]),
                engine=t["engine"]))
        self.group = pathtrace.GROUP
        self.orbit = int(t["orbit_frames"])
        self.pitch, self.dist = float(t["pitch_deg"]), float(t["distance"])
        self.yaw_step = float(t["yaw_step_deg"])
        self.yaw0 = float(harness.rng(seed, 1).uniform(0.0, 360.0))
        self.pools_host = sampling.pixel_pools(
            seed, self.width, self.height, 1, int(t["check_per_frame"]))
        self.pools = torch.from_numpy(self.pools_host).to(self.device)
        self.rendered = 0
        self.live = torch.zeros(self.bounces + 1, dtype=torch.float64,
                                device=self.device)
        self.samples = sampling.Samples()
        self.in_window = False
        self.timings: dict | None = None
        self.frame_events: list | None = None

    def camera(self, n: int) -> np.ndarray:
        turn, k = divmod(n, self.orbit)
        yaw = self.yaw0 + turn * self.yaw_step + 360.0 / self.orbit * k
        return camera.inv_view_projs(self.pitch, yaw, self.dist,
                                     self.width, self.height)[0]

    def step(self) -> None:
        n = self.rendered
        ivp = self.camera(n)
        spans = self.in_window and self.frame_events is not None
        if spans:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        img, stats = self.tracer.render(
            ivp, timings=self.timings if spans else None)
        u8 = self.quantize(img)
        if spans:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.frame_events.append((start, end))
        self.live += stats["live_rays_per_bounce"].to(torch.float64)
        if self.in_window:
            pix = self.pools[n % sampling.POOLS, 0]
            self.samples.add(ivp, self.pools_host[n % sampling.POOLS, 0][None],
                             u8.reshape(-1, 3)[pix][None])
        self.rendered += 1

    def warm_up(self) -> None:
        for _ in range(3):
            self.step()

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def instrument(self) -> None:
        """CUDA-event spans in the window: the renderer's stages
        (PathTracer.render's timings=) and each whole frame."""
        if self.device.type == "cuda":
            self.timings, self.frame_events = {}, []

    def release(self) -> None:
        self.tracer = None

    def mark(self) -> dict:
        return {"frames": self.rendered, "live": self.live.clone()}

    def rays(self, a: dict, b: dict) -> int:
        """Rays traced between two marks: the primaries once, then per
        sample each bounce's rays alive after the bounce before it (the
        live counts are per-sample means)."""
        live = b["live"] - a["live"]
        return int((b["frames"] - a["frames"]) * self.width * self.height
                   + float(live[:-1].sum()) * self.spp)

    def reference_pixels(self, caster, drawn: dict):
        """(reference u8 pixels, {"bounce": the pixels in which a bounce
        ray of the reference hits the mesh again}). An escaping ray adds
        the constant miss colour whatever its direction, so a wrong draw,
        spawn or bounce trace shows on these pixels and hardly elsewhere."""
        total = self.width * self.height
        total += (-total) % self.group
        want, rehit = render.pathtrace_pixels(
            caster, torch.from_numpy(drawn["ivps"]),
            torch.from_numpy(drawn["px"]), torch.from_numpy(drawn["py"]),
            self.width, self.height, self.spp, self.bounces, self.pt_seed,
            total)
        return want, {"bounce": rehit}
