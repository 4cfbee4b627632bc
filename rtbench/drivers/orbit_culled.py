"""drivers/orbit.py's closed loop of orbit calls for a scene too large
for the all-pairs oracle, rendered in cluster windows.

Two changes to the orbit driver, whose loop this is: the RenderConfig
takes kernel_clusters_per_window from the traffic's
"clusters_per_window", and the reference's caster is wrapped in the
culled caster (reference/culled.py), which gives the oracle's answer,
bit for bit, by testing each ray against the micro-triangles of the
base triangles whose boxes it meets.
"""
from __future__ import annotations

import time
from pathlib import Path

import torch

from rtbench import harness
from rtbench.reference import culled

_orbit = harness._load(Path(__file__).with_name("orbit.py"),
                       "rtbench_driver_orbit_culled_base")


class Driver(_orbit.Driver):
    def __init__(self, cell, seed: int, scene, device):
        from rtmm_tpu_torch.config import RenderConfig
        super().__init__(cell, seed, scene, device)
        self.cfg = RenderConfig(
            width=self.width, height=self.height,
            kernel_clusters_per_window=int(
                cell.traffic["clusters_per_window"]))
        self.level = int(cell.config["recipe"]["level"])

    def reference_pixels(self, caster, drawn: dict):
        """The orbit driver's reference pixels through the culled caster;
        logs the seconds it took ("[reference]" on stderr)."""
        at = harness.seconds_since_process_start()
        t0 = time.perf_counter()
        wrapped = culled.CulledCaster(caster, self.level)
        t1 = time.perf_counter()
        out = super().reference_pixels(wrapped, drawn)
        if wrapped.device.type == "cuda":
            torch.cuda.synchronize(wrapped.device)
        t2 = time.perf_counter()
        harness.log(f"[reference] {caster.dtype}: from {at:.3f} s after "
                    f"the process started, boxes {t1 - t0:.3f} s, "
                    f"{len(drawn['px'])} pixels {t2 - t1:.3f} s")
        return out
