"""Cells cut to a size the renderer's plain versions draw in seconds on
the CPU, for the benchmark's tests."""
from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# Per cell: traffic and recipe overrides for the CPU (small frames, a
# closer camera so the asset covers more of them, a lower level; for the
# path tracer a deeper displacement, so that more bounce rays hit the
# mesh again in a short window's few frames).
TINY = {
    "sphere3-orbit": ({"width": 96, "height": 64, "frames_per_call": 2,
                       "distance": 2.0, "check_per_frame": 64},
                      {"subdivisions": 1, "level": 2}),
    "sphere3-interactive": ({"width": 96, "height": 64, "distance": 2.0,
                             "check_per_frame": 64},
                            {"subdivisions": 1, "level": 2}),
    "sphere5-pathtrace": ({"width": 64, "height": 64, "distance": 2.0,
                           "check_per_frame": 512},
                          {"level": 3, "amplitude": 0.5}),
}


def tiny_cell(name: str, root=None):
    from rtbench import harness
    cell = harness.Cell(name, root)
    traffic, recipe = TINY.get(name, ({}, {}))
    cell.traffic.update(traffic)
    cell.config["recipe"].update(recipe)
    return cell
