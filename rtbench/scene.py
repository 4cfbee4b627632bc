"""A configuration's scene: its base mesh (rtbench/bases/<recipe's
"base">.py, plain arrays the benchmark makes) handed to both sides, as
the renderer's micro-mesh under the recipe's height field (read back
through the .gltf + .bary files where the recipe says so) with its device
scene, and as the reference's tessellation.

The scene is the recipe's alone: a seed that changed the geometry would
change the work of a frame (up to 5% of an orbit's rays a second between
seeds), so the seed varies the cameras, the sampled pixels and the path
tracer's draws only. The seed only names the files of the .gltf + .bary
round trip.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from .reference import geometry


def micromesh(recipe: dict, base: dict, seed: int):
    """The renderer's MicroMesh of the base mesh at the recipe's uniform
    level under its height field, built as the renderer builds its
    procedural assets; through the renderer's .gltf + .bary writer and
    loader when recipe["io"] is "gltf_bary" (the files under TMPDIR,
    named by the process and the seed, removed once read)."""
    from rtmm_tpu_torch.io import loader
    from rtmm_tpu_torch.models import procedural
    height = geometry.HeightField(recipe["amplitude"], recipe["phase"])
    faces = base["faces"]
    mesh = procedural._build_micromesh(
        base["positions"], base["normals"], faces,
        np.full(faces.shape[0], int(recipe["level"])),
        float(recipe["amplitude"]), height)
    if recipe.get("io") != "gltf_bary":
        return mesh
    stem = os.path.join(tempfile.gettempdir(),
                        f"rtbench_{os.getpid()}_{int(seed)}")
    try:
        loader.save_gltf_bary(mesh, stem + ".gltf")
        return loader.load_micromesh(stem + ".gltf")
    finally:
        for ext in (".gltf", ".bary", ".bin"):
            if os.path.exists(stem + ext):
                os.remove(stem + ext)


def device_scene(cell, seed: int, device="cuda"):
    from rtmm_tpu_torch.models import scene as scene_mod
    recipe = cell.config["recipe"]
    return scene_mod.build_device_scene(
        micromesh(recipe, cell.base(), seed),
        compressed=bool(recipe.get("compressed")), device=device)


def reference_arrays(cell) -> dict:
    return geometry.scene_arrays(cell.config["recipe"], cell.base())
