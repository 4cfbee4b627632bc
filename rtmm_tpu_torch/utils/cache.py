"""Scene precompute disk cache.

The reference's only persisted artifact is the input asset (SURVEY §5:
checkpoint/resume = none). The scene precompute (scales/minmax/deltas/leaf
expansion) is the slow cold path, so DeviceScene tensors are cached to
disk keyed by (asset bytes hash, build options, format version).

Key and file format are the JAX package's (its utils/cache.py): the same
asset and options give the same key, and a file either package wrote
loads into the other (models/scene.py::scene_from_arrays).
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from ..models.scene import DeviceScene, scene_arrays, scene_from_arrays

# Part of the cache key: bump whenever the DeviceScene schema changes so
# stale files are orphaned instead of loaded into the new dataclass.
# v4: unit_q -> unit_qn, cluster hierarchy tables, unit_leaf_idx.
# v5: optional (None) hierarchy/unit tables; compressed-scene fields.
# v6: unit_qn/unit_e2w2 recentered about unit AABB centers (unit_grid
#     records stay absolute — the kernel recenters at derive time, so
#     compressed caches are layout-compatible but keyed anyway).
# v7: indexed compressed scenes (mixed-level/stitched; `indexed` meta,
#     IDX_ROWS records).
FORMAT_VERSION = 7


def asset_cache_key(path: str, tessellated: bool,
                    hierarchy: bool = True,
                    compressed: bool = False) -> str:
    h = hashlib.sha256()
    h.update(f"v{FORMAT_VERSION}:tess={tessellated}:"
             f"hier={hierarchy}:comp={compressed}:".encode())
    with open(path, "rb") as f:
        h.update(f.read())
    # Sibling .bary travels with the gltf.
    bary = os.path.splitext(path)[0] + ".bary"
    if os.path.exists(bary):
        with open(bary, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:24]


def save_scene(scene: DeviceScene, cache_path: str) -> None:
    """Write the scene's tensors (every field that is not None) and its
    meta fields to an .npz."""
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    np.savez_compressed(cache_path, **scene_arrays(scene))


def load_scene(cache_path: str, device="cuda") -> DeviceScene:
    """Read a saved scene onto `device`."""
    with np.load(cache_path) as z:
        return scene_from_arrays(z, device=device)


def build_device_scene_cached(asset_path: str, tessellated: bool = False,
                              cache_dir: str | None = None,
                              hierarchy: bool = True,
                              compressed: bool = False,
                              device="cuda") -> DeviceScene:
    """Load an asset with precompute caching (keyed by content hash)."""
    from ..io import loader
    from ..models.scene import build_device_scene

    cache_dir = cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "rtmm_tpu_torch")
    key = asset_cache_key(asset_path, tessellated, hierarchy, compressed)
    cache_path = os.path.join(cache_dir, f"{key}.npz")
    if os.path.exists(cache_path):
        try:
            return load_scene(cache_path, device=device)
        except (TypeError, KeyError, ValueError, OSError):
            pass    # stale or corrupt cache file: rebuild it below
    mesh = loader.load_micromesh(asset_path)
    scene = build_device_scene(mesh, tessellated=tessellated,
                               hierarchy=hierarchy, compressed=compressed,
                               device=device)
    save_scene(scene, cache_path)
    return scene
