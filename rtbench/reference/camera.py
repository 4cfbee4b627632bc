"""Cameras and primary rays of the benchmark, in NumPy and plain PyTorch.

A frozen copy of the reference renderer's camera: an orbit ("trackball")
camera at a pitch, yaw and distance around the origin
(framework/src/trackball.cpp:71-84, glm's euler quaternion and lookAt),
the projection perspective(radians(80), aspect, 0.1, 1000)
(src/application.cpp:42) and the inverse view-projection that is the
frame's only input (application.cpp:204-205); and its raygen
(shaders/raygen.hlsl:12-44): pixel centre -> NDC with Y flipped ->
unproject z = 0 and z = 1 -> normalised direction.

The benchmark builds every camera here and hands the same float32
matrices to the renderer and to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

FOV_Y_DEGREES, NEAR, FAR = 80.0, 0.1, 1000.0


def inv_view_projs(pitch_deg, yaw_deg, dist, width: int,
                   height: int) -> np.ndarray:
    """(F, 4, 4) float32 inverse view-projections of orbit cameras looking
    at the origin, one per entry of the broadcast (pitch, yaw, dist)
    arrays (degrees)."""
    pitch, yaw, dist = np.broadcast_arrays(
        np.radians(np.asarray(pitch_deg, np.float64)),
        np.radians(np.asarray(yaw_deg, np.float64)),
        np.asarray(dist, np.float64))
    pitch, yaw, dist = (a.reshape(-1) for a in (pitch, yaw, dist))
    # glm::quat(vec3(pitch, yaw, 0)) as (w, x, y, z).
    cx, sx = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    q = np.stack([cx * cy, sx * cy, cx * sy, -sx * sy], axis=-1)

    def rotate(v):
        w, u = q[:, :1], q[:, 1:]
        v = np.broadcast_to(v, u.shape)
        return (2.0 * (u * v).sum(-1, keepdims=True) * u
                + (w * w - (u * u).sum(-1, keepdims=True)) * v
                + 2.0 * w * np.cross(u, v))

    eye = rotate(np.stack([np.zeros_like(dist), np.zeros_like(dist),
                           -dist], axis=-1)).astype(np.float32)
    up = rotate(np.array([0.0, 1.0, 0.0])).astype(np.float32)
    f = -eye / np.linalg.norm(-eye, axis=-1, keepdims=True)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s, axis=-1, keepdims=True)
    u = np.cross(s, f)
    n = eye.shape[0]
    view = np.zeros((n, 4, 4), np.float32)
    view[:, 0, :3], view[:, 1, :3], view[:, 2, :3] = s, u, -f
    view[:, 0, 3] = -(s * eye).sum(-1)
    view[:, 1, 3] = -(u * eye).sum(-1)
    view[:, 2, 3] = (f * eye).sum(-1)
    view[:, 3, 3] = 1.0
    fy = 1.0 / np.tan(np.radians(FOV_Y_DEGREES) / 2.0)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = fy / (width / height)
    proj[1, 1] = fy
    proj[2, 2] = -(FAR + NEAR) / (FAR - NEAR)
    proj[2, 3] = -(2.0 * FAR * NEAR) / (FAR - NEAR)
    proj[3, 2] = -1.0
    return np.linalg.inv((proj @ view).astype(np.float64)).astype(np.float32)


def primary_rays(inv_view_proj: torch.Tensor, px: torch.Tensor,
                 py: torch.Tensor, width: int, height: int,
                 dtype=torch.float32):
    """(origins (n, 3), directions (n, 3)) of pixels (px, py) under the
    (n, 4, 4) or (4, 4) matrices, computed in `dtype`."""
    m = inv_view_proj.to(dtype)
    if m.dim() == 2:
        m = m.expand(px.shape[0], 4, 4)
    u = (px.to(dtype) + 0.5) / width
    v = (py.to(dtype) + 0.5) / height
    ndc_x = u * 2.0 - 1.0
    ndc_y = -(v * 2.0 - 1.0)

    def unproject(z):
        p = [m[:, i, 0] * ndc_x + m[:, i, 1] * ndc_y + (m[:, i, 2] * z
                                                        + m[:, i, 3])
             for i in range(4)]
        return torch.stack([p[0] / p[3], p[1] / p[3], p[2] / p[3]], dim=-1)

    near = unproject(0.0)
    d = unproject(1.0) - near
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    return near, d
