"""NumPy re-implementations of the GLM camera math used by the reference.

The reference builds its camera matrices with glm (right-handed, GL depth
convention — glm::perspective / glm::lookAt / glm::quat(eulerAngles)):
  - projection: src/application.cpp:42
  - view:       framework/src/trackball.cpp:81-84
  - orbit quat: framework/src/trackball.cpp:71-74

These are tiny host-side (once per frame) computations, so they live in
NumPy float32 to match the reference bit-for-bit; only the resulting 4x4
inverse view-projection matrix is shipped to the TPU.
"""
from __future__ import annotations

import numpy as np


def perspective(fovy_radians: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """glm::perspective (right-handed, -1..1 clip depth)."""
    f = 1.0 / np.tan(fovy_radians / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAt (right-handed)."""
    eye = np.asarray(eye, dtype=np.float32)
    f = _normalize(np.asarray(center, dtype=np.float32) - eye)
    s = _normalize(np.cross(f, np.asarray(up, dtype=np.float32)))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def quat_from_euler(euler_xyz: np.ndarray) -> np.ndarray:
    """glm::quat(glm::vec3 eulerAngles) — returns (w, x, y, z).

    Matches glm's euler constructor (pitch=x, yaw=y, roll=z).
    """
    e = np.asarray(euler_xyz, dtype=np.float64) * 0.5
    cx, cy, cz = np.cos(e)
    sx, sy, sz = np.sin(e)
    return np.array(
        [
            cx * cy * cz + sx * sy * sz,
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
        ],
        dtype=np.float64,
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector v by quaternion q=(w,x,y,z)."""
    w = q[0]
    u = q[1:]
    v = np.asarray(v, dtype=np.float64)
    return (
        2.0 * np.dot(u, v) * u
        + (w * w - np.dot(u, u)) * v
        + 2.0 * w * np.cross(u, v)
    ).astype(np.float64)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)
