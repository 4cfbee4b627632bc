"""Orbit ("trackball") camera.

Re-implements the reference camera controller
(framework/src/trackball.cpp) with identical math:
  - position() = lookAt + quat(euler) * (0, 0, -dist)      (trackball.cpp:71-74)
  - viewMatrix() = lookAt(position, lookAt, up)            (trackball.cpp:81-84)
  - LMB rotate (pitch clamped to +-pi/2), RMB translate in the image plane,
    wheel zoom                                             (trackball.cpp:128-163)

The app composes inverse(projection * view) once per frame and uploads only
that 4x4 to the device (src/application.cpp:204-205); we do the same — the
camera itself is pure host-side NumPy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import glmmath

ROTATION_SPEED_FACTOR = 0.3      # trackball.cpp:13
TRANSLATION_SPEED_FACTOR = 0.005  # trackball.cpp:14
ZOOM_SPEED_FACTOR = 0.5          # trackball.cpp:15


@dataclasses.dataclass
class Trackball:
    fovy: float = np.radians(50.0)          # src/application.cpp:259
    look_at: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float64))
    distance: float = 4.0                   # trackball.h default distanceFromLookAt
    rotation_euler: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float64))

    def set_camera(self, look_at, rotations, dist) -> None:
        self.look_at = np.asarray(look_at, dtype=np.float64)
        self.rotation_euler = np.asarray(rotations, dtype=np.float64)
        self.distance = float(dist)

    # -- orientation helpers (trackball.cpp:112-126) --
    def _quat(self) -> np.ndarray:
        return glmmath.quat_from_euler(self.rotation_euler)

    def position(self) -> np.ndarray:
        return self.look_at + glmmath.quat_rotate(
            self._quat(), np.array([0.0, 0.0, -self.distance]))

    def forward(self) -> np.ndarray:
        return glmmath.quat_rotate(self._quat(), np.array([0.0, 0.0, 1.0]))

    def up(self) -> np.ndarray:
        return glmmath.quat_rotate(self._quat(), np.array([0.0, 1.0, 0.0]))

    def left(self) -> np.ndarray:
        return glmmath.quat_rotate(self._quat(), np.array([1.0, 0.0, 0.0]))

    def view_matrix(self) -> np.ndarray:
        return glmmath.look_at(self.position(), self.look_at, self.up())

    # -- input handling (trackball.cpp:136-163) --
    def rotate(self, delta_x: float, delta_y: float) -> None:
        """Mouse-drag rotate; deltas in pixels, positive = right/up."""
        self.rotation_euler[0] = np.clip(
            self.rotation_euler[0] - np.radians(delta_y * ROTATION_SPEED_FACTOR),
            -np.pi / 2.0, np.pi / 2.0)
        self.rotation_euler[1] -= np.radians(delta_x * ROTATION_SPEED_FACTOR)

    def translate(self, delta_x: float, delta_y: float) -> None:
        self.look_at = (
            self.look_at
            + delta_x * TRANSLATION_SPEED_FACTOR * self.left()
            - delta_y * TRANSLATION_SPEED_FACTOR * self.up())

    def zoom(self, scroll_y: float) -> None:
        self.distance += -float(scroll_y) * ZOOM_SPEED_FACTOR

    def generate_ray(self, pixel_ndc) -> tuple[np.ndarray, np.ndarray]:
        """Ray through a pixel in NDC [-1, 1] (trackball.cpp:101-110).

        Returns (origin, direction). Uses the trackball's own fovy — note
        the reference app instead unprojects with its projection matrix in
        the raygen shader; this method exists for API parity.
        """
        half_h = np.tan(self.fovy / 2.0)
        px, py = float(pixel_ndc[0]), float(pixel_ndc[1])
        cam_dir = np.array([-px * half_h, py * half_h, 1.0])
        cam_dir /= np.linalg.norm(cam_dir)
        return self.position(), glmmath.quat_rotate(self._quat(), cam_dir)


def inv_view_proj(trackball: Trackball, width: int, height: int,
                  fov_y_degrees: float = 80.0, near: float = 0.1,
                  far: float = 1000.0) -> np.ndarray:
    """inverse(projection * view), as src/application.cpp:42,204.

    Note the reference uses a *different* fov for the projection matrix (80
    degrees, application.cpp:42) than the trackball's own fovy (50 degrees,
    application.cpp:259, only used by the unused generateRay path). We keep
    that quirk: projection fov comes from the render config.
    """
    proj = glmmath.perspective(
        np.radians(fov_y_degrees), width / height, near, far)
    view = trackball.view_matrix()
    return glmmath.inverse(proj @ view)
