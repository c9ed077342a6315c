"""Orbit camera, its input controller and view/projection math.

Counterpart of :mod:`volym_tpu.camera`.  The orbit state and the 4x4
matrices are host-side numpy, computed exactly as the JAX package computes
them for numpy inputs (cgmath ``look_at_rh`` and the OpenGL-style
``perspective``, closed-form inverses); :class:`CameraMatrices` carries
them as float32 tensors to a device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch


def _normalize(v):
    return v / np.sqrt(np.sum(v * v))


def _basis(eye, target, up):
    eye = np.asarray(eye, dtype=np.float32)
    f = _normalize(np.asarray(target, dtype=np.float32) - eye)
    s = _normalize(np.cross(f, np.asarray(up, dtype=np.float32)))
    return eye, f, s, np.cross(s, f)


def look_at_rh(eye, target, up) -> np.ndarray:
    """Right-handed look-at view matrix (cgmath ``Matrix4::look_at_rh``)."""
    eye, f, s, u = _basis(eye, target, up)
    rot = np.stack([s, u, -f])  # rows
    m = np.zeros((4, 4), dtype=np.float32)
    m[:3, :3] = rot
    m[:3, 3] = -np.sum(rot * eye[None, :], axis=1)
    m[3, 3] = 1.0
    return m


def look_at_rh_inverse(eye, target, up) -> np.ndarray:
    """Closed-form inverse of :func:`look_at_rh` (rigid transform)."""
    eye, f, s, u = _basis(eye, target, up)
    m = np.zeros((4, 4), dtype=np.float32)
    m[:3, :3] = np.stack([s, u, -f], axis=-1)
    m[:3, 3] = eye
    m[3, 3] = 1.0
    return m


def perspective_gl(fovy_deg: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """OpenGL-convention perspective matrix (cgmath ``perspective``)."""
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    return m


def perspective_gl_inverse(fovy_deg: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """Analytic inverse of :func:`perspective_gl`."""
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = aspect / f
    m[1, 1] = 1.0 / f
    m[2, 3] = -1.0
    m[3, 2] = (znear - zfar) / (2.0 * zfar * znear)
    m[3, 3] = (zfar + znear) / (2.0 * zfar * znear)
    return m


@dataclass(frozen=True)
class Camera:
    """Orbit camera (reference ``src/camera.rs:4-74``): target box centre,
    +Y up, 90 deg fovy, orbit distance clamped to [1, 10]; the position is
    always derived from (angles, distance) around the target."""

    aspect: float = 1.0
    target: tuple[float, float, float] = (0.5, 0.5, 0.5)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fovy: float = 90.0
    znear: float = 0.01
    zfar: float = 1000.0
    horizontal_angle: float = 0.0
    vertical_angle: float = 0.0
    distance: float = 1.0
    min_distance: float = 1.0
    max_distance: float = 10.0

    def orbit(self, dh: float, dv: float, dzoom: float) -> "Camera":
        h = self.horizontal_angle + dh
        v = float(np.clip(self.vertical_angle + dv, -89.0, 89.0))
        d = float(np.clip(self.distance + dzoom, self.min_distance, self.max_distance))
        return replace(self, horizontal_angle=h, vertical_angle=v, distance=d)

    @property
    def position(self) -> np.ndarray:
        h = np.radians(self.horizontal_angle)
        v = np.radians(self.vertical_angle)
        t = np.asarray(self.target, dtype=np.float32)
        return np.array(
            [
                t[0] + self.distance * np.sin(h) * np.cos(v),
                t[1] + self.distance * np.sin(v),
                t[2] + self.distance * np.cos(h) * np.cos(v),
            ],
            dtype=np.float32,
        )

    def matrices(self, device="cpu") -> "CameraMatrices":
        return camera_matrices(
            self.position,
            np.asarray(self.target, np.float32),
            np.asarray(self.up, np.float32),
            self.fovy,
            self.aspect,
            self.znear,
            self.zfar,
            device=device,
        )


@dataclass
class CameraMatrices:
    """The reference's ``CameraUniforms``: float32 tensors on one device."""

    view: torch.Tensor
    proj: torch.Tensor
    inverse_view_proj: torch.Tensor
    position: torch.Tensor

    def to(self, device) -> "CameraMatrices":
        return CameraMatrices(
            self.view.to(device),
            self.proj.to(device),
            self.inverse_view_proj.to(device),
            self.position.to(device),
        )


def camera_matrices(position, target, up, fovy, aspect, znear, zfar, device="cpu") -> CameraMatrices:
    """The full uniform set; ``inverse_view_proj = view^-1 @ proj^-1``
    (the order of ``src/gpu_resources/camera.rs:72-76``)."""
    ivp = look_at_rh_inverse(position, target, up) @ perspective_gl_inverse(
        fovy, aspect, znear, zfar
    )

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return CameraMatrices(
        view=t(look_at_rh(position, target, up)),
        proj=t(perspective_gl(fovy, aspect, znear, zfar)),
        inverse_view_proj=t(ivp),
        position=t(position),
    )


@dataclass
class CameraController:
    """Accumulates input deltas, applied once per frame then reset
    (reference ``src/camera.rs:76-117``)."""

    sensitivity: float = 0.2
    zoom_sensitivity: float = 0.2
    rotate_horizontal: float = 0.0
    rotate_vertical: float = 0.0
    scroll: float = 0.0

    def process_mouse(self, dx: float, dy: float) -> None:
        self.rotate_horizontal = -dx * self.sensitivity
        self.rotate_vertical = -dy * self.sensitivity

    def process_scroll(self, delta: float) -> None:
        self.scroll = -delta * self.zoom_sensitivity

    def update_camera(self, camera: Camera) -> Camera:
        cam = camera.orbit(self.rotate_horizontal, self.rotate_vertical, self.scroll)
        self.rotate_horizontal = 0.0
        self.rotate_vertical = 0.0
        self.scroll = 0.0
        return cam
