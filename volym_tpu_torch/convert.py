"""Carry the JAX package's values into this package's types.

The inputs are numpy arrays (``np.asarray`` of a JAX array) or objects with
the JAX package's attribute names; nothing here imports jax.  This is how a
scene, a camera and a parameter set built for :mod:`volym_tpu` render the
same frame here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from volym_tpu_torch.camera import CameraMatrices
from volym_tpu_torch.config import RenderParams
from volym_tpu_torch.scene import Scene, u8_record


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def scene(volume, importance, tf_lut, device="cpu") -> Scene:
    """A :class:`Scene` from float32 arrays.  ``volume_u8`` (with its
    record, :func:`volym_tpu_torch.scene.u8_record`) is set when the volume
    is exactly u8-representable (``round(v*255)/255 == v``), which is the
    contract of the JAX package's ``u8_volume`` path."""
    vol = np.asarray(volume, dtype=np.float32)
    q = np.round(vol * np.float32(255.0))
    volume_t = _f32(vol, device)
    u8 = None
    if q.min() >= 0 and q.max() <= 255 and np.array_equal(q.astype(np.float32) / np.float32(255.0), vol):
        u8 = torch.as_tensor(q.astype(np.uint8), device=device)
    return Scene(
        volume=volume_t,
        importance=_f32(importance, device),
        tf_lut=_f32(tf_lut, device),
        volume_u8=u8,
        u8_source=None if u8 is None else u8_record(volume_t, u8),
    )


def scene_from_jax(jax_scene, device="cpu") -> Scene:
    """:func:`scene` from a ``volym_tpu.scene.Scene``."""
    return scene(
        np.asarray(jax_scene.volume), np.asarray(jax_scene.importance),
        np.asarray(jax_scene.tf_lut), device=device,
    )


def camera_matrices(view, proj, inverse_view_proj, position, device="cpu") -> CameraMatrices:
    return CameraMatrices(
        view=_f32(view, device),
        proj=_f32(proj, device),
        inverse_view_proj=_f32(inverse_view_proj, device),
        position=_f32(position, device),
    )


def camera_matrices_from_jax(jax_cm, device="cpu") -> CameraMatrices:
    """:func:`camera_matrices` from a ``volym_tpu.camera.CameraMatrices``."""
    return camera_matrices(
        np.asarray(jax_cm.view), np.asarray(jax_cm.proj),
        np.asarray(jax_cm.inverse_view_proj), np.asarray(jax_cm.position), device=device,
    )


def render_params(jax_params) -> RenderParams:
    """Field by field from a ``volym_tpu.config.RenderParams``; the
    interpolation enum travels by its string value."""
    kw = {}
    for field in dataclasses.fields(RenderParams):
        v = getattr(jax_params, field.name)
        kw[field.name] = getattr(v, "value", v) if field.name == "interpolation" else v
    return RenderParams(**kw)
