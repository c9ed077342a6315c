"""The inputs of a run, made from the seed: volumes, the transfer function's
lookup table and the camera matrices.

The benchmark makes them and hands the same tensors to the program and to
the plain reference.  The volume generators are torch versions of the
repository's synthetic stand-ins (``volym_tpu_torch/assets.py``:
``synthetic_bonsai``, ``synthetic_teapot_segments``), run on the device in
a few large calls; the camera math is the reference app's orbit camera
(cgmath ``look_at_rh`` and the OpenGL ``perspective``, closed-form
inverses), as ``volym_tpu_torch/camera.py`` computes it.  Nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

#: importance of the teapot stand-in's segments (Cup, Ground, Lobster)
TEAPOT_IMPORTANCE = {3: 0, 4: 0, 2: 255}

#: the default transfer function: RGB and alpha control points (iso, value)
DEFAULT_RGB = ((0.0, (0.0, 1.0, 0.0)), (0.2, (0.0, 1.0, 1.0)), (0.4, (1.0, 1.0, 0.0)),
               (0.6, (1.0, 0.0, 1.0)), (1.0, (1.0, 0.0, 0.0)))
DEFAULT_ALPHA = ((0.0, 0.0), (1.0, 1.0))


def default_lut(entries: int = 256) -> np.ndarray:
    """(entries, 4) float32 RGBA table of the default ramp: control points
    snap to integer indices by truncation, linear in between, zero outside
    their span (the reference's ``TransferFunction::default``)."""
    lut = np.zeros((entries, 4), np.float32)
    x = np.arange(entries, dtype=np.float32)
    top = entries - 1
    tracks = [(DEFAULT_RGB, c, lambda v, c=c: v[c]) for c in range(3)] + [(DEFAULT_ALPHA, 3, lambda v: v)]
    for points, channel, pick in tracks:
        xp = np.array([int(iso * top) for iso, _ in points], np.float32)
        fp = np.array([pick(v) for _, v in points], np.float32)
        sel = slice(int(xp[0]), int(xp[-1]) + 1)
        lut[sel, channel] = np.interp(x[sel], xp, fp)
    return lut


def _grid(side: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    c = (torch.arange(side, dtype=torch.float32, device=device) + 0.5) / side
    return torch.meshgrid(c, c, c, indexing="ij")  # z, y, x of a (D, H, W) grid


def bonsai_u8(side: int, layout_seed: int, noise_seed: int, device) -> torch.Tensor:
    """The bonsai stand-in, (side,)*3 uint8: a ground plane, a trunk, 24
    blobs of canopy and uniform noise in [0, 0.05).  The blobs' places and
    sizes come from ``layout_seed`` (the scene), the noise from
    ``noise_seed`` (the run), each from a ``torch.Generator`` on ``device``."""
    z, y, x = _grid(side, device)
    d = torch.clamp((0.08 - y) * 20.0, 0.0, 0.6)
    rt = torch.sqrt((x - 0.5) ** 2 + (z - 0.5) ** 2)
    d += torch.clamp((0.06 * (1.2 - y) - rt) * 30.0, 0.0, 0.9) * (y < 0.55)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(layout_seed))
    u = torch.rand((24, 4), generator=gen, device=device).tolist()
    for ux, uy, uz, ur in u:
        cx, cy, cz = 0.3 + 0.4 * ux, 0.45 + 0.35 * uy, 0.3 + 0.4 * uz
        rad = 0.05 + 0.09 * ur
        rr = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
        d += torch.clamp((rad - rr) / 0.04, 0.0, 1.0) * 0.5
    del x, y, z, rt
    gen.manual_seed(int(noise_seed))
    d += torch.rand(d.shape, generator=gen, device=device) * 0.05
    return (torch.clamp(d, 0.0, 1.0) * 255).to(torch.uint8)


def teapot_u8(side: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The teapot stand-in: (density uint8, importance uint8), a ground slab,
    a cup shell and the lobster, whose importance is 255; the others' is 0."""
    z, y, x = _grid(side, device)
    density = torch.zeros_like(x)
    labels = torch.zeros(x.shape, dtype=torch.uint8, device=device)
    ground = y < 0.12
    labels[ground] = 4
    density += ground * 0.5
    r = torch.sqrt((x - 0.45) ** 2 + (y - 0.45) ** 2 + (z - 0.5) ** 2)
    cup = (r > 0.18) & (r < 0.28)
    labels[cup] = 3
    density += cup * 0.7
    r2 = torch.sqrt((x - 0.45) ** 2 + (y - 0.42) ** 2 + (z - 0.5) ** 2)
    lobster = r2 < 0.1
    labels[lobster] = 2
    density = torch.where(lobster, 0.95, density)
    importance = torch.zeros_like(labels)
    for label, value in TEAPOT_IMPORTANCE.items():
        importance[labels == label] = value
    return (torch.clamp(density, 0, 1) * 255).to(torch.uint8), importance


def make_volume(spec: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A configuration's ``volume`` entry -> (density float32 in [0, 1],
    importance float32 in [0, 1], the density's uint8 grid), on ``device``."""
    side = int(spec["side"])
    if spec["generator"] == "bonsai":
        u8 = bonsai_u8(side, spec["layout_seed"], seed, device)
        imp = torch.zeros(u8.shape, dtype=torch.float32, device=device)
    elif spec["generator"] == "teapot":
        u8, imp_u8 = teapot_u8(side, device)
        imp = imp_u8.float() / 255.0
    else:
        raise ValueError(f"unknown volume generator {spec['generator']!r}")
    return u8.float() / 255.0, imp, u8


# ---- the orbit camera (host side, numpy float32) -------------------------------------------------


def _normalize(v):
    return v / np.sqrt(np.sum(v * v))


def _basis(eye, target, up):
    eye = np.asarray(eye, dtype=np.float32)
    f = _normalize(np.asarray(target, dtype=np.float32) - eye)
    s = _normalize(np.cross(f, np.asarray(up, dtype=np.float32)))
    return eye, f, s, np.cross(s, f)


def look_at_rh(eye, target, up) -> np.ndarray:
    eye, f, s, u = _basis(eye, target, up)
    rot = np.stack([s, u, -f])
    m = np.zeros((4, 4), dtype=np.float32)
    m[:3, :3] = rot
    m[:3, 3] = -np.sum(rot * eye[None, :], axis=1)
    m[3, 3] = 1.0
    return m


def look_at_rh_inverse(eye, target, up) -> np.ndarray:
    eye, f, s, u = _basis(eye, target, up)
    m = np.zeros((4, 4), dtype=np.float32)
    m[:3, :3] = np.stack([s, u, -f], axis=-1)
    m[:3, 3] = eye
    m[3, 3] = 1.0
    return m


def perspective_gl(fovy_deg, aspect, znear, zfar) -> np.ndarray:
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    return m


def perspective_gl_inverse(fovy_deg, aspect, znear, zfar) -> np.ndarray:
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = aspect / f
    m[1, 1] = 1.0 / f
    m[2, 3] = -1.0
    m[3, 2] = (znear - zfar) / (2.0 * zfar * znear)
    m[3, 3] = (zfar + znear) / (2.0 * zfar * znear)
    return m


def orbit_matrices(azimuth: float, elevation: float, camera: dict, aspect: float) -> dict[str, np.ndarray]:
    """The four camera uniforms (``view``, ``proj``, ``inverse_view_proj``,
    ``position``) of the orbit camera at ``azimuth``/``elevation`` degrees
    around the configuration's ``camera`` target and distance."""
    target = np.asarray(camera["target"], np.float32)
    up = np.asarray((0.0, 1.0, 0.0), np.float32)
    dist = float(camera["distance"])
    h, v = np.radians(azimuth), np.radians(float(np.clip(elevation, -89.0, 89.0)))
    pos = np.array([target[0] + dist * np.sin(h) * np.cos(v), target[1] + dist * np.sin(v),
                    target[2] + dist * np.cos(h) * np.cos(v)], dtype=np.float32)
    fovy, znear, zfar = float(camera["fovy"]), float(camera["znear"]), float(camera["zfar"])
    ivp = look_at_rh_inverse(pos, target, up) @ perspective_gl_inverse(fovy, aspect, znear, zfar)
    return {"view": look_at_rh(pos, target, up), "proj": perspective_gl(fovy, aspect, znear, zfar),
            "inverse_view_proj": ivp.astype(np.float32), "position": pos}

