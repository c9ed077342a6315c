"""Image and checkpoint IO: screenshot-to-PNG (reference
``src/state.rs:161-220``) and the fitted scene's ``.npz`` checkpoints.

The PNG encoder is the standard library's ``zlib`` and ``struct``, so the
package needs no imaging library.  A checkpoint is ``np.savez`` of numpy
arrays, the JAX package's format, so each package reads the other's.
"""

from __future__ import annotations

import struct
import time
import zlib
from pathlib import Path

import numpy as np


def _numpy(a) -> np.ndarray:
    """An array or tensor (on any device, with or without a gradient) as a
    numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def to_uint8_image(img) -> np.ndarray:
    """(H, W, C) float image (array or tensor) -> uint8, with the
    clamp+quantise of an rgba8unorm store (``wgsl:328``)."""
    img = _numpy(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def png_bytes(img) -> bytes:
    """An (H, W), (H, W, 3) or (H, W, 4) image as the bytes of an 8-bit PNG."""
    arr = to_uint8_image(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]  # greyscale, RGB, RGBA
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path, img) -> None:
    """Write an (H, W), (H, W, 3) or (H, W, 4) image as an 8-bit PNG."""
    Path(path).write_bytes(png_bytes(img))


def save_screenshot(img, directory=".") -> Path:
    """Timestamped screenshot (``screenshot_{unix_ts}.png``)."""
    path = Path(directory) / f"screenshot_{int(time.time())}.png"
    write_png(path, img)
    return path


def save_checkpoint(path, params: dict) -> None:
    """Persist optimised scene parameters (voxels, TF): ``np.savez`` of each
    value as a numpy array, as the JAX package writes them."""
    np.savez(path, **{k: _numpy(v) for k, v in params.items()})


def load_checkpoint(path) -> dict:
    """A checkpoint of either package -> {name: numpy array}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
