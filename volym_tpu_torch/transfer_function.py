"""Transfer function: control points -> RGBA lookup table.

The LUT bake, the host-side lookup :meth:`TransferFunction.get`,
:func:`quantize_lut` and :func:`save_png` stay numpy (as in
:mod:`volym_tpu.transfer_function`); :func:`lut_sample`, the per-sample
lookup, is torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class ControlPoint:
    color: tuple[float, float, float, float]
    iso_value: float


@dataclass
class TransferFunction:
    """Separate RGB and alpha control point tracks over density in [0, 1]."""

    max_density: int = 255
    rgb_points: list[ControlPoint] = field(default_factory=list)
    alpha_points: list[ControlPoint] = field(default_factory=list)

    @classmethod
    def default(cls) -> "TransferFunction":
        """Default green->cyan->yellow->magenta->red ramp, alpha 0->1 linear."""
        tf = cls()
        tf.add_rgb(ControlPoint((0.0, 1.0, 0.0, 1.0), 0.0))
        tf.add_rgb(ControlPoint((0.0, 1.0, 1.0, 1.0), 0.2))
        tf.add_rgb(ControlPoint((1.0, 1.0, 0.0, 1.0), 0.4))
        tf.add_rgb(ControlPoint((1.0, 0.0, 1.0, 1.0), 0.6))
        tf.add_rgb(ControlPoint((1.0, 0.0, 0.0, 1.0), 1.0))
        tf.add_alpha(ControlPoint((0.0, 0.0, 0.0, 0.0), 0.0))
        tf.add_alpha(ControlPoint((0.0, 0.0, 0.0, 1.0), 1.0))
        return tf

    def add_rgb(self, p: ControlPoint) -> None:
        self.rgb_points.append(p)
        self.rgb_points.sort(key=lambda q: q.iso_value)

    def add_alpha(self, p: ControlPoint) -> None:
        self.alpha_points.append(p)
        self.alpha_points.sort(key=lambda q: q.iso_value)

    def build_lut(self) -> np.ndarray:
        """(max_density+1, 4) float32 LUT; control points snap to integer
        indices by truncation and regions outside the span stay zero."""
        n = self.max_density + 1
        lut = np.zeros((n, 4), dtype=np.float32)
        x = np.arange(n, dtype=np.float32)
        if len(self.rgb_points) >= 2:
            xp = np.array(
                [int(p.iso_value * self.max_density) for p in self.rgb_points], np.float32
            )
            sel = slice(int(xp[0]), int(xp[-1]) + 1)
            for c in range(3):
                fp = np.array([p.color[c] for p in self.rgb_points], np.float32)
                lut[sel, c] = np.interp(x[sel], xp, fp)
        if len(self.alpha_points) >= 2:
            xp = np.array(
                [int(p.iso_value * self.max_density) for p in self.alpha_points], np.float32
            )
            sel = slice(int(xp[0]), int(xp[-1]) + 1)
            fp = np.array([p.color[3] for p in self.alpha_points], np.float32)
            lut[sel, 3] = np.interp(x[sel], xp, fp)
        return lut

    def get(self, value: float) -> np.ndarray:
        """Host-side LUT lookup with linear interpolation
        (reference ``src/transfer_function.rs:127-144``)."""
        lut = self.build_lut()
        idx = np.clip(value * self.max_density, 0.0, float(self.max_density))
        i0 = int(np.floor(idx))
        i1 = min(i0 + 1, self.max_density)
        t = idx - i0
        return lut[i0] * (1.0 - t) + lut[i1] * t


def quantize_lut(lut: np.ndarray) -> np.ndarray:
    """8-bit quantisation as done on GPU upload: truncate ``v*255`` to u8
    (``src/gpu_resources/transfer_function.rs:60-69``), back to float."""
    return (np.clip(lut * 255.0, 0, 255).astype(np.uint8)).astype(np.float32) / 255.0


def save_png(tf: TransferFunction, path) -> None:
    """Save the LUT as a 1-pixel-tall PNG strip
    (reference ``src/transfer_function.rs:146-159``), through
    :func:`volym_tpu_torch.io.write_png`."""
    from volym_tpu_torch.io import write_png

    # the reference samples get(x / max_density) per pixel: the LUT's rows
    img = (np.clip(tf.build_lut(), 0, 1) * 255.0).astype(np.uint8)[None, :, :]
    write_png(path, img)


def lut_sample(lut: torch.Tensor, density: torch.Tensor, dscale: float | None = None) -> torch.Tensor:
    """1D-texture sample with linear filtering and clamp-to-edge addressing:
    texel centres at ``(i + 0.5)/N``, so the coordinate is ``density*N - 0.5``.

    ``dscale``: density arrives scaled (u8 mode: 0..255, ``dscale=1/255``);
    the scale folds into the coordinate factor in double precision and is
    rounded to float32 once, as the TPU kernel does.

    Returns ``(..., 4)`` RGBA.
    """
    n = lut.shape[0]
    c = density * (float(n) * (dscale if dscale else 1.0)) - 0.5
    c = torch.clamp(c, 0.0, n - 1.0)
    i0f = torch.floor(c)
    t = (c - i0f)[..., None]
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return lut[i0] * (1.0 - t) + lut[i1] * t
