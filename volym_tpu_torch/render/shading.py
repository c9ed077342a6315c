"""Blinn-Phong constants (``wgsl:181-211``) and the guarded normalisation.

Counterpart of the constants and ``safe_normalize`` of
:mod:`volym_tpu.render.shading`; the t-step shading waits for the t-step
renderers.
"""

from __future__ import annotations

import torch

from volym_tpu_torch.render.rays import sqrt_rn

#: Central-difference offset in normalised volume coords (``wgsl:182``).
GRADIENT_OFFSET = 0.01
#: Light/material constants (``wgsl:199-207``).
LIGHT_DIR = (1.0, 1.0, 1.0)
AMBIENT = 0.2
DIFFUSE = 0.7
SPECULAR = 0.4
SHININESS = 24.0


def safe_normalize(v: torch.Tensor):
    """(unit-or-zero vector, mask of nonzero inputs) for (..., 3) vectors;
    the zero case is excluded before the square root.  The squares are
    summed in component order, the order the CUDA march uses, and the root
    is correctly rounded (:func:`~volym_tpu_torch.render.rays.sqrt_rn`)."""
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    sq = x * x + y * y + z * z
    nonzero = sq > 0.0
    norm = sqrt_rn(torch.where(nonzero, sq, torch.ones_like(sq)))
    return torch.where(nonzero, v / norm, torch.zeros_like(v)), nonzero
