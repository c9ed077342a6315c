"""The cone look-ahead's sample directions (``wgsl:94-106``) and the
Gaussian smoothing constants (``wgsl:52-56, 255``).

Counterpart of ``cone_directions`` and its constants in
:mod:`volym_tpu.render.golden`; the rest of that module, the t-step golden
renderer, is not ported yet.  Every expression is written in JAX's
operation order (``jnp.cross``'s products, the norms summed in component
order and rooted by :func:`~volym_tpu_torch.render.rays.sqrt_rn`), so the
directions equal eager JAX's bit for bit.
"""

from __future__ import annotations

import math

import torch

from volym_tpu_torch.render.rays import norm3

#: Gaussian smoothing: 5 taps at t-offsets i * GAUSSIAN_STEP, i in
#: [-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE] (``wgsl:52-56, 255``)
GAUSSIAN_KERNEL_SIZE = 2
GAUSSIAN_STEP = 0.005
GAUSSIAN_SIGMA = 1.5
#: cone look-ahead constants (``wgsl:112-113``)
CONE_SAMPLES = 8
CONE_ANGLE = 0.2


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, 3) x (R, 3) cross product, in ``jnp.cross``'s operation order."""
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def cone_directions(main_dir: torch.Tensor) -> torch.Tensor:
    """The 8 unit cone directions around each of the (R, 3) unit
    ``main_dir`` -> (R, CONE_SAMPLES, 3).

    As in the reference, ``right = normalize(cross(main, (0, 1, 0)))``,
    with the normalisation guarded by 1e-12 for a vertical ray, and the
    angle uses 3.14159 (``wgsl:99``)."""
    up = torch.zeros_like(main_dir)
    up[:, 1] = 1.0
    right = _cross(main_dir, up)
    right = right / torch.clamp(norm3(right), min=1e-12)
    new_up = _cross(main_dir, right)
    dirs = []
    for s in range(CONE_SAMPLES):
        angle = (s / CONE_SAMPLES) * 2.0 * 3.14159
        off0, off1 = math.cos(angle) * CONE_ANGLE, math.sin(angle) * CONE_ANGLE
        d = main_dir + right * off0 + new_up * off1
        dirs.append(d / norm3(d))
    return torch.stack(dirs, dim=-2)
