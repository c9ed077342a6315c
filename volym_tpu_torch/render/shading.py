"""Gradient estimation and Blinn-Phong shading (``wgsl:181-211``).

Counterpart of :mod:`volym_tpu.render.shading`.  The slab march uses the
constants and :func:`safe_normalize`; the t-step renderers use all of it.
Sums over a vector's three components run in component order, square roots
go through :func:`~volym_tpu_torch.render.rays.sqrt_rn`, and the central
difference divides tensor by tensor (C5 in ``ROADMAP.md``), so the shade
equals eager JAX's to the last bit but for ``** SHININESS``, whose power
function may differ from XLA's by an ulp.
"""

from __future__ import annotations

import torch

from volym_tpu_torch.render.rays import f32_const, norm3, sqrt_rn

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


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) . (..., 3) -> (..., 1), summed in component order."""
    return a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2] + a[..., 2:3] * b[..., 2:3]


def compute_gradient(sample_fn, pos: torch.Tensor) -> torch.Tensor:
    """Central-difference density gradient (``wgsl:181-188``), unnormalised:
    ``sample_fn`` maps positions (..., 3) to densities (...,); -> (..., 3).
    The normalisation, with its guard for a zero gradient, is left to
    :func:`blinn_phong`."""
    eps = GRADIENT_OFFSET
    # a division by a Python scalar would go through a reciprocal on CUDA
    two_eps = f32_const(2.0 * eps, pos.device)
    grads = []
    for axis in range(3):
        off = f32_const(tuple(eps if i == axis else 0.0 for i in range(3)), pos.device)
        hi = sample_fn(pos + off)
        lo = sample_fn(pos - off)
        grads.append((hi - lo) / two_eps)
    return torch.stack(grads, dim=-1)


def blinn_phong(sample_fn, pos: torch.Tensor, color: torch.Tensor, camera_position: torch.Tensor) -> torch.Tensor:
    """Blinn-Phong shading of a sample (``wgsl:190-211``): ambient 0.2,
    diffuse 0.7 max(0, n.l), specular 0.4 max(0, h.n)^24, white specular;
    the unshaded colour where the gradient vanishes."""
    g = compute_gradient(sample_fn, pos)
    return blinn_phong_from_gradient(g, pos, color, camera_position)


def blinn_phong_from_gradient(g: torch.Tensor, pos: torch.Tensor, color: torch.Tensor,
                              camera_position: torch.Tensor) -> torch.Tensor:
    """Blinn-Phong given the (unnormalised) gradient ``g`` (..., 3): the
    replay backward obtains it from the step's tap samples."""
    n, nonzero = safe_normalize(g)
    light = f32_const((LIGHT_DIR,), pos.device)
    light = (light / norm3(light))[0]
    eye, _ = safe_normalize(camera_position - pos)
    half, _ = safe_normalize(eye + light)

    # torch.maximum, not clamp: at a tie it passes half the gradient, as
    # jnp.maximum does
    n_l, h_n = _dot3(n, light), _dot3(half, n)
    diffuse = torch.maximum(torch.zeros_like(n_l), n_l)
    spec = torch.maximum(torch.zeros_like(h_n), h_n) ** SHININESS
    shaded = color * (AMBIENT + DIFFUSE * diffuse) + SPECULAR * spec
    return torch.where(nonzero, shaded, color)
