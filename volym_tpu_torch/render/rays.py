"""Ray generation and ray-box intersection (``wgsl:162-234``).

Counterpart of :mod:`volym_tpu.render.rays`, on tensors.  Divisions by a
Python scalar are written tensor by tensor: PyTorch evaluates
``scalar / tensor`` (and, on CUDA, ``tensor / scalar``) through a
reciprocal, one rounding away from the true quotient the JAX package
computes, and the subtexel snap downstream turns such ulps into texel flips.
For the same reason every square root of the package goes through
:func:`sqrt_rn`, and the one dot product that JAX contracts into fused
multiply-adds through :func:`fma_rn`.
"""

from __future__ import annotations

import torch


def pixel_ndc(height: int, width: int, device="cpu") -> torch.Tensor:
    """(H*W, 2) NDC coords (``u = x/W``, no half-pixel offset), row-major
    over pixels (y outer, x inner)."""
    f32 = dict(dtype=torch.float32, device=device)
    xs = torch.arange(width, **f32) / torch.tensor(float(width), **f32)
    ys = torch.arange(height, **f32) / torch.tensor(float(height), **f32)
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    ndc = torch.stack([u * 2.0 - 1.0, 1.0 - v * 2.0], dim=-1)
    return ndc.reshape(-1, 2)


def unproject_ndc(camera_matrices, ndc: torch.Tensor) -> torch.Tensor:
    """NDC points (R, 2) at clip z=0 -> world positions (R, 3), as
    elementwise multiply-adds (``world = x*col0 + y*col1 + col3``)."""
    ivp = camera_matrices.inverse_view_proj
    world = (
        ndc[:, 0:1] * ivp[:, 0][None, :]
        + ndc[:, 1:2] * ivp[:, 1][None, :]
        + ivp[:, 3][None, :]
    )
    return world[:, :3] / world[:, 3:4]


def f32_const(value, device) -> torch.Tensor:
    """The float32 tensor of ``value`` (a number or a tuple) on ``device``:
    a constant of the t-step march.  A divisor must be one, on the device
    of what it divides (a Python scalar divides through a reciprocal on
    CUDA)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor, on every
    device.  ``torch.sqrt`` on float32 CPU tensors runs a vectorised kernel
    picked by the CPU's capability (AVX2, AVX512) that is one ulp off the
    correctly rounded root for some inputs (433 of 65,536 on an AVX512
    machine); JAX's and CUDA's roots are correctly rounded.  The float64
    root rounded to float32 is the correctly rounded float32 root (53 bits
    >= 2 * 24 + 2, so the double rounding is innocuous)."""
    return torch.sqrt(x.double()).float()


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add does.
    The product is exact in float64; the sum is split into its float64
    rounding and the exact error (TwoSum), and the error decides the one
    case where rounding the float64 sum to float32 goes wrong: a sum that
    lands exactly halfway between two float32 neighbours."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r64 = r.double()
    r = torch.where((s == (r64 + up.double()) * 0.5) & (err > 0), up, r)
    return torch.where((s == (r64 + down.double()) * 0.5) & (err < 0), down, r)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """(R, 3) -> (R, 1) Euclidean norm, summed in component order."""
    return sqrt_rn(v[:, 0:1] * v[:, 0:1] + v[:, 1:2] * v[:, 1:2] + v[:, 2:3] * v[:, 2:3])


def rays_from_ndc(camera_matrices, ndc: torch.Tensor):
    """(origin (3,), unit directions (R, 3)) of the pinhole camera's rays
    through the NDC points ``ndc`` (R, 2): ray by ray the values of
    :func:`generate_rays`, whose rays they are for ``pixel_ndc``'s rows, so
    a shard of a frame builds only its own rays."""
    pos = unproject_ndc(camera_matrices, ndc)
    d = pos - camera_matrices.position[None, :]
    return camera_matrices.position, d / norm3(d)


def generate_rays(camera_matrices, height: int, width: int):
    """(origin (3,), unit directions (H*W, 3)) of the pinhole camera."""
    return rays_from_ndc(camera_matrices, pixel_ndc(height, width, camera_matrices.position.device))


def ray_box_intersection(origin: torch.Tensor, directions: torch.Tensor):
    """Slab test against [0,1]^3; (entry, exit) clamped to >= 0, and a miss
    is ``exit <= entry``."""
    t1 = (0.0 - origin[None, :]) / directions
    t2 = (1.0 - origin[None, :]) / directions
    entry = torch.amax(torch.minimum(t1, t2), dim=-1)
    exit_ = torch.amin(torch.maximum(t1, t2), dim=-1)
    return torch.clamp(entry, min=0.0), torch.clamp(exit_, min=0.0)
