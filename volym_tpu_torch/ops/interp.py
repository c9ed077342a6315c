"""Volume sampling (the "texture unit") and its transposes, for the t-step
renderers.

Counterpart of :mod:`volym_tpu.ops.interp`.  A (D, H, W) grid is addressed
by normalised positions ``pos = (x, y, z)`` in [0, 1]^3, clamp-to-edge:

- nearest: texel ``i = clamp(floor(p * N), 0, N - 1)``;
- trilinear: texel centres at ``(i + 0.5) / N``, corner weights from
  ``frac(p * N - 0.5)``.

Both are linear in the grid values; only trilinear is differentiable in
``pos``.  The scatters are their transposes in the grid, accumulated into a
carried gradient grid.  Every product and sum is written in the JAX
package's operation order (the blend ``c000 * (1 - tx) + c001 * tx``, op by
op: ``torch.lerp`` and ``addcmul`` round once where JAX rounds twice), so a
sample equals eager JAX's bit for bit on the CPU.
"""

from __future__ import annotations

import torch

from volym_tpu_torch.render.rays import f32_const


def _grid_dims(grid: torch.Tensor) -> torch.Tensor:
    # grid is (D, H, W) indexed [z, y, x]; pos is (x, y, z)
    d, h, w = grid.shape[-3:]
    return f32_const((float(w), float(h), float(d)), grid.device)


def _nearest_index(n: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    idx = torch.floor(pos * n)
    return torch.minimum(torch.clamp(idx, min=0.0), n - 1.0).long()


def _trilinear_corners(n: torch.Tensor, pos: torch.Tensor):
    """(i0, i1, t): the low and high corner texels (..., 3) and the +1
    corner's weights (..., 3)."""
    c = pos * n - 0.5
    i0f = torch.floor(c)
    t = c - i0f
    i0 = torch.minimum(torch.clamp(i0f, min=0.0), n - 1.0).long()
    i1 = torch.minimum(torch.clamp(i0f + 1.0, min=0.0), n - 1.0).long()
    return i0, i1, t


def sample_nearest(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Nearest sample of the (D, H, W) ``grid`` at (..., 3) positions ->
    (...,)."""
    idx = _nearest_index(_grid_dims(grid), pos)
    return grid[idx[..., 2], idx[..., 1], idx[..., 0]]


def sample_trilinear(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of the (D, H, W) ``grid`` at (..., 3) positions ->
    (...,), clamp-to-edge."""
    i0, i1, t = _trilinear_corners(_grid_dims(grid), pos)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]

    c000 = grid[z0, y0, x0]
    c001 = grid[z0, y0, x1]
    c010 = grid[z0, y1, x0]
    c011 = grid[z0, y1, x1]
    c100 = grid[z1, y0, x0]
    c101 = grid[z1, y0, x1]
    c110 = grid[z1, y1, x0]
    c111 = grid[z1, y1, x1]

    c00 = c000 * (1 - tx) + c001 * tx
    c01 = c010 * (1 - tx) + c011 * tx
    c10 = c100 * (1 - tx) + c101 * tx
    c11 = c110 * (1 - tx) + c111 * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def make_sampler(interpolation):
    """'nearest' | 'trilinear' -> sampling function."""
    from volym_tpu_torch.config import Interpolation

    interp = Interpolation(interpolation)
    return sample_nearest if interp == Interpolation.NEAREST else sample_trilinear


# ----------------------------------------------------------------------
# Scatter transposes, used by the replay backward (render/diff.py).
# ----------------------------------------------------------------------


def _add_at(acc: torch.Tensor, zi, yi, xi, g) -> torch.Tensor:
    # on CUDA the accumulating index_put_ adds a voxel's terms in no fixed
    # order: gradients there agree with the CPU's to rounding, not bit for bit
    acc.index_put_((zi.reshape(-1), yi.reshape(-1), xi.reshape(-1)), g.reshape(-1).to(acc.dtype), accumulate=True)
    return acc


def scatter_nearest_into(acc: torch.Tensor, pos: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Add ``g`` (...,) into the (D, H, W) gradient grid ``acc`` at the
    nearest-sample voxels of ``pos`` (..., 3), in place: the transpose of
    :func:`sample_nearest` in the grid.  Returns ``acc``."""
    idx = _nearest_index(_grid_dims(acc), pos)
    return _add_at(acc, idx[..., 2], idx[..., 1], idx[..., 0], g)


def scatter_trilinear_into(acc: torch.Tensor, pos: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Add ``g`` (...,) into ``acc`` with the trilinear corner weights, in
    place: the transpose of :func:`sample_trilinear` in the grid.  The eight
    corners are added in the JAX package's order; a corner's weight is
    ``g * wz * wy * wx``, left to right."""
    i0, i1, t = _trilinear_corners(_grid_dims(acc), pos)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    for zi, wz in ((z0, 1 - tz), (z1, tz)):
        for yi, wy in ((y0, 1 - ty), (y1, ty)):
            for xi, wx in ((x0, 1 - tx), (x1, tx)):
                _add_at(acc, zi, yi, xi, g * wz * wy * wx)
    return acc


def scatter_nearest(grid_shape, pos: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Fresh-grid variant of :func:`scatter_nearest_into`."""
    return scatter_nearest_into(torch.zeros(grid_shape, dtype=g.dtype, device=g.device), pos, g)


def scatter_trilinear(grid_shape, pos: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Fresh-grid variant of :func:`scatter_trilinear_into`."""
    return scatter_trilinear_into(torch.zeros(grid_shape, dtype=g.dtype, device=g.device), pos, g)


def make_scatter_into(interpolation):
    """'nearest' | 'trilinear' -> accumulate-into-grid scatter function."""
    from volym_tpu_torch.config import Interpolation

    interp = Interpolation(interpolation)
    return scatter_nearest_into if interp == Interpolation.NEAREST else scatter_trilinear_into
