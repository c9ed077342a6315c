"""The t-step differentiable renderer: a fixed-step march with a replay
backward that keeps no per-step state.

Counterpart of :mod:`volym_tpu.render.diff`.  The compositing recurrence
can be replayed front to back: the backward pass reconstructs each step's
transmittance ``T_k = 1 - acc_a_k`` from the running accumulator and the
suffix sums it needs from the saved final image,

    acc_c = sum_k w_k c_k,  w_k = T_k beta_k,  T_k = prod_{j<k}(1 - beta_j)

    dL/dc_k    = g_c * w_k
    dL/dbeta_k = T_k (g_c . c_k + g_a)
                 - (g_c . S_c^{>k} + g_a S_a^{>k}) / (1 - beta_k)

with ``S^{>k} = final - prefix_{<=k}``: O(rays) memory and one more
forward sweep.  The volume enters a step only through its tap samples
(the density taps, Gaussian offsets along the ray, and the
central-difference shading offsets), so a step is factored as ``taps ->
samples -> quantities``; autograd differentiates the small ``quantities``
function a step (:func:`_quantities_from_samples`), the samples'
cotangents are scattered into a gradient grid carried through the replay
(``interp.scatter_*_into``), and the taps' cotangents are chained to
(origin, dirs, entry) by hand: the taps are affine in them.

The discrete decisions (threshold, early termination, look-ahead skip) are
constants of the backward pass, recomputed bit for bit in the replay.  The
step is fixed (adaptive stepping is forward-only), so the sample positions
are affine in (entry, k) and the camera gradient is defined.

Two guards differ from the JAX package where its gradients are NaN, and
agree with them wherever those are finite: the entry's division by a
direction component that is exactly zero (C6 in ``ROADMAP.md``,
:func:`ray_box_intersection`), and the opacity correction of a masked step
at the LUT's opaque end (C11, :func:`_quantities_from_density`).  At the
coloring's kink the red channel passes half its gradient, as
``jnp.minimum`` does (C9, :func:`golden.importance_to_color`).
"""

from __future__ import annotations

import math

import torch

from volym_tpu_torch.config import Interpolation, RenderParams
from volym_tpu_torch.ops import interp
from volym_tpu_torch.render import rays as rays_mod
from volym_tpu_torch.render import shading
from volym_tpu_torch.render.rays import f32_const
from volym_tpu_torch.render.golden import (
    GAUSSIAN_KERNEL_SIZE,
    GAUSSIAN_SIGMA,
    GAUSSIAN_STEP,
    IMPORTANCE_OPAQUE,
    has_important_ahead_cone,
    has_important_ahead_straight,
    importance_to_color,
    miss_color,
)
from volym_tpu_torch.transfer_function import lut_sample

_EPS_ONE_MINUS_BETA = 1e-7


# ----------------------------------------------------------------------
# Tap structure: every volume access of one march step, as a fixed list.
# ----------------------------------------------------------------------


def _tap_spec(params: RenderParams):
    """(ray_offsets, axis_offsets): a step's taps are ``pos + dirs *
    ray_offsets[i]`` (the density taps), then ``pos + axis_offsets[j]``
    (the shading taps)."""
    if params.use_gaussian_smoothing:
        ray_offsets = [i * GAUSSIAN_STEP for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1)]
    else:
        ray_offsets = [0.0]
    axis_offsets = []
    if params.use_shading:
        eps = shading.GRADIENT_OFFSET
        for axis in range(3):
            for sign in (1.0, -1.0):
                off = [0.0, 0.0, 0.0]
                off[axis] = sign * eps
                axis_offsets.append(off)
    return ray_offsets, axis_offsets


def _tap_positions(params: RenderParams, pos, dirs):
    """(R, T, 3) tap positions of a step at the (R, 3) ray positions."""
    ray_offsets, axis_offsets = _tap_spec(params)
    taps = [pos + dirs * off for off in ray_offsets]
    taps += [pos + f32_const(tuple(off), pos.device)[None, :] for off in axis_offsets]
    return torch.stack(taps, dim=1)


def _density_from_samples(params: RenderParams, samples, pos, dirs):
    """A step's density from its (R, T) tap samples: the first tap, or the
    Gaussian-weighted density taps (``wgsl:44-75``)."""
    if not params.use_gaussian_smoothing:
        return samples[:, 0]
    ray_offsets, _ = _tap_spec(params)
    device = samples.device
    zero = f32_const(0.0, device)
    total = torch.zeros(samples.shape[:1], dtype=torch.float32, device=device)
    weight_sum = torch.zeros(samples.shape[:1], dtype=torch.float32, device=device)
    for i, off in enumerate(ray_offsets):
        p = pos + dirs * off
        in_bounds = torch.all((p >= 0.0) & (p <= 1.0), dim=-1)
        wgt = math.exp(-(off * off) / (2.0 * GAUSSIAN_SIGMA * GAUSSIAN_SIGMA))
        total = total + torch.where(in_bounds, samples[:, i] * wgt, zero)
        weight_sum = weight_sum + torch.where(in_bounds, f32_const(wgt, device), zero)
    return total / torch.where(weight_sum > 0.0, weight_sum, torch.ones_like(weight_sum))


def _quantities_from_samples(params: RenderParams, samples, imp, lut, pos, dirs, cam_pos):
    """A step's march quantities from its (R, T) tap samples in tap-spec
    order (``wgsl:251-314`` without control flow and texture fetches):
    (shaded (R, 3), alpha (R,), density (R,))."""
    density = _density_from_samples(params, samples, pos, dirs)
    shaded, alpha = _quantities_from_density(params, density, samples, imp, lut, pos, cam_pos)
    return shaded, alpha, density


def _quantities_from_density(params: RenderParams, density, samples, imp, lut, pos, cam_pos, live=None):
    """(shaded (R, 3), alpha (R,)) of :func:`_quantities_from_samples`
    from the step's density.

    ``live``: the (R,) mask of the rays the step composites, given in the
    replay.  Elsewhere the opacity correction's base ``1 - a`` is replaced
    by 1 (alpha 0) before the power: at the LUT's opaque end (``a`` = 1)
    its derivative is infinite, and a masked step's zero cotangent would
    make it NaN (C11 in ``ROADMAP.md``).  A masked step's alpha is
    multiplied by 0 wherever it is used, so nothing else changes."""
    n_density = len(_tap_spec(params)[0])
    device = samples.device

    if params.use_importance_coloring:
        # half the red channel's gradient at the kink, as jnp.minimum (C9)
        color_alpha = importance_to_color(imp)
    else:
        color_alpha = lut_sample(lut, density)

    if params.use_shading:
        two_eps = f32_const(2.0 * shading.GRADIENT_OFFSET, device)  # tensor by tensor (C5)
        grads = []
        for axis in range(3):
            hi = samples[:, n_density + 2 * axis]
            lo = samples[:, n_density + 2 * axis + 1]
            grads.append((hi - lo) / two_eps)
        g = torch.stack(grads, dim=-1)
        shaded = shading.blinn_phong_from_gradient(g, pos, color_alpha[..., :3], cam_pos)
    else:
        shaded = color_alpha[..., :3]

    # the exponent: the step times 100 in double, rounded to float32 once
    # (golden.py's is a float32 product)
    exponent = f32_const(params.raymarching_step_size * 100.0, device)
    base = 1.0 - color_alpha[..., 3]
    if live is not None:
        base = torch.where(live, base, torch.ones_like(base))
    alpha = 1.0 - torch.pow(base, exponent)
    return shaded, alpha


def _contribute_mask(params: RenderParams, importance_grid, density, imp, pos, dirs, t, exit_, acc_a):
    """The march's discrete decisions, recomputed bit for bit in the
    forward and the replay sweeps."""
    active = (t < exit_) & (acc_a < params.early_termination_alpha)
    dense = density >= params.density_threshold
    skip = ~dense
    if params.use_importance_rendering and not params.use_importance_coloring:
        if params.use_cone_importance_check:
            ahead = has_important_ahead_cone(importance_grid, pos, dirs, exit_, params.importance_check_ahead_steps)
        else:
            ahead = has_important_ahead_straight(importance_grid, pos, dirs, exit_,
                                                 params.importance_check_ahead_steps)
        skip = skip | ((imp < IMPORTANCE_OPAQUE) & ahead)
    return active & ~skip


def _step_offsets(params: RenderParams, num_steps: int, device) -> torch.Tensor:
    """``k * step`` for k < num_steps, each a float32 product."""
    return torch.arange(num_steps, dtype=torch.float32, device=device) * f32_const(params.raymarching_step_size,
                                                                                   device)


def _step_inputs(params, volume, importance, origin, dirs, entry, k_step):
    """(t, pos, taps, samples, imp) of the step whose ``k * step`` is
    ``k_step``."""
    sample_fn = interp.make_sampler(params.interpolation)
    t = entry + k_step
    pos = origin[None, :] + dirs * t[:, None]
    taps = _tap_positions(params, pos, dirs)
    samples = sample_fn(volume, taps)
    imp = interp.sample_nearest(importance, pos)
    return t, pos, taps, samples, imp


def _march_scan(params: RenderParams, volume, importance, lut, origin, dirs, entry, exit_, cam_pos):
    """The fixed-step march (the primal): -> (R, 4) RGBA."""
    r = dirs.shape[0]
    acc_c = torch.zeros((r, 3), dtype=torch.float32, device=dirs.device)
    acc_a = torch.zeros((r,), dtype=torch.float32, device=dirs.device)
    for k_step in _step_offsets(params, params.resolved_max_steps(), dirs.device):
        t, pos, _taps, samples, imp = _step_inputs(params, volume, importance, origin, dirs, entry, k_step)
        shaded, alpha, density = _quantities_from_samples(params, samples, imp, lut, pos, dirs, cam_pos)
        m = _contribute_mask(params, importance, density, imp, pos, dirs, t, exit_, acc_a)
        beta = alpha * m
        w = (1.0 - acc_a) * beta
        acc_c = acc_c + shaded * w[:, None]
        acc_a = acc_a + w
    return torch.cat([acc_c, acc_a[:, None]], dim=-1)


class _MarchFixed(torch.autograd.Function):
    """:func:`_march_scan` forward; the replay (:func:`_march_bwd`)
    backward."""

    @staticmethod
    def forward(ctx, params, volume, importance, lut, origin, dirs, entry, exit_, cam_pos):
        img = _march_scan(params, volume, importance, lut, origin, dirs, entry, exit_, cam_pos)
        ctx.params = params
        ctx.save_for_backward(volume, importance, lut, origin, dirs, entry, exit_, cam_pos, img)
        return img

    @staticmethod
    def backward(ctx, g):
        res = ctx.saved_tensors
        return (None, *_march_bwd(ctx.params, res, g, ctx.needs_input_grad[1:]))


def march_fixed(params: RenderParams, volume, importance, lut, origin, dirs, entry, exit_, cam_pos):
    """Fixed-step differentiable march of R rays -> (R, 4) RGBA, with
    gradients for the volume, the importance (under coloring), the LUT,
    the origin, the directions, the entry and the camera position; the
    exit enters through the masks alone and gets none."""
    return _MarchFixed.apply(params, volume, importance, lut, origin, dirs, entry, exit_, cam_pos)


def _march_bwd(params: RenderParams, res, g, needs):
    """The replay: one forward step a step, each with the vector-Jacobian
    product of its quantities, front to back.  ``needs``: which of
    (volume, importance, lut, origin, dirs, entry, exit_, cam_pos) want a
    gradient; the others get ``None``."""
    volume, importance, lut, origin, dirs, entry, exit_, cam_pos, img = res
    need_vol, need_imp, need_lut, need_origin, need_dirs, need_entry, _, need_cam = needs
    need_rays = need_origin or need_dirs or need_entry
    g = g.contiguous()
    g_c, g_a = g[:, :3], g[:, 3]
    fin_c, fin_a = img[:, :3], img[:, 3]
    sample_fn = interp.make_sampler(params.interpolation)
    scatter_into = interp.make_scatter_into(params.interpolation)
    trilinear = params.interpolation == Interpolation.TRILINEAR
    ray_offsets, axis_offsets = _tap_spec(params)
    # each tap's d(tap)/d(dirs) scale
    tap_ray_off = f32_const(tuple(ray_offsets + [0.0] * len(axis_offsets)), dirs.device)
    coloring = params.use_importance_coloring

    r = dirs.shape[0]
    f32 = dict(dtype=torch.float32, device=dirs.device)
    acc_c, acc_a = torch.zeros((r, 3), **f32), torch.zeros((r,), **f32)
    dvol = torch.zeros_like(volume) if need_vol else None
    dimp = torch.zeros_like(importance) if need_imp else None
    dlut = torch.zeros_like(lut) if need_lut else None
    dorigin, ddirs, dentry = torch.zeros_like(origin), torch.zeros_like(dirs), torch.zeros_like(entry)
    dcam = torch.zeros_like(cam_pos)
    one = torch.ones((), **f32)

    for k_step in _step_offsets(params, params.resolved_max_steps(), dirs.device):
        t, pos, taps, samples, imp = _step_inputs(params, volume, importance, origin, dirs, entry, k_step)
        # the step's quantities, under autograd for their vector-Jacobian
        # product: d samples always, d imp under coloring, d lut without
        # it, and d pos, d dirs, d cam_pos for the camera
        wants = (True, coloring and need_imp, need_lut and not coloring, need_rays, need_rays, need_cam)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(w) for x, w in zip((samples, imp, lut, pos, dirs, cam_pos), wants)]
            l_samples, l_imp, l_lut, l_pos, l_dirs, l_cam = leaves
            density = _density_from_samples(params, l_samples, l_pos, l_dirs)
        # the mask from the density the vector-Jacobian product goes through,
        # before the opacity correction that needs it (C11)
        m = _contribute_mask(params, importance, density.detach(), imp, pos, dirs, t, exit_, acc_a)
        with torch.enable_grad():
            shaded, alpha = _quantities_from_density(params, density, l_samples, l_imp, l_lut, l_pos, l_cam, live=m)
        beta = alpha.detach() * m
        t_k = 1.0 - acc_a  # the prefix transmittance, reconstructed
        w = t_k * beta

        shaded_v = shaded.detach()
        new_acc_c = acc_c + shaded_v * w[:, None]
        new_acc_a = acc_a + w
        suf_c = fin_c - new_acc_c  # S_c^{>k}
        suf_a = fin_a - new_acc_a  # S_a^{>k}

        d_c = g_c * w[:, None]
        inv = one / torch.clamp(1.0 - beta, min=_EPS_ONE_MINUS_BETA)
        d_beta = t_k * ((g_c * shaded_v).sum(-1) + g_a) - ((g_c * suf_c).sum(-1) + g_a * suf_a) * inv
        d_alpha = torch.where(m, d_beta, torch.zeros_like(d_beta))

        outs = [(o, d) for o, d in ((shaded, d_c), (alpha, d_alpha)) if o.requires_grad]
        grads = [None] * len(leaves)
        diff_leaves = [i for i, x in enumerate(leaves) if x.requires_grad]
        if outs:
            got = torch.autograd.grad([o for o, _ in outs], [leaves[i] for i in diff_leaves],
                                      [d for _, d in outs], allow_unused=True)
            for i, gi in zip(diff_leaves, got):
                grads[i] = gi
        dsamples, dimp_s, dlut_g, dpos_h, ddirs_h, dcam_g = (
            torch.zeros_like(x) if gi is None else gi for x, gi in zip(leaves, grads)
        )

        # the volume and importance cotangents: scattered into the carried
        # grids
        if need_vol:
            scatter_into(dvol, taps, dsamples)
        if need_imp and coloring:
            interp.scatter_nearest_into(dimp, pos, dimp_s)
        if need_lut:
            dlut = dlut + dlut_g

        if need_rays:
            # the positions' cotangent through the sampling itself
            # (trilinear only: nearest sampling is piecewise constant)
            if trilinear:
                with torch.enable_grad():
                    taps_ = taps.detach().requires_grad_(True)
                    (dtaps,) = torch.autograd.grad(sample_fn(volume.detach(), taps_), taps_, dsamples)
            else:
                dtaps = torch.zeros_like(taps)
            # tap = pos + dirs * off_ray + const
            dpos = dpos_h + dtaps.sum(1)
            ddirs_step = ddirs_h + (dtaps * tap_ray_off[None, :, None]).sum(1)
            # pos = origin + dirs * t, t = entry + k * step
            dorigin = dorigin + dpos.sum(0)
            ddirs = ddirs + dpos * t[:, None] + ddirs_step
            dentry = dentry + (dpos * dirs).sum(-1)
        if need_cam:
            dcam = dcam + dcam_g

        acc_c, acc_a = new_acc_c, new_acc_a

    # the exit enters through the masks alone: no gradient
    return (dvol, dimp, dlut, dorigin if need_origin else None, ddirs if need_dirs else None,
            dentry if need_entry else None, None, dcam if need_cam else None)


def ray_box_intersection(origin: torch.Tensor, directions: torch.Tensor):
    """:func:`volym_tpu_torch.render.rays.ray_box_intersection` with a
    finite gradient: (entry, exit) bit for bit as there, clamped to >= 0
    by ``torch.maximum``, which passes half the gradient at a tie (the
    camera on a face of the box), as ``jnp.maximum`` does.

    C6 (``ROADMAP.md``): where a direction component is exactly zero, the
    slab quotient is infinite, never the one chosen, and yet its gradient
    0 * inf is NaN on every camera leaf in the JAX package.  Here the
    division runs on a guarded denominator (a double ``where``: 1 in place
    of the zero before, the infinite quotient, without a gradient, after),
    so that component gets a zero gradient and the others JAX's."""
    zero = directions == 0.0
    safe = torch.where(zero, torch.ones_like(directions), directions)
    with torch.no_grad():
        t1_inf = (0.0 - origin[None, :]) / directions
        t2_inf = (1.0 - origin[None, :]) / directions
    t1 = torch.where(zero, t1_inf, (0.0 - origin[None, :]) / safe)
    t2 = torch.where(zero, t2_inf, (1.0 - origin[None, :]) / safe)
    entry = torch.amax(torch.minimum(t1, t2), dim=-1)
    exit_ = torch.amin(torch.maximum(t1, t2), dim=-1)
    z = torch.zeros_like(entry)
    return torch.maximum(entry, z), torch.maximum(exit_, z)


def check_differentiable(params: RenderParams) -> None:
    """Raise ``NotImplementedError`` for first-hit (``use_opacity=False``
    without coloring): it is piecewise constant."""
    if not (params.use_opacity or params.use_importance_coloring):
        raise NotImplementedError(
            "the first-hit (use_opacity=False) mode is piecewise constant; use the golden renderer for it"
        )


def render(scene, camera_matrices, params: RenderParams, height: int, width: int) -> torch.Tensor:
    """Differentiable (H, W, 4) frame: :func:`golden.render`'s with the
    step fixed and the replay backward.  A scalar of it back-propagates to
    ``scene.volume``, ``scene.importance`` (under coloring), ``scene.tf_lut``
    and the camera matrices' ``inverse_view_proj`` and ``position`` (for
    each, set ``requires_grad``; trilinear sampling gives the positions a
    gradient through the samples)."""
    check_differentiable(params)
    params = params.replace(adaptive_stepping=False)
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = ray_box_intersection(origin, dirs)
    miss = exit_ <= entry
    img = march_fixed(params, scene.volume, scene.importance, scene.tf_lut, origin, dirs, entry, exit_.detach(),
                      camera_matrices.position)
    img = torch.where(miss[:, None], miss_color(img.device)[None, :], img)
    return img.reshape(height, width, 4)
