"""The t-step golden renderer: a masked march of a fixed number of steps,
with the cone look-ahead's directions, the importance heat map and the
Gaussian smoothing constants that the slab march shares.

Counterpart of :mod:`volym_tpu.render.golden`, a line-for-line replication
of the reference's ray-march kernel
(``shaders/importance_driven_volume_rendering.wgsl:213-330``): per-lane
``continue`` / ``break`` become whole-array masks, the data-dependent
``while`` a loop of ``resolved_max_steps()`` steps whose body is a no-op
for finished rays, the adaptive step (``wgsl:262-269``) per-ray state, and
the nested look-ahead loops are vectorised over their trip counts.  It runs
on the device of its tensors, and torch autograd differentiates it.

Every expression is written in JAX's operation order (``jnp.cross``'s
products, norms summed in component order and rooted by
:func:`~volym_tpu_torch.render.rays.sqrt_rn`, divisions tensor by tensor,
C5 in ``ROADMAP.md``), so on the CPU a frame equals eager JAX's to within
an ulp of the power functions.
"""

from __future__ import annotations

import math

import torch

from volym_tpu_torch.config import RenderParams
from volym_tpu_torch.ops import interp
from volym_tpu_torch.render import rays as rays_mod
from volym_tpu_torch.render import shading
from volym_tpu_torch.render.rays import f32_const, norm3
from volym_tpu_torch.transfer_function import lut_sample

#: Gaussian smoothing: 5 taps at t-offsets i * GAUSSIAN_STEP, i in
#: [-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE] (``wgsl:52-56, 255``)
GAUSSIAN_KERNEL_SIZE = 2
GAUSSIAN_STEP = 0.005
GAUSSIAN_SIGMA = 1.5
#: cone look-ahead constants (``wgsl:112-113``)
CONE_SAMPLES = 8
CONE_ANGLE = 0.2
#: each cone direction's offsets along the right and up vectors, cos and sin
#: of its angle times CONE_ANGLE; the angle uses 3.14159 (``wgsl:99``)
CONE_OFFSETS = tuple(
    (math.cos(angle) * CONE_ANGLE, math.sin(angle) * CONE_ANGLE)
    for angle in ((s / CONE_SAMPLES) * 2.0 * 3.14159 for s in range(CONE_SAMPLES))
)
#: importance at or above which material counts as important ahead, and at
#: or above which the current sample counts as opaque (``wgsl:133, 291``)
IMPORTANT_AHEAD_THRESHOLD = 0.5
IMPORTANCE_OPAQUE = 1.0
#: the probes a look-ahead takes when its count travels in a tensor (the
#: reference GUI slider's maximum, ``src/gui.rs:239``); unused ones are masked
AHEAD_CAP = 25


def importance_to_color(importance: torch.Tensor) -> torch.Tensor:
    """Heat-map colouring of importance (``wgsl:83-92``): (...,) -> (..., 4)
    rgba = (min(1.5 imp, 1), 1.2 (1 - imp), 0.2, imp).  The green channel
    can exceed 1 (the image writer clamps on store, as the reference's
    rgba8unorm target does).

    At the red channel's kink, ``1.5 * imp == 1`` (imp = 170/255 in
    float32, C9 in ``ROADMAP.md``), ``torch.minimum``'s gradient passes half
    of 1.5, as ``jnp.minimum`` does in the JAX package's t-step renderers,
    which the t-step port is held to.  The slab path takes no autograd
    gradient here: its backward is written by hand after the TPU kernel's."""
    scaled = importance * 1.5
    red = torch.minimum(scaled, torch.ones_like(scaled))
    return torch.stack([red, (1.0 - importance) * 1.2, torch.full_like(importance, 0.2), importance], dim=-1)


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
    offsets of :data:`CONE_OFFSETS`."""
    up = torch.zeros_like(main_dir)
    up[:, 1] = 1.0
    right = _cross(main_dir, up)
    right = right / torch.clamp(norm3(right), min=1e-12)
    new_up = _cross(main_dir, right)
    dirs = []
    for off0, off1 in CONE_OFFSETS:
        d = main_dir + right * off0 + new_up * off1
        dirs.append(d / norm3(d))
    return torch.stack(dirs, dim=-2)


def sample_density(volume, pos, ray_dir, params: RenderParams, sample_fn):
    """Density at (R, 3) positions, Gaussian-smoothed along the ray when
    ``use_gaussian_smoothing`` (``wgsl:252-259``; smoothing ``wgsl:44-75``):
    taps outside the unit box carry no weight."""
    if not params.use_gaussian_smoothing:
        return sample_fn(volume, pos)
    zero = f32_const(0.0, pos.device)
    total = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    weight_sum = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1):
        offset = i * GAUSSIAN_STEP
        p = pos + ray_dir * offset
        in_bounds = torch.all((p >= 0.0) & (p <= 1.0), dim=-1)
        w = math.exp(-(offset * offset) / (2.0 * GAUSSIAN_SIGMA * GAUSSIAN_SIGMA))
        s = sample_fn(volume, p)
        total = total + torch.where(in_bounds, s * w, zero)
        weight_sum = weight_sum + torch.where(in_bounds, f32_const(w, pos.device), zero)
    return total / torch.where(weight_sum > 0.0, weight_sum, torch.ones_like(weight_sum))


def _ahead_count(check_steps, device):
    """(probe count, the divisor of the probe step, whether the count is a
    Python int): a count in a tensor probes ``AHEAD_CAP`` taps, masked."""
    if isinstance(check_steps, int):
        return check_steps, f32_const(float(check_steps), device), True
    return AHEAD_CAP, check_steps, False


def has_important_ahead_straight(importance_grid, pos, ray_dir, max_distance, check_steps):
    """Straight look-ahead (``wgsl:141-160``) -> (R,) bool.

    Reference quirk kept (C4 in ``ROADMAP.md``): the probe step divides
    ``max_distance - length(pos)``, with ``length(pos)`` the norm of the
    position (its distance from the world origin), not the distance marched
    along the ray.  No bounds test: clamp-to-edge sampling handles probes
    outside the box.  ``check_steps``: a Python int, or a 0-dim float32
    tensor on the device (at most ``AHEAD_CAP``)."""
    kcap, div, static_k = _ahead_count(check_steps, pos.device)
    # length(pos) through norm3 (sqrt_rn), not torch.linalg.norm (C5)
    step = (max_distance - norm3(pos)[:, 0]) / div  # (R,)
    ks = torch.arange(1, kcap + 1, dtype=torch.float32, device=pos.device)  # (K,)
    p = pos[..., None, :] + ray_dir[..., None, :] * (step[..., None] * ks)[..., None]
    imp = interp.sample_nearest(importance_grid, p)  # (R, K)
    hits = imp >= IMPORTANT_AHEAD_THRESHOLD
    if not static_k:
        hits = hits & (ks <= check_steps)
    return torch.any(hits, dim=-1)


def has_important_ahead_cone(importance_grid, pos, ray_dir, max_distance, check_steps):
    """Cone look-ahead: 8 directions, each stopped at the box
    (``wgsl:108-139``) -> (R,) bool.  The box is convex, so the in-box
    probes along a straight direction form a prefix, and masking every
    out-of-box probe equals the reference's ``break``."""
    kcap, div, static_k = _ahead_count(check_steps, pos.device)
    step = (max_distance - norm3(pos)[:, 0]) / div  # (R,)
    dirs = cone_directions(ray_dir)  # (R, S, 3)
    ks = torch.arange(1, kcap + 1, dtype=torch.float32, device=pos.device)  # (K,)
    # (R, S, K, 3): at 1024x768 and K = 15, 1.1 GB a temporary
    p = pos[..., None, None, :] + dirs[..., :, None, :] * (step[..., None, None] * ks[None, None, :])[..., None]
    in_bounds = torch.all((p >= 0.0) & (p <= 1.0), dim=-1)
    imp = interp.sample_nearest(importance_grid, p)
    hits = in_bounds & (imp >= IMPORTANT_AHEAD_THRESHOLD)
    if not static_k:
        hits = hits & (ks <= check_steps)
    return torch.any(hits.reshape(hits.shape[0], -1), dim=-1)


def make_step_fn(scene, origin, directions, exit_, cam_pos, params: RenderParams, dyn=None):
    """The per-step state update shared by the fixed-count march (golden)
    and the early-exit one (``fast``): -> (step_fn, active_mask), on the
    state (t, step, acc_c, acc_a, done).

    ``dyn``: the knob tensor of :meth:`RenderParams.split_dynamic`
    (threshold, step size, early alpha, ahead steps) on the device, or
    ``None`` to read the params' floats."""
    device = directions.device
    sample_fn = interp.make_sampler(params.interpolation)
    if dyn is None:
        threshold = f32_const(params.density_threshold, device)
        base_step = f32_const(params.raymarching_step_size, device)
        early_alpha = f32_const(params.early_termination_alpha, device)
        ahead_steps = params.importance_check_ahead_steps
        # the JAX package multiplies the Python float (a double) here and
        # the knob tensor's float32 below; a quarter is exact in both
        min_step = f32_const(params.raymarching_step_size * 0.25, device)
    else:
        threshold, base_step, early_alpha, ahead_steps = dyn[0], dyn[1], dyn[2], dyn[3]
        min_step = base_step * 0.25
    use_alpha_static = params.use_opacity or params.use_importance_coloring
    look_ahead = params.use_importance_rendering and not params.use_importance_coloring

    def vol_sample(p):
        return sample_fn(scene.volume, p)

    def active_mask(carry):
        t, step, acc_c, acc_a, done = carry
        return (t < exit_) & (acc_a < early_alpha) & ~done

    def step_fn(carry):
        t, step, acc_c, acc_a, done = carry
        active = active_mask(carry)

        pos = origin[None, :] + directions * t[:, None]
        density = sample_density(scene.volume, pos, directions, params, sample_fn)
        importance = interp.sample_nearest(scene.importance, pos)

        # the adaptive step (wgsl:262-269); a fixed step when it is off
        dense = density >= threshold
        if params.adaptive_stepping:
            new_step = torch.where(dense, min_step, torch.minimum(base_step, step * 1.5))
        else:
            new_step = base_step.expand(step.shape)

        skip = ~dense  # wgsl:271-274

        if params.use_importance_coloring:
            color_alpha = importance_to_color(importance)
        else:
            if look_ahead:
                if params.use_cone_importance_check:
                    ahead = has_important_ahead_cone(scene.importance, pos, directions, exit_, ahead_steps)
                else:
                    ahead = has_important_ahead_straight(scene.importance, pos, directions, exit_, ahead_steps)
                skip = skip | ((importance < IMPORTANCE_OPAQUE) & ahead)  # wgsl:291-294
            color_alpha = lut_sample(scene.tf_lut, density)  # wgsl:297-303

        if params.use_shading:
            shaded = shading.blinn_phong(vol_sample, pos, color_alpha[..., :3], cam_pos)
        else:
            shaded = color_alpha[..., :3]

        contribute = active & ~skip
        if use_alpha_static:
            # the exponent is a float32 product of the step (diff.py's is a
            # double one)
            alpha = 1.0 - torch.pow(1.0 - color_alpha[..., 3], new_step * 100.0)
            contrib = (1.0 - acc_a) * alpha * contribute
            acc_c = acc_c + shaded * contrib[:, None]
            acc_a = acc_a + contrib
        else:
            # wgsl:319-323: the first contributing sample wins, then break
            acc_c = torch.where(contribute[:, None], shaded, acc_c)
            acc_a = torch.where(contribute, torch.ones_like(acc_a), acc_a)
            done = done | contribute

        t = torch.where(active, t + new_step, t)
        step = torch.where(active, new_step, step)
        return (t, step, acc_c, acc_a, done)

    return step_fn, active_mask


def init_state(entry, params: RenderParams, base_step=None):
    """The march's state before its first step: (t = entry, the base step,
    zero colour, zero alpha, not done)."""
    r = entry.shape[0]
    f32 = dict(dtype=torch.float32, device=entry.device)
    if base_step is None:
        step = torch.full((r,), params.raymarching_step_size, **f32)
    else:
        step = base_step.expand(r).clone()
    return (entry, step, torch.zeros((r, 3), **f32), torch.zeros((r,), **f32),
            torch.zeros((r,), dtype=torch.bool, device=entry.device))


def march(scene, origin, directions, entry, exit_, cam_pos, params: RenderParams):
    """Front-to-back masked march of all rays at once (``wgsl:243-326``),
    ``resolved_max_steps()`` steps: the shared (3,) ``origin``, (R, 3) unit
    ``directions`` and (R,) ``entry`` / ``exit_`` -> (R, 4) RGBA."""
    step_fn, _ = make_step_fn(scene, origin, directions, exit_, cam_pos, params)
    carry = init_state(entry, params)
    for _ in range(params.resolved_max_steps()):
        carry = step_fn(carry)
    _, _, acc_c, acc_a, _ = carry
    return torch.cat([acc_c, acc_a[:, None]], dim=-1)


def miss_color(device) -> torch.Tensor:
    """The colour of a ray that misses the box, (0, 0, 0, 1)
    (``wgsl:238-241``)."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=device)


def render(scene, camera_matrices, params: RenderParams, height: int, width: int) -> torch.Tensor:
    """An (H, W, 4) float32 RGBA frame on the scene's device
    (``wgsl:213-330`` end to end); misses paint (0, 0, 0, 1)."""
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    miss = exit_ <= entry
    img = march(scene, origin, dirs, entry, exit_, camera_matrices.position, params)
    img = torch.where(miss[:, None], miss_color(img.device)[None, :], img)
    return img.reshape(height, width, 4)
