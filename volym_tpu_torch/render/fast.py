"""The t-step serving renderer: the golden march with an early exit.

Counterpart of :mod:`volym_tpu.render.fast`.  The per-step update is the
golden's (:func:`volym_tpu_torch.render.golden.make_step_fn`); the march
runs it in blocks of ``EXIT_CHECK_EVERY`` steps and stops at the first
block boundary where every ray has finished (left the box, reached the
early-termination alpha, or taken its first hit), so a frame whose rays all
end after 120 steps costs at most 127, not the worst case's 694.  A
finished ray's step is a no-op (its updates are masked), so the steps past
its end change nothing and the frame equals the golden's bit for bit.  The
check between blocks is one host read of ``active.any()``.

:func:`render` reads the params' floats.  The JAX package's ``render``
passes the float knobs in the tensor of :meth:`RenderParams.split_dynamic`
so that a change of knob does not recompile; eager PyTorch never
recompiles, and that tensor would make every look-ahead step probe
``AHEAD_CAP`` taps and mask the extra ones.  :func:`march` still takes the
tensor (``dyn``), with its own step bound (:func:`dynamic_step_bound`),
for a caller whose knobs live on the device.
"""

from __future__ import annotations

import torch

from volym_tpu_torch.config import RenderParams
from volym_tpu_torch.render import golden
from volym_tpu_torch.render import rays as rays_mod
from volym_tpu_torch.render.rays import sqrt_rn

#: steps between two checks for an early exit
EXIT_CHECK_EVERY = 8


def dynamic_step_bound(params: RenderParams, dyn: torch.Tensor) -> int:
    """The step bound of a march whose knobs travel in ``dyn``: the unit
    box's diagonal at the smallest step, ``ceil(sqrt(3) / max(min_step,
    1e-6)) + 2``, in float32 as the JAX package computes it from its traced
    step size (``volym_tpu/render/fast.py:59-64``).  This is not
    :meth:`RenderParams.resolved_max_steps` (``int(sqrt(3) / step) + 2``
    in double): the two can differ by one."""
    if params.max_steps is not None:
        return int(params.max_steps)
    f32 = dict(dtype=torch.float32)
    base_step = dyn.detach()[1].to("cpu")
    min_step = base_step * (0.25 if params.adaptive_stepping else 1.0)
    sqrt3 = sqrt_rn(torch.tensor(3.0, **f32))
    return int(torch.ceil(sqrt3 / torch.maximum(min_step, torch.tensor(1e-6, **f32))).item()) + 2


def march(scene, origin, directions, entry, exit_, cam_pos, params: RenderParams, dyn=None, stats=None):
    """Early-exit march: the same (R, 4) RGBA as :func:`golden.march`.

    ``dyn``: the knob tensor on the device, or ``None`` to read the
    params' floats.  ``stats``: a dict, if given, receives ``steps`` (the
    steps run) and ``step_bound`` (the most the march could run)."""
    step_fn, active_mask = golden.make_step_fn(scene, origin, directions, exit_, cam_pos, params, dyn=dyn)
    block = EXIT_CHECK_EVERY
    if dyn is None:
        num_steps = params.resolved_max_steps()
        block = max(1, min(block, num_steps))
        base_step = None
    else:
        num_steps = dynamic_step_bound(params, dyn)
        base_step = dyn[1]
    num_blocks = -(-num_steps // block)
    carry = golden.init_state(entry, params, base_step)
    k = 0
    # one host read a block: the loop ends where every ray has finished
    while k < num_blocks and bool(active_mask(carry).any()):
        for _ in range(block):
            carry = step_fn(carry)
        k += 1
    if stats is not None:
        stats.update(steps=k * block, step_bound=num_blocks * block)
    _, _, acc_c, acc_a, _ = carry
    return torch.cat([acc_c, acc_a[:, None]], dim=-1)


def render(scene, camera_matrices, params: RenderParams, height: int, width: int, stats=None) -> torch.Tensor:
    """An (H, W, 4) float32 RGBA frame, equal to :func:`golden.render`'s
    bit for bit.  ``stats``: as in :func:`march`."""
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    miss = exit_ <= entry
    img = march(scene, origin, dirs, entry, exit_, camera_matrices.position, params, stats=stats)
    img = torch.where(miss[:, None], golden.miss_color(img.device)[None, :], img)
    return img.reshape(height, width, 4)
