"""Inverse rendering: fit scene parameters to a target image.

Counterpart of :mod:`volym_tpu.optim`: Adam on the selected scene leaves
through the t-step differentiable renderer (:func:`render.diff.render`,
the replay backward), each leaf projected onto [0, 1] after every update.
``torch.optim.Adam``'s defaults are optax's ``adam``: b1 0.9, b2 0.999, eps
1e-8 added after the square root, the same bias correction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from volym_tpu_torch.config import RenderParams
from volym_tpu_torch.render import diff
from volym_tpu_torch.scene import Scene

#: the scene leaves a fit may optimise
LEAVES = ("volume", "importance", "tf_lut")


@dataclass
class FitResult:
    scene: Scene
    losses: list[float]


def l2_image_loss(img, target):
    return torch.mean((img - target) ** 2)


def fit_scene(
    scene: Scene,
    camera_matrices,
    target,
    params: RenderParams,
    *,
    steps: int = 100,
    learning_rate: float = 1e-2,
    optimize: tuple[str, ...] = ("volume", "tf_lut"),
    loss_fn: Callable = l2_image_loss,
    callback=None,
) -> FitResult:
    """Gradient-descend the ``optimize`` leaves of ``scene`` (a subset of
    :data:`LEAVES`) to match ``target`` (H, W, 4), on the scene's device.

    Each trainable leaf is a fresh leaf tensor (``detach().clone()``), and is
    kept in [0, 1] by projection after each update (the r8unorm range), in
    place on the tensor (never through ``.data``, whose edits
    ``Scene.u8_source`` cannot see).  The u8 streaming mode is cleared: a
    fitted volume is a free f32 parameter that leaves the u8 grid on the
    first update.  ``callback(i, loss)`` follows each step; the result's
    scene holds detached tensors."""
    params = params.replace(u8_volume=False)
    device = scene.device
    height, width = target.shape[:2]
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.array(target, dtype=np.float32))
    target = target.to(device=device, dtype=torch.float32)
    camera_matrices = camera_matrices.to(device)
    trainable = {k: getattr(scene, k).detach().clone().requires_grad_() for k in optimize}
    frozen = {k: getattr(scene, k) for k in LEAVES if k not in optimize}
    opt = torch.optim.Adam(list(trainable.values()), lr=learning_rate)

    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        img = diff.render(Scene(**frozen, **trainable), camera_matrices, params, height, width)
        loss = loss_fn(img, target)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for leaf in trainable.values():
                leaf.clamp_(0.0, 1.0)
        losses.append(loss.item())
        if callback is not None:
            callback(i, losses[-1])
    return FitResult(scene=Scene(**frozen, **{k: v.detach() for k, v in trainable.items()}), losses=losses)
