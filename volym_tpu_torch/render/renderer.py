"""Top-level renderer factory.

Counterpart of :mod:`volym_tpu.render.renderer` for the slab backends:
wire a scene and parameters into a callable that renders frames for
successive cameras.
"""

from __future__ import annotations

from typing import Callable

import torch

from volym_tpu_torch.config import RenderParams
from volym_tpu_torch.ops import lookahead, slab_march, slab_replay
from volym_tpu_torch.render import slab
from volym_tpu_torch.scene import Scene

BACKENDS = ("slab", "slab_cuda")


def make_renderer(
    scene: Scene,
    params: RenderParams,
    height: int,
    width: int,
    backend: str = "slab_cuda",
    device="cuda",
    differentiable: bool = False,
) -> Callable:
    """Returns ``render(camera_matrices) -> (H, W, 4)`` float32 tensor on
    ``device``.

    ``backend``: "slab" = the plain PyTorch slab march, on any device;
    "slab_cuda" = the CUDA kernels, which need a CUDA device.
    ``differentiable``: the frame carries gradients to ``scene.volume`` and
    ``scene.tf_lut`` (set ``requires_grad`` on them) through the replay
    backward; it needs ``camera_grads=False``.  Importance look-ahead
    (``use_importance_rendering``, straight or ``use_cone_importance_check``)
    gates the forward render with the look-ahead gate (the CUDA gate
    kernels with "slab_cuda").  Render modes that are not ported (Gaussian
    smoothing, importance coloring, first-hit, camera gradients, and
    look-ahead in the differentiable render) raise ``NotImplementedError``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown renderer backend {backend!r}; choose from {BACKENDS}")
    if differentiable:
        slab_march.check_differentiable(params)
    else:
        slab_march.check_supported(params)
    device = torch.device(device)
    if backend == "slab_cuda":
        if device.type != "cuda":
            raise RuntimeError(f"backend 'slab_cuda' renders on a CUDA device, got {device}")
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'slab_cuda' needs CUDA, and torch.cuda.is_available() is False")
        # CUDA tensors: the kernels
        march_fn, replay_fn, gate_fn = slab_march.march, slab_replay.replay, lookahead.gate
    else:
        march_fn, replay_fn, gate_fn = slab.march_slabs, slab.replay_slabs, slab.lookahead_gate
    scene = scene.to(device)

    if differentiable:

        def render(camera_matrices) -> torch.Tensor:
            return slab_march.render_diff(
                scene, camera_matrices, params, height, width, march_fn=march_fn, replay_fn=replay_fn
            )

        return render

    def render(camera_matrices) -> torch.Tensor:
        return slab_march.render(
            scene, camera_matrices, params, height, width, march_fn=march_fn, gate_fn=gate_fn
        )

    return render
