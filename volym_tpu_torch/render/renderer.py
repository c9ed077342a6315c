"""Top-level renderer factory.

Counterpart of :mod:`volym_tpu.render.renderer`: wire a scene and
parameters into a callable that renders frames for successive cameras,
through the slab backends or the t-step ``ray`` backend.
"""

from __future__ import annotations

from typing import Callable

import torch

from volym_tpu_torch.config import RenderParams
from volym_tpu_torch.ops import feats_grad, lookahead, slab_march, slab_replay, voxel_grad
from volym_tpu_torch.render import diff, fast, slab
from volym_tpu_torch.scene import Scene
from volym_tpu_torch.tracing import span

BACKENDS = ("slab", "slab_cuda", "ray")


def slab_functions(backend: str, devices) -> tuple:
    """``(march_fn, replay_fn, scatter_fn, feats_grad_fn, gate_fn)`` of a
    slab backend on ``devices``: "slab_cuda" the CUDA kernels' wrappers,
    which need CUDA devices (no fallback), "slab" their plain versions."""
    if backend == "slab_cuda":
        for device in devices:
            if torch.device(device).type != "cuda":
                raise RuntimeError(f"backend 'slab_cuda' renders on a CUDA device, got {device}")
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'slab_cuda' needs CUDA, and torch.cuda.is_available() is False")
        return slab_march.march, slab_replay.replay, voxel_grad.smooth_scatter, feats_grad.feats_grad, lookahead.gate
    if backend == "slab":
        return slab.march_slabs, slab.replay_slabs, slab.smooth_voxel_grad, slab.feats_grad, slab.lookahead_gate
    raise ValueError(f"{backend!r} is not a slab backend")


def make_renderer(
    scene: Scene,
    params: RenderParams,
    height: int,
    width: int,
    backend: str = "slab_cuda",
    device="cuda",
    differentiable: bool = False,
    mesh=None,
) -> Callable:
    """Returns ``render(camera_matrices) -> (H, W, 4)`` float32 tensor on
    ``device``.

    ``backend``: "slab" = the plain PyTorch slab march, on any device;
    "slab_cuda" = the CUDA kernels, which need a CUDA device; "ray" = the
    t-step march of the JAX package's default renderer, in PyTorch ops on
    ``device`` (the early-exit :func:`fast.render` to serve,
    :func:`diff.render` when differentiable: fixed steps and the replay
    backward, with camera gradients through the samples under trilinear
    sampling; it reads ``adaptive_stepping``, ``max_steps`` and
    ``importance_check_ahead_steps``, and ignores ``subtexel_bits``,
    ``camera_grads`` and ``u8_volume``).
    ``differentiable``: the frame carries gradients to ``scene.volume``,
    ``scene.tf_lut`` and, under coloring, ``scene.importance`` (set
    ``requires_grad`` on them) through the replay
    backward, and with ``camera_grads`` (the default) to the camera
    matrices' ``inverse_view_proj`` and ``position`` (set ``requires_grad``
    on them) through the replay's camera chain.  Gaussian smoothing
    (``use_gaussian_smoothing``, on by default as in the reference) runs
    forward and backward, the latter through the replay, the stencil's
    transpose and the voxel-gradient scatters (one fused kernel with
    "slab_cuda") and, for camera gradients with trilinear sampling, the
    plain rows' camera chain (the CUDA kernels with "slab_cuda").
    Importance look-ahead (``use_importance_rendering``, straight or
    ``use_cone_importance_check``) gates the render, and its replay when
    differentiable, with the look-ahead gate (the CUDA gate kernels with
    "slab_cuda").  Importance coloring (``use_importance_coloring``)
    colours by importance, and differentiable carries d_importance to
    ``scene.importance``.  First-hit (``use_opacity=False``) renders but is
    not differentiable: ``NotImplementedError``, as in the JAX package.
    ``mesh``: shard the rays over a :class:`volym_tpu_torch.parallel.mesh.Mesh`
    (:func:`~volym_tpu_torch.parallel.mesh.render_sharded`, any backend); its
    devices render and ``device`` is not read.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown renderer backend {backend!r}; choose from {BACKENDS}")
    if differentiable:
        slab_march.check_differentiable(params)
    if mesh is not None:
        from volym_tpu_torch.parallel.mesh import render_sharded

        def render(camera_matrices) -> torch.Tensor:
            with span("volym.render"):
                return render_sharded(scene, camera_matrices, params, height, width, mesh,
                                      differentiable=differentiable, backend=backend)

        return render
    device = torch.device(device)
    if backend == "ray":
        # no fallback: a CUDA device without CUDA raises
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("backend 'ray' on a CUDA device needs CUDA, and torch.cuda.is_available() is False")
        scene = scene.to(device)
        march = diff.render if differentiable else fast.render

        def render(camera_matrices) -> torch.Tensor:
            with span("volym.render"):
                return march(scene, camera_matrices.to(device), params, height, width)

        return render
    march_fn, replay_fn, scatter_fn, feats_grad_fn, gate_fn = slab_functions(backend, [device])
    scene = scene.to(device)

    if differentiable:

        def render(camera_matrices) -> torch.Tensor:
            with span("volym.render"):
                return slab_march.render_diff(
                    scene, camera_matrices, params, height, width, march_fn=march_fn, replay_fn=replay_fn,
                    scatter_fn=scatter_fn, feats_grad_fn=feats_grad_fn, gate_fn=gate_fn,
                )

        return render

    def render(camera_matrices) -> torch.Tensor:
        with span("volym.render"):
            return slab_march.render(
                scene, camera_matrices, params, height, width, march_fn=march_fn, gate_fn=gate_fn
            )

    return render
