"""The camera chain of the plain density rows: its launch count and the
device dispatch.

Counterpart of the TPU backward's pass 2b, ``_feats_grad_kernel`` (B5) of
:mod:`volym_tpu.ops.slab_bwd_kernel`, driven by ``_run_feats_grad``: under
Gaussian smoothing with camera gradients and trilinear sampling, a
smoothed step's density mixes the plain rows of later steps, so the
coordinate chain of each plain row runs after the replay
(:mod:`volym_tpu_torch.ops.slab_replay`) and the stencil's transpose.  The
TPU contracts a hat and a hat-derivative matrix per step on the MXU over
the whole (N, rays) tensor of folded rows.  On the GPU the chain runs
inside the fused fold-and-scatter kernel (``csrc/voxel_grad.cu``,
``CHAIN``; :func:`volym_tpu_torch.ops.voxel_grad.fold_scatter_cuda` with
``vol``), whose thread holds each folded row's cotangent in a register
where it scatters it: no tensor of folded rows is made.

:func:`feats_grad` dispatches on the device of its tensors: CPU tensors go
to the plain version :func:`volym_tpu_torch.render.slab.feats_grad`; CUDA
tensors raise, since on the card the chain runs only fused into the fold
(:func:`volym_tpu_torch.ops.slab_march.smooth_backward`).
"""

from __future__ import annotations

from volym_tpu_torch.render import slab as slab_mod

#: launches of the fused fold-and-scatter kernel with the camera chain
#: (``CHAIN``) in this process (see
#: :func:`volym_tpu_torch.ops.voxel_grad.fold_scatter_cuda`)
LAUNCHES = 0


def feats_grad(feats, vol_perm, dd, sign, params):
    """The plain rows' camera chain from the folded rows ``dd`` on CPU
    tensors (the plain version); CUDA tensors raise: there the chain runs
    fused into the fold, which makes no folded rows (no fallback)."""
    if feats.device.type == "cpu":
        return slab_mod.feats_grad(feats, vol_perm, dd, sign, params)
    raise ValueError(f"feats_grad: on {feats.device} the plain rows' camera chain runs fused into the fold "
                     "(voxel_grad.fold_scatter_cuda with vol)")
