"""The camera chain of the plain density rows on the GPU: the CUDA kernel's
wrapper and the device dispatch.

Counterpart of the TPU backward's pass 2b, ``_feats_grad_kernel`` (B5) of
:mod:`volym_tpu.ops.slab_bwd_kernel`, driven by ``_run_feats_grad``: under
Gaussian smoothing with camera gradients and trilinear sampling, a
smoothed step's density mixes the plain rows of later steps, so the
coordinate chain of each plain row runs after the replay
(:mod:`volym_tpu_torch.ops.slab_replay`) and the stencil's transpose, from
the folded cotangents that the fused fold-and-scatter
(:func:`volym_tpu_torch.ops.voxel_grad.fold_scatter_cuda`) writes.  The TPU contracts a hat and a hat-derivative matrix per step
on the MXU over an inverted grid with an aliased accumulator; the CUDA
kernel (``csrc/feats_grad.cu``) runs one thread per ray over the march
steps and writes its four table rows once.

:func:`feats_grad` dispatches on the device of its tensors: CPU tensors go
to the plain version :func:`volym_tpu_torch.render.slab.feats_grad`; CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from volym_tpu_torch.config import Interpolation, RenderParams
from volym_tpu_torch.render import slab as slab_mod
from volym_tpu_torch.render.slab import N_FEATURES

#: launches of the CUDA kernel in this process (see :func:`feats_grad_cuda`)
LAUNCHES = 0


def _library():
    from volym_tpu_torch.ops import _build

    lib = _build.library("feats_grad")
    fn = lib.feats_grad_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 7 + [ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return fn


def feats_grad_cuda(feats: torch.Tensor, vol_perm: torch.Tensor, dd: torch.Tensor, sign: int, params: RenderParams):
    """Launch the CUDA kernel; same arguments and result as
    :func:`slab.feats_grad`.  ``dd`` (N, H, W) may be a view of one channel
    of a (N, 4, H, W) tensor: each step's (H, W) plane must be contiguous,
    and the kernel reads it at the view's step stride.  ``d_feats`` is
    zero-filled here; the kernel writes its four rows for every ray."""
    global LAUNCHES
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"feats_grad_cuda needs CUDA tensors, got {dev}")
    if params.interpolation != Interpolation.TRILINEAR:
        raise ValueError("the plain rows' camera chain needs trilinear sampling: box hats have no derivative")
    for name, t in (("feats", feats), ("vol_perm", vol_perm), ("dd", dd)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
    for name, t in (("feats", feats), ("vol_perm", vol_perm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_f, height, width = feats.shape
    n, nr, nc = vol_perm.shape
    if n_f != N_FEATURES or feats.dtype != torch.float32:
        raise ValueError(f"feats must be float32 ({N_FEATURES}, H, W), got {feats.dtype} {tuple(feats.shape)}")
    if vol_perm.dtype != torch.float32:
        raise ValueError(f"vol_perm must be float32, got {vol_perm.dtype}")
    if dd.dtype != torch.float32 or tuple(dd.shape) != (n, height, width):
        raise ValueError(f"dd must be float32 ({n}, {height}, {width}), got {dd.dtype} {tuple(dd.shape)}")
    if dd.stride(2) != 1 or dd.stride(1) != width:
        raise ValueError(f"dd's (H, W) planes must be contiguous, got strides {dd.stride()}")
    d_feats = torch.zeros_like(feats)
    fn = _library()
    with torch.cuda.device(dev):
        rc = fn(
            feats.data_ptr(), vol_perm.data_ptr(), dd.data_ptr(), d_feats.data_ptr(),
            height, width, n, nr, nc, int(sign), int(params.subtexel_bits), dd.stride(0),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"feats_grad kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return d_feats


def feats_grad(feats, vol_perm, dd, sign, params):
    """The plain rows' camera chain on the tensors' device: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors (no fallback
    between them)."""
    if feats.device.type == "cpu":
        return slab_mod.feats_grad(feats, vol_perm, dd, sign, params)
    return feats_grad_cuda(feats, vol_perm, dd, sign, params)
