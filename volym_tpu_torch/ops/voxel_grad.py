"""The voxel-gradient scatters on the GPU: the CUDA kernels' wrapper and the
device dispatch.

Counterpart of the TPU backward's pass 2, ``_voxel_grad_kernel`` (B3) and
``_voxel_grad_shaded_kernel`` (B4) of :mod:`volym_tpu.ops.slab_bwd_kernel`,
on the path the training step runs under Gaussian smoothing: the replay
(:mod:`volym_tpu_torch.ops.slab_replay`) writes each (march step, ray)'s
cotangent instead of scattering it, the smoothing stencil's transpose
(:func:`volym_tpu_torch.render.slab.smooth_dd_transpose`) moves the density
channel onto the plain rows, and these kernels add each cotangent into the
physical plane of its step with the sample's own bilinear or box weights.
The TPU contracts hat matrices on the MXU per (slab block, ray chunk); the
CUDA kernels (``csrc/voxel_grad.cu``) run one thread per (step, ray) and
add with atomics.

:func:`scatter` dispatches on the device of its tensors: CPU tensors go to
the plain version :func:`volym_tpu_torch.render.slab.voxel_grad`; CUDA
tensors launch a kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from volym_tpu_torch.config import Interpolation, RenderParams
from volym_tpu_torch.render import slab as slab_mod
from volym_tpu_torch.render.slab import N_FEATURES

#: launches of the 1-channel (B3) and the 4-channel (B4) scatter kernels in
#: this process (see :func:`scatter_cuda`)
LAUNCHES = 0
SHADED_LAUNCHES = 0


def _library():
    from volym_tpu_torch.ops import _build

    lib = _build.library("voxel_grad")
    fn = lib.voxel_grad_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 9 + [p]
        fn.restype = ctypes.c_int
    return fn


def scatter_cuda(feats: torch.Tensor, dd: torch.Tensor, vol_shape, sign: int, params: RenderParams):
    """Launch the B3 (``dd`` (N, H, W)) or the B4 (``dd`` (N, 4, H, W))
    scatter kernel; same arguments and result as :func:`slab.voxel_grad`.
    The outputs are zero-filled here (``torch.zeros``); the summation order
    of the atomics, and so the last bits of ``d_vol`` and ``d_grad``,
    change from run to run."""
    global LAUNCHES, SHADED_LAUNCHES
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_cuda needs CUDA tensors, got {dev}")
    for name, t in (("feats", feats), ("dd", dd)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_f, height, width = feats.shape
    n, nr, nc = (int(s) for s in vol_shape)
    if n_f != N_FEATURES or feats.dtype != torch.float32:
        raise ValueError(f"feats must be float32 ({N_FEATURES}, H, W), got {feats.dtype} {tuple(feats.shape)}")
    shaded = dd.dim() == 4
    want = (n, 4, height, width) if shaded else (n, height, width)
    if dd.dtype != torch.float32 or tuple(dd.shape) != want:
        raise ValueError(f"dd must be float32 (N, H, W) or (N, 4, H, W) = {want}, got {dd.dtype} {tuple(dd.shape)}")
    d_vol = torch.zeros((n, nr, nc), dtype=torch.float32, device=dev)
    d_grad = torch.zeros((3, n, nr, nc), dtype=torch.float32, device=dev) if shaded else None
    fn = _library()
    with torch.cuda.device(dev):
        rc = fn(
            feats.data_ptr(), dd.data_ptr(), d_vol.data_ptr(), d_grad.data_ptr() if shaded else None,
            height, width, n, nr, nc, int(sign), int(params.subtexel_bits),
            int(params.interpolation == Interpolation.TRILINEAR), int(shaded),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"voxel_grad kernel launch failed with CUDA error {rc}")
    if shaded:
        SHADED_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return d_vol, d_grad


def scatter(feats, dd, vol_shape, sign, params):
    """The voxel-gradient scatter on the tensors' device: the plain version
    for CPU tensors, a CUDA kernel for CUDA tensors (no fallback between
    them)."""
    if feats.device.type == "cpu":
        return slab_mod.voxel_grad(feats, dd, vol_shape, sign, params)
    return scatter_cuda(feats, dd, vol_shape, sign, params)
