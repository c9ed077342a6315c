"""The voxel-gradient scatters on the GPU: the CUDA kernels' wrappers and
the device dispatch.

Counterpart of the TPU backward's pass 2, ``_voxel_grad_kernel`` (B3) and
``_voxel_grad_shaded_kernel`` (B4) of :mod:`volym_tpu.ops.slab_bwd_kernel`,
on the path the training step runs under Gaussian smoothing: the replay
(:mod:`volym_tpu_torch.ops.slab_replay`) writes each (march step, ray)'s
cotangent instead of scattering it, with each ray's range of steps that
carry one; the smoothing stencil's transpose moves the density channel
onto the plain rows, and the scatter adds each cotangent into the physical
plane of its step with the sample's own bilinear or box weights.  The TPU
runs the transpose in jnp between its replay and these kernels, which
contract hat matrices on the MXU per (slab block, ray chunk).  The CUDA
kernel (``csrc/voxel_grad.cu``, ``FOLD``) folds and scatters in one pass,
one thread per ray over its step range, and adds with atomics
(:func:`fold_scatter_cuda`); its variant without the fold, one thread per
(step, ray), stays for cotangents that are not folded
(:func:`scatter_cuda`).

With camera gradients and trilinear sampling the fold's ``CHAIN`` variant
also computes the plain rows' camera chain, the counterpart of the TPU's
pass 2b ``_feats_grad_kernel`` (B5): each folded row's cotangent, still in
a register at the row's snapped coordinates and plane, times the
coordinate derivative of the row's own sample, summed into the four
affine rows of ``d_feats`` (:func:`fold_scatter_cuda` with ``vol``).  No
(N, H, W) tensor of folded rows is made; its launches count in
:data:`volym_tpu_torch.ops.feats_grad.LAUNCHES` as well.

:func:`smooth_scatter` and :func:`scatter` dispatch on the device of their
tensors: CPU tensors go to the plain versions
:func:`volym_tpu_torch.render.slab.smooth_voxel_grad` and
:func:`volym_tpu_torch.render.slab.voxel_grad`; CUDA tensors launch a
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from volym_tpu_torch.config import Interpolation, RenderParams
from volym_tpu_torch.ops import feats_grad
from volym_tpu_torch.render import slab as slab_mod
from volym_tpu_torch.render.slab import N_FEATURES

#: launches of the 1-channel (B3) and the 4-channel (B4) scatter kernels
#: without the fold in this process (see :func:`scatter_cuda`)
LAUNCHES = 0
SHADED_LAUNCHES = 0
#: launches of the fused fold-and-scatter kernel, 1-channel (B3) and
#: 4-channel (B4), with the camera chain or without it, in this process
#: (see :func:`fold_scatter_cuda`)
FOLD_LAUNCHES = 0
FOLD_SHADED_LAUNCHES = 0
#: blocks the fused kernel aims to launch (see :func:`fold_chunk`)
FOLD_BLOCKS = 2048


def _bind(lib: ctypes.CDLL):
    """A loaded kernel library with the types of its two C entries set:
    ``voxel_grad_launch`` (without the fold) and ``voxel_grad_fold_launch``
    (the fold, and with ``vol`` and ``d_feats`` the camera chain)."""
    p = ctypes.c_void_p
    i = ctypes.c_int
    for fn, argtypes in ((lib.voxel_grad_launch, [p] * 4 + [i] * 9 + [p]),
                         (lib.voxel_grad_fold_launch, [p] * 6 + [i] * 10 + [p] * 3)):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _library():
    from volym_tpu_torch.ops import _build

    return _bind(_build.library("voxel_grad"))


def _check(feats: torch.Tensor, dd: torch.Tensor, vol_shape, name: str):
    """Raise for inputs the kernels do not take -> (n, nr, nc, H, W, shaded)."""
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for label, t in (("feats", feats), ("dd", dd)):
        if t.device != dev:
            raise ValueError(f"{label} is on {t.device}, feats on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    n_f, height, width = feats.shape
    n, nr, nc = (int(s) for s in vol_shape)
    if n_f != N_FEATURES or feats.dtype != torch.float32:
        raise ValueError(f"feats must be float32 ({N_FEATURES}, H, W), got {feats.dtype} {tuple(feats.shape)}")
    shaded = dd.dim() == 4
    want = (n, 4, height, width) if shaded else (n, height, width)
    if dd.dtype != torch.float32 or tuple(dd.shape) != want:
        raise ValueError(f"dd must be float32 (N, H, W) or (N, 4, H, W) = {want}, got {dd.dtype} {tuple(dd.shape)}")
    return n, nr, nc, height, width, shaded


def scatter_cuda(feats: torch.Tensor, dd: torch.Tensor, vol_shape, sign: int, params: RenderParams):
    """Launch the B3 (``dd`` (N, H, W)) or the B4 (``dd`` (N, 4, H, W))
    scatter kernel; same arguments and result as :func:`slab.voxel_grad`.
    The outputs are zero-filled here (``torch.zeros``); the summation order
    of the atomics, and so the last bits of ``d_vol`` and ``d_grad``,
    change from run to run."""
    global LAUNCHES, SHADED_LAUNCHES
    n, nr, nc, height, width, shaded = _check(feats, dd, vol_shape, "scatter_cuda")
    dev = feats.device
    d_vol = torch.zeros((n, nr, nc), dtype=torch.float32, device=dev)
    d_grad = torch.zeros((3, n, nr, nc), dtype=torch.float32, device=dev) if shaded else None
    fn = _library().voxel_grad_launch
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


def fold_chunk(n: int, height: int, width: int) -> int:
    """The plain rows one thread of the fused kernel folds at most.  A ray's
    walk is a chain of dependent loads, so with few rays the rows are cut
    into chunks, one thread per (ray, chunk), until the launch has
    :data:`FOLD_BLOCKS` blocks of 16x16 rays (``TILE_X``/``TILE_Y`` in
    csrc/slab_common.cuh); with many rays each thread walks all of its
    ray's rows, since every chunk reloads the stencil's halo.
    ``chip_smoke.py`` times the choices."""
    blocks = -(-height // 16) * -(-width // 16)
    chunk = n
    while chunk > 16 and blocks * -(-n // chunk) < FOLD_BLOCKS:
        chunk = (chunk + 1) // 2
    return chunk


def fold_scatter_cuda(feats: torch.Tensor, dd: torch.Tensor, steps: torch.Tensor, vol_shape, sign: int,
                      params: RenderParams, want_folded: bool = False, chunk: int | None = None,
                      vol: torch.Tensor | None = None):
    """Launch the fused fold-and-scatter kernel (``FOLD``; B3 for ``dd``
    (N, H, W), B4 for ``dd`` (N, 4, H, W)); same arguments and result as
    :func:`slab.smooth_voxel_grad`, whose ``steps`` the kernel reads: the
    replay's (2, H, W) int32 first and last step of each ray with a
    cotangent (``dd`` must be 0.0 outside them); the 32 rays of a warp walk
    the union of their ranges together.  ``chunk``: the plain rows one
    thread folds at most (one thread per ray and chunk; default
    :func:`fold_chunk`).  ``want_folded`` (for the tests) also returns the
    (N, H, W) folded density rows.

    ``vol``, the (N, rows, cols) float32 volume as marched (camera
    gradients with trilinear sampling; not with ``want_folded``): the
    kernel's ``CHAIN`` variant also adds the plain rows' camera chain, and
    the result is ``(d_vol, d_grad, d_feats)``, as
    :func:`slab.smooth_voxel_grad` with ``want_folded`` followed by
    :func:`slab.feats_grad` on its folded rows.  The folded rows are the
    same with the chain and without it (one thread sums each, in a fixed
    order).  With one chunk (``chunk >= N``) each ray's four sums are
    stored in the plain version's order; with more, each chunk adds its
    partial sums by atomics.

    The outputs are zero-filled here (``torch.zeros``); the summation order
    of the atomics, and so the last bits of ``d_vol``, ``d_grad`` and, with
    several chunks, ``d_feats``, change from run to run."""
    global FOLD_LAUNCHES, FOLD_SHADED_LAUNCHES
    n, nr, nc, height, width, shaded = _check(feats, dd, vol_shape, "fold_scatter_cuda")
    dev = feats.device
    if steps.device != dev or steps.dtype != torch.int32 or tuple(steps.shape) != (2, height, width):
        raise ValueError(f"steps must be int32 (2, {height}, {width}) on {dev}, got {steps.dtype} "
                         f"{tuple(steps.shape)} on {steps.device}")
    if not steps.is_contiguous():
        raise ValueError("steps must be contiguous")
    chain = vol is not None
    if chain:
        if want_folded:
            raise ValueError("the camera chain makes no folded rows: want_folded is for the fold alone")
        if params.interpolation != Interpolation.TRILINEAR:
            raise ValueError("the plain rows' camera chain needs trilinear sampling: box hats have no derivative")
        if vol.device != dev or vol.dtype != torch.float32 or tuple(vol.shape) != (n, nr, nc):
            raise ValueError(f"vol must be float32 {(n, nr, nc)} on {dev}, got {vol.dtype} {tuple(vol.shape)} "
                             f"on {vol.device}")
        if not vol.is_contiguous():
            raise ValueError("vol must be contiguous")
    slab_mod.check_smooth_planes(n)
    chunk = fold_chunk(n, height, width) if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    d_vol = torch.zeros((n, nr, nc), dtype=torch.float32, device=dev)
    d_grad = torch.zeros((3, n, nr, nc), dtype=torch.float32, device=dev) if shaded else None
    folded = torch.zeros((n, height, width), dtype=torch.float32, device=dev) if want_folded else None
    d_feats = torch.zeros_like(feats) if chain else None
    fn = _library().voxel_grad_fold_launch
    with torch.cuda.device(dev):
        rc = fn(
            feats.data_ptr(), dd.data_ptr(), steps.data_ptr(), d_vol.data_ptr(),
            d_grad.data_ptr() if shaded else None, folded.data_ptr() if want_folded else None,
            height, width, n, nr, nc, int(sign), int(params.subtexel_bits),
            int(params.interpolation == Interpolation.TRILINEAR), int(shaded), int(chunk),
            torch.cuda.current_stream(dev).cuda_stream,
            vol.data_ptr() if chain else None, d_feats.data_ptr() if chain else None,
        )
    if rc != 0:
        raise RuntimeError(f"voxel_grad fold kernel launch failed with CUDA error {rc}")
    if shaded:
        FOLD_SHADED_LAUNCHES += 1
    else:
        FOLD_LAUNCHES += 1
    if not chain:
        return d_vol, d_grad, folded
    feats_grad.LAUNCHES += 1
    return d_vol, d_grad, d_feats


def smooth_scatter(feats, dd, steps, vol_shape, sign, params, want_folded=False):
    """The smoothed backward's fold and scatter on the tensors' device: the
    plain version for CPU tensors, the fused CUDA kernel for CUDA tensors
    (no fallback between them)."""
    if feats.device.type == "cpu":
        return slab_mod.smooth_voxel_grad(feats, dd, steps, vol_shape, sign, params, want_folded)
    return fold_scatter_cuda(feats, dd, steps, vol_shape, sign, params, want_folded)

