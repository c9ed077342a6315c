"""The replay backward of the slab march on the GPU: the CUDA kernel's
wrapper, the device dispatch and the stored-density gate.

Counterpart of :mod:`volym_tpu.ops.slab_bwd_kernel` on the path the
training step runs: the replay ``_replay_kernel`` with its fused voxel
scatter, from the stored density or re-sampled, base and shading modes,
and with its camera chain (d_feats) on the re-sampled f32 stream.  The
TPU backward splits the replay from the
scatter (passes 1 and 2) when its VMEM cannot hold the fused layout and
under Gaussian smoothing; one thread per ray scatters with atomics and
needs no second pass for VMEM's sake, but under smoothing a step's
cotangent belongs to the smoothed density, so the kernel writes the
per-step cotangents (the TPU's unfused ``dd`` output), inside each ray's
step range only, and the range for the fused fold-and-scatter of
:mod:`volym_tpu_torch.ops.voxel_grad`.

:func:`replay` dispatches on the device of its tensors: CPU tensors go to
the plain version :func:`volym_tpu_torch.render.slab.replay_slabs`; CUDA
tensors launch the kernel (``csrc/slab_replay.cu``) or raise.
"""

from __future__ import annotations

import ctypes

import torch

from volym_tpu_torch.config import Interpolation, RenderParams
from volym_tpu_torch.render import slab as slab_mod
from volym_tpu_torch.render.slab import N_FEATURES

#: launches of the CUDA replay kernel in this process (see :func:`replay_cuda`)
LAUNCHES = 0

#: device-memory budget of the stored-density residual (MiB): above it the
#: replay re-samples the volume instead (``slab_kernel.py:1680``)
STORE_DENSITY_BUDGET_MB = 1536

#: the largest LUT the kernel stages in shared memory, with its gradient
#: beside it (48 KB: the dynamic shared memory a block gets without opting
#: in to more)
MAX_LUT_ENTRIES = 48 * 1024 // 32


def use_stored_density(params: RenderParams, n: int, rays: int) -> bool:
    """Whether the forward stores the density residual for the replay
    (``slab_kernel._use_stored_density``): never under camera cotangents,
    and only while the residual, ``width x n x rays x 4`` bytes (width 4
    when shaded: density and the three gradient-field samples), is within
    :data:`STORE_DENSITY_BUDGET_MB`."""
    if params.camera_grads:
        return False
    width = 4 if params.use_shading else 1
    return width * int(n) * int(rays) * 4 <= STORE_DENSITY_BUDGET_MB * 1024 * 1024


#: allocates ``dd`` under Gaussian smoothing, called as ``torch.empty``:
#: the kernel writes every entry inside each ray's step range and leaves the
#: rest as it finds it (a test swaps in a NaN fill to show nothing reads it)
ALLOC_DD = torch.empty


def _bind(lib: ctypes.CDLL):
    """The C entry ``slab_replay_launch`` of a loaded build, typed."""
    fn = lib.slab_replay_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        f = ctypes.c_float
        fn.argtypes = [p] * 13 + [i] * 14 + [f, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def _library():
    from volym_tpu_torch.ops import _build

    return _bind(_build.library("slab_replay"))


def replay_cuda(
    feats: torch.Tensor,
    vol_perm: torch.Tensor,
    lut: torch.Tensor,
    sign: int,
    params: RenderParams,
    out: torch.Tensor,
    g_img: torch.Tensor,
    grad_perm: torch.Tensor | None = None,
    u8: bool = False,
    dens: torch.Tensor | None = None,
):
    """Launch the CUDA replay kernel; same arguments and result as
    :func:`slab.replay_slabs` (``(dd, steps, d_lut)`` under Gaussian
    smoothing, ``steps`` written by the kernel for every ray; with
    ``params.camera_grads`` a last ``d_feats``, zero-filled here, which the
    kernel's camera mode accumulates one ray a thread, without atomics),
    with one difference: ``dd`` is allocated by :data:`ALLOC_DD`
    (``torch.empty``) and the kernel writes it only inside each ray's step
    range ``[steps[0], steps[1]]``, every channel of every step there (0.0
    where a step carries no cotangent), so outside the range it is
    unspecified where the plain version's is 0.0.  The fused
    fold-and-scatter reads only inside the range; a reader of all of ``dd``
    takes :func:`slab.dense_dd` first.  The summation order of the
    atomics, and so the last bits of ``d_vol``, ``d_grad`` and ``d_lut``,
    change from run to run."""
    global LAUNCHES
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"replay_cuda needs CUDA tensors, got {dev}")
    shading = params.use_shading
    stored = dens is not None
    camera = params.camera_grads
    if camera and (stored or u8):
        raise ValueError("camera cotangents need the re-sampled replay of the f32 volume (no residual, no u8)")
    tensors = [("feats", feats), ("vol_perm", vol_perm), ("lut", lut), ("out", out), ("g_img", g_img)]
    if stored:
        tensors.append(("dens", dens))
    elif shading:
        if grad_perm is None:
            raise ValueError("shading needs the permuted gradient field or the stored residual")
        tensors.append(("grad_perm", grad_perm))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_f, height, width = feats.shape
    n, nr, nc = vol_perm.shape
    ln = lut.shape[0]
    if n_f != N_FEATURES or feats.dtype != torch.float32:
        raise ValueError(f"feats must be float32 ({N_FEATURES}, H, W), got {feats.dtype} {tuple(feats.shape)}")
    if vol_perm.dtype != (torch.uint8 if u8 else torch.float32):
        raise ValueError(f"vol_perm dtype {vol_perm.dtype} does not match u8={u8}")
    if lut.dtype != torch.float32 or lut.shape != (ln, 4) or not 1 <= ln <= MAX_LUT_ENTRIES:
        raise ValueError(f"lut must be float32 (N<={MAX_LUT_ENTRIES}, 4), got {lut.dtype} {tuple(lut.shape)}")
    for name, t in (("out", out), ("g_img", g_img)):
        if t.dtype != torch.float32 or t.shape != (height, width, 4):
            raise ValueError(f"{name} must be float32 ({height}, {width}, 4), got {t.dtype} {tuple(t.shape)}")
    if stored:
        want = (n, 4, height, width) if shading else (n, height, width)
        if dens.dtype != torch.float32 or dens.shape != want:
            raise ValueError(f"dens must be float32 {want}, got {dens.dtype} {tuple(dens.shape)}")
    elif shading and (grad_perm.dtype != torch.float32 or grad_perm.shape != (3, n, nr, nc)):
        raise ValueError(f"grad_perm must be float32 (3, {n}, {nr}, {nc})")
    smooth = params.use_gaussian_smoothing
    if smooth:
        slab_mod.check_smooth_planes(n)
    threshold, early_alpha, dscale = slab_mod.march_knobs(params, u8)
    tf_scale = float(ln) * (dscale if dscale else 1.0)
    d_vol = d_grad = dd = steps = None
    if smooth:
        dd = ALLOC_DD((n, 4, height, width) if shading else (n, height, width), dtype=torch.float32, device=dev)
        steps = torch.empty((2, height, width), dtype=torch.int32, device=dev)
    else:
        d_vol = torch.zeros((n, nr, nc), dtype=torch.float32, device=dev)
        d_grad = torch.zeros((3, n, nr, nc), dtype=torch.float32, device=dev) if shading else None
    d_lut = torch.zeros((ln, 4), dtype=torch.float32, device=dev)
    d_feats = torch.zeros_like(feats) if camera else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _library()
    with torch.cuda.device(dev):
        rc = fn(
            feats.data_ptr(), vol_perm.data_ptr(), ptr(grad_perm) if (shading and not stored) else None,
            lut.data_ptr(), ptr(dens), out.data_ptr(), g_img.data_ptr(),
            ptr(d_vol), ptr(d_grad), d_lut.data_ptr(), ptr(dd), ptr(steps), ptr(d_feats),
            height, width, n, nr, nc, ln, int(sign), int(params.subtexel_bits),
            int(params.interpolation == Interpolation.TRILINEAR), int(u8), int(shading), int(stored), int(smooth),
            int(camera), threshold, early_alpha, tf_scale,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"slab_replay kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    res = (dd, steps, d_lut) if smooth else (d_vol, d_grad, d_lut)
    return (*res, d_feats) if camera else res


def replay(feats, vol_perm, lut, sign, params, out, g_img, grad_perm=None, u8=False, dens=None):
    """The replay backward on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (no fallback between them)."""
    if feats.device.type == "cpu":
        return slab_mod.replay_slabs(feats, vol_perm, lut, sign, params, out, g_img, grad_perm, u8, dens)
    return replay_cuda(feats, vol_perm, lut, sign, params, out, g_img, grad_perm, u8, dens)
