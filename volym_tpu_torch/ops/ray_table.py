"""The per-ray table and the cone look-ahead table on the GPU: the wrapper of
the CUDA kernels that build each from the camera in one launch.

The JAX package builds both tables with ``jnp`` ops, which XLA fuses; no
TPU kernel is replaced.  Their plain version is the chain of PyTorch ops in
:mod:`volym_tpu_torch.ops.slab_march` (``rays.rays_from_ndc``,
``rays.ray_box_intersection``, then :func:`slab_march.features_from_rays`
or :func:`slab_march.cone_features_from_rays`), some 140 and 150 small
whole-frame launches.  The kernels (``csrc/ray_table.cu``) run one thread a
ray, from the rays' NDC points and the camera's ``inverse_view_proj`` and
``position`` in device memory, and give the chain's values bit for bit.

:func:`route` is the dispatch rule of ``slab_march._features`` and
``_cone_features``: CUDA tensors always take the kernel; where the table
must carry camera gradients, its backward re-runs the chain.
"""

from __future__ import annotations

import ctypes

import torch

from volym_tpu_torch.render import slab as slab_mod
from volym_tpu_torch.render.golden import CONE_OFFSETS, CONE_SAMPLES
from volym_tpu_torch.render.slab import CONE_FEATURES, N_FEATURES

#: launches of the per-ray table's and the cone table's kernels in this
#: process
LAUNCHES = 0
CONE_LAUNCHES = 0

#: the cone kernel's offsets argument: :data:`golden.CONE_OFFSETS`, the
#: right offsets then the up offsets
_CONE_OFFSETS = (ctypes.c_float * (2 * CONE_SAMPLES))(*(o[0] for o in CONE_OFFSETS), *(o[1] for o in CONE_OFFSETS))


def route(device: torch.device, grad_enabled: bool, requires_grad: bool) -> str:
    """How a table on ``device`` is built: ``"chain"`` on the CPU (the
    chain's own graph carries any gradient); on CUDA ``"kernel"``, or
    ``"kernel_vjp"`` where autograd records (``grad_enabled``) a camera
    input that ``requires_grad``: the kernel's table, whose backward re-runs
    the chain for the vector-Jacobian product."""
    if device.type != "cuda":
        return "chain"
    return "kernel_vjp" if grad_enabled and requires_grad else "kernel"


def _bind(lib: ctypes.CDLL):
    """The tables' C entry of a loaded kernel library, its types set."""
    fn = lib.ray_table_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        f = ctypes.c_float
        fn.argtypes = [p] * 4 + [i] * 5 + [f] * 6 + [p, p]
        fn.restype = ctypes.c_int
    return fn


def _library():
    from volym_tpu_torch.ops import _build

    return _bind(_build.library("ray_table"))


def check_inputs(inverse_view_proj: torch.Tensor, position: torch.Tensor, ndc: torch.Tensor) -> None:
    """Raise ValueError unless the kernels can read these: float32 and
    contiguous, of shapes (4, 4), (3,) and (R, 2), on one device."""
    rays = ndc.shape[0] if ndc.dim() == 2 else -1
    for name, t, shape, text in (("inverse_view_proj", inverse_view_proj, (4, 4), "(4, 4)"),
                                 ("position", position, (3,), "(3,)"), ("ndc", ndc, (rays, 2), "(R, 2)")):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {text}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != ndc.device:
            raise ValueError(f"{name} is on {t.device}, ndc on {ndc.device}")


def table_cuda(inverse_view_proj: torch.Tensor, position: torch.Tensor, ndc: torch.Tensor, n_slabs: int, major: int,
               sign: int, n_plane: int | None = None, cone: bool = False) -> torch.Tensor:
    """Launch the per-ray table's kernel -> (N_FEATURES, R) float32, the
    values of ``features_from_rays`` for the rays through ``ndc``; with
    ``cone``, the cone table's -> (CONE_FEATURES, R), the values of
    ``cone_features_from_rays``.  Arguments as ``slab_march._features``'s,
    the camera as its two tensors."""
    global LAUNCHES, CONE_LAUNCHES
    check_inputs(inverse_view_proj, position, ndc)
    dev = ndc.device
    if dev.type != "cuda":
        raise ValueError(f"table_cuda needs CUDA tensors, got {dev}")
    _, row, col = slab_mod._AXIS_LAYOUT[major]
    rays = ndc.shape[0]
    out = torch.empty((CONE_FEATURES if cone else N_FEATURES, rays), dtype=torch.float32, device=dev)
    sz, z0 = slab_mod.slab_origin(n_slabs, sign)
    n_rows = n_slabs if n_plane is None else n_plane
    fn = _library()
    with torch.cuda.device(dev):
        rc = fn(
            ndc.data_ptr(), inverse_view_proj.data_ptr(), position.data_ptr(), out.data_ptr(), rays, int(cone),
            major, row, col, sz, z0, 1.0 / n_slabs, float(n_rows), float(n_slabs), float(sign),
            ctypes.cast(_CONE_OFFSETS, ctypes.c_void_p) if cone else None, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ray_table kernel launch failed with CUDA error {rc}")
    if cone:
        CONE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
