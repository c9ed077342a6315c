"""The importance look-ahead gate on the GPU: the wrapper of the CUDA gate
kernels and the packed gate format.

Counterpart of :mod:`volym_tpu.ops.lookahead_kernel`.  The TPU kernels
``_straight_kernel`` and ``_cone_kernel`` sweep the importance grid in
reverse over (ray chunk, slab block) pairs, sampling it with box-hat
matrix products, and emit one float32 per (march step, ray).  The CUDA
kernels (``csrc/lookahead.cu``) run one thread per ray over the march
steps in reverse, after a pass that bounds each slice's important texels
(so that most samples take no tap; the straight kernel also skips the
range test of a ray that has passed no important texel), read a uint8
level grid (:func:`volym_tpu_torch.render.slab.importance_levels`) with
direct loads, and emit one bit per (march step, ray), 32 steps to a word.  What they keep
is the semantics of :func:`volym_tpu_torch.render.slab.lookahead_gate`,
their plain version.

:func:`gate` dispatches on the device of its tensors: CPU tensors go to the
plain version, which returns the (N, H, W) bool gate; CUDA tensors launch
a kernel, which returns the packed gate that the CUDA march reads.
"""

from __future__ import annotations

import ctypes

import torch

from volym_tpu_torch.render import slab as slab_mod
from volym_tpu_torch.render.slab import CONE_FEATURES, N_FEATURES
from volym_tpu_torch.tracing import span

#: launches of the straight (B6) and the cone (B7) gate kernels in this
#: process (see :func:`gate_cuda`)
STRAIGHT_LAUNCHES = 0
CONE_LAUNCHES = 0


def gate_words(n: int) -> int:
    """32-bit words a ray's packed gate takes for ``n`` march steps."""
    return (n + 31) // 32


def unpack_gate(words: torch.Tensor, n: int) -> torch.Tensor:
    """The packed gate (ceil(N/32), H, W) int32 -> the (N, H, W) bool gate:
    march step j is bit j % 32 of word j // 32."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> shifts[None, :, None, None]) & 1
    return bits.reshape(-1, *words.shape[1:])[:n].bool()


def _bind(lib: ctypes.CDLL):
    """The gate's C entry of a loaded kernel library, its types set."""
    fn = lib.lookahead_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 7 + [p, p]
        fn.restype = ctypes.c_int
    return fn


def _library():
    from volym_tpu_torch.ops import _build

    return _bind(_build.library("lookahead"))


def cone_occupancy() -> tuple[int, int]:
    """(resident blocks per SM, threads a block) of the cone gate kernel on
    the current device, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    from volym_tpu_torch.ops import _build

    fn = _build.library("lookahead").lookahead_cone_occupancy
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    threads = ctypes.c_int(0)
    blocks = fn(ctypes.byref(threads))
    if blocks < 0:
        raise RuntimeError("cudaOccupancyMaxActiveBlocksPerMultiprocessor failed for the cone gate kernel")
    return blocks, threads.value


def gate_cuda(
    feats: torch.Tensor, cone_feats: torch.Tensor | None, levels: torch.Tensor, sign: int, subtexel: int
) -> torch.Tensor:
    """Launch the straight gate kernel (``cone_feats`` None) or the cone
    one -> the packed gate (ceil(N/32), H, W) int32 (:func:`unpack_gate`).
    Same arguments as :func:`slab.lookahead_gate`."""
    global STRAIGHT_LAUNCHES, CONE_LAUNCHES
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"gate_cuda needs CUDA tensors, got {dev}")
    tensors = [("feats", feats), ("levels", levels)]
    if cone_feats is not None:
        tensors.append(("cone_feats", cone_feats))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_f, height, width = feats.shape
    if n_f != N_FEATURES or feats.dtype != torch.float32:
        raise ValueError(f"feats must be float32 ({N_FEATURES}, H, W), got {feats.dtype} {tuple(feats.shape)}")
    if levels.dtype != torch.uint8 or levels.dim() != 3:
        raise ValueError(f"levels must be uint8 (N, rows, cols), got {levels.dtype} {tuple(levels.shape)}")
    if cone_feats is not None and (
        cone_feats.dtype != torch.float32 or cone_feats.shape != (CONE_FEATURES, height, width)
    ):
        raise ValueError(f"cone_feats must be float32 ({CONE_FEATURES}, {height}, {width})")
    n, nr, nc = levels.shape
    out = torch.empty((gate_words(n), height, width), dtype=torch.int32, device=dev)
    # the first pass: each slice's important rows and columns
    bounds = torch.empty((n, 4), dtype=torch.int32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        rc = fn(
            feats.data_ptr(), cone_feats.data_ptr() if cone_feats is not None else None,
            levels.data_ptr(), out.data_ptr(), height, width, n, nr, nc, int(sign), int(subtexel),
            torch.cuda.current_stream(dev).cuda_stream, bounds.data_ptr(),
        )
    if rc != 0:
        raise RuntimeError(f"lookahead kernel launch failed with CUDA error {rc}")
    if cone_feats is None:
        STRAIGHT_LAUNCHES += 1
    else:
        CONE_LAUNCHES += 1
    return out


def gate(feats, cone_feats, levels, sign, subtexel):
    """The look-ahead gate on the tensors' device: the plain version's
    (N, H, W) bool gate for CPU tensors, the CUDA kernel's packed gate for
    CUDA tensors (no fallback between them)."""
    with span("volym.gate"):
        if feats.device.type == "cpu":
            return slab_mod.lookahead_gate(feats, cone_feats, levels, sign, subtexel)
        return gate_cuda(feats, cone_feats, levels, sign, subtexel)
