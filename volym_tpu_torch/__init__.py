"""volym_tpu_torch — the PyTorch + CUDA port of volym_tpu for NVIDIA Hopper.

A second package beside :mod:`volym_tpu`, with the same module names.  It
imports torch and numpy, never jax.  Two families of renderers:

- the slab march (``make_renderer`` backends ``slab_cuda``, the default,
  with hand-written CUDA kernels in ``ops/csrc/*.cu``, and ``slab``, their
  plain PyTorch versions): base and Blinn-Phong shading, Gaussian
  smoothing, importance look-ahead (straight or cone), importance coloring
  and first-hit.  It differentiates the render for the volume, the TF LUT,
  the camera and, under coloring, the importance, with and without
  look-ahead; only first-hit refuses (``NotImplementedError``, as in the
  JAX package);
- the t-step march (backend ``ray``: ``render/golden.py``, the early-exit
  ``render/fast.py`` and the replay-backward ``render/diff.py``, with
  ``render/debug_vis.py``'s views), in PyTorch ops on any device, in the
  same modes plus adaptive stepping.

Beside them: ``bench/harness.py`` (the reference's benchmark sweep and
the host's and the profiler's clocks), ``optim.py`` (``fit_scene``: Adam
through the t-step replay backward), ``io`` (PNG and ``.npz``
checkpoints), ``devtools.py`` (NRRD -> segments) and ``cli.py``.
"""

from volym_tpu_torch.camera import Camera, CameraMatrices, camera_matrices
from volym_tpu_torch.config import BENCHMARK_PARAMS, Interpolation, RenderParams
from volym_tpu_torch.scene import Scene
from volym_tpu_torch.transfer_function import ControlPoint, TransferFunction

__all__ = [
    "Camera",
    "CameraMatrices",
    "camera_matrices",
    "RenderParams",
    "BENCHMARK_PARAMS",
    "Interpolation",
    "Scene",
    "TransferFunction",
    "ControlPoint",
]
