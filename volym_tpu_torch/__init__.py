"""volym_tpu_torch — the PyTorch + CUDA port of volym_tpu for NVIDIA Hopper.

A second package beside :mod:`volym_tpu`, with the same module names.  It
imports torch and numpy, never jax.  It renders with the slab march in its
base and Blinn-Phong shading modes, with or without importance look-ahead
(straight or cone), and differentiates the render without look-ahead for
the volume and the TF LUT (no camera gradients yet), with hand-written CUDA
kernels (``ops/csrc/slab_march.cu``, ``ops/csrc/slab_replay.cu``,
``ops/csrc/lookahead.cu``) and their plain PyTorch versions.
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
