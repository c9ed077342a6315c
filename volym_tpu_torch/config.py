"""Render parameter configuration.

PyTorch counterpart of :mod:`volym_tpu.config`: the same frozen dataclass,
field for field, so a parameter set converts one-to-one
(:func:`volym_tpu_torch.convert.render_params`).  PyTorch runs eagerly, so
there is no jit key to split off and the float knobs stay plain floats.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class Interpolation(str, enum.Enum):
    """Volume sampling filter (the reference's default sampler is nearest)."""

    NEAREST = "nearest"
    TRILINEAR = "trilinear"


@dataclass(frozen=True)
class RenderParams:
    """All tunable render parameters; defaults match ``volym_tpu.config``.

    The slab march reads ``density_threshold``, ``raymarching_step_size``
    (mapped to a plane count), ``interpolation``, ``early_termination_alpha``,
    ``use_shading``, ``use_gaussian_smoothing``, ``subtexel_bits`` and
    ``u8_volume``, the look-ahead reads ``use_importance_rendering`` and
    ``use_cone_importance_check``, importance coloring
    ``use_importance_coloring`` and first-hit ``use_opacity``; the
    differentiable render reads ``camera_grads`` and refuses first-hit.
    The other fields (``fast_math`` and the t-step renderers'
    ``adaptive_stepping`` and ``max_steps``) are carried so a parameter set
    converts field by field, and ``importance_check_ahead_steps`` has no
    effect on the slab march, as in the JAX package.
    """

    density_threshold: float = 0.12
    use_cone_importance_check: bool = False
    use_importance_coloring: bool = False
    use_opacity: bool = True
    use_importance_rendering: bool = False
    use_gaussian_smoothing: bool = True
    importance_check_ahead_steps: int = 12
    raymarching_step_size: float = 0.010
    interpolation: Interpolation = Interpolation.NEAREST
    adaptive_stepping: bool = True
    early_termination_alpha: float = 0.95
    max_steps: int | None = None
    use_shading: bool = True
    fast_math: bool = False
    #: fractional bits of the snapped volume sample coordinates (see
    #: :func:`volym_tpu_torch.render.slab.snap`)
    subtexel_bits: int = 8
    camera_grads: bool = True
    #: march a u8-origin volume in the scaled 0..255 density domain
    #: (threshold x255, TF coordinate scale ln/255) from its uint8 copy
    u8_volume: bool = False

    def __post_init__(self):
        if not isinstance(self.interpolation, Interpolation):
            object.__setattr__(self, "interpolation", Interpolation(self.interpolation))
        if not 0 <= int(self.subtexel_bits) <= 8:
            raise ValueError(
                f"subtexel_bits must be in [0, 8], got {self.subtexel_bits}"
            )

    def replace(self, **kw) -> "RenderParams":
        return dataclasses.replace(self, **kw)

    def knobs(self) -> tuple[float, float]:
        """(density_threshold, early_termination_alpha) as floats."""
        return float(self.density_threshold), float(self.early_termination_alpha)


#: Benchmark parameter preset (reference ``src/main.rs:180-190``).
BENCHMARK_PARAMS = RenderParams(
    density_threshold=0.15,
    use_opacity=True,
    use_cone_importance_check=False,
    use_importance_coloring=False,
    use_importance_rendering=False,
    use_gaussian_smoothing=False,
    importance_check_ahead_steps=15,
    raymarching_step_size=0.020,
)
