"""Render parameter configuration.

PyTorch counterpart of :mod:`volym_tpu.config`: the same frozen dataclass,
field for field, so a parameter set converts one-to-one
(:func:`volym_tpu_torch.convert.render_params`).  PyTorch runs eagerly, so
there is no jit key; :meth:`RenderParams.split_dynamic` still splits the
float knobs off into a float32 tensor, which the ``fast`` t-step march
takes as its ``dyn`` argument, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass

import torch


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
    The t-step renderers of the ``ray`` backend (``render/golden.py``,
    ``fast.py``, ``diff.py``) also read ``adaptive_stepping``, ``max_steps``
    and ``importance_check_ahead_steps``, which have no effect on the slab
    march, as in the JAX package, and ignore ``subtexel_bits``,
    ``camera_grads`` and ``u8_volume``.  ``fast_math`` is carried so a
    parameter set converts field by field.
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

    @property
    def min_step_size(self) -> float:
        """The adaptive march's smallest step, a quarter of the base step
        (``wgsl:244``)."""
        return self.raymarching_step_size * 0.25

    def resolved_max_steps(self) -> int:
        """The t-step march's worst-case iteration count: every iteration
        advances ``t`` by at least the minimum step (adaptive) or the base
        step (fixed), so the unit box's diagonal sqrt(3) bounds it."""
        if self.max_steps is not None:
            return int(self.max_steps)
        step = self.min_step_size if self.adaptive_stepping else self.raymarching_step_size
        return int(math.sqrt(3.0) / step) + 2

    #: the float knobs that travel in the tensor of :meth:`dynamic`
    DYNAMIC_FIELDS = (
        "density_threshold",
        "raymarching_step_size",
        "early_termination_alpha",
        "importance_check_ahead_steps",
    )

    def dynamic(self, device="cpu") -> torch.Tensor:
        """The four float knobs of ``DYNAMIC_FIELDS`` as a float32 tensor."""
        return torch.tensor([float(getattr(self, f)) for f in self.DYNAMIC_FIELDS], dtype=torch.float32,
                            device=device)

    def split_dynamic(self, device="cpu") -> tuple["RenderParams", torch.Tensor]:
        """(the params with the knobs zeroed, :meth:`dynamic`): the t-step
        ``fast.march`` takes the knobs from the tensor, as the JAX
        package's per-frame uniform update does.  ``resolved_max_steps`` of
        the zeroed copy means nothing unless ``max_steps`` is set.  The
        look-ahead then probes a fixed ``AHEAD_CAP`` = 25 taps and masks
        the unused ones, so a larger ``importance_check_ahead_steps`` is
        refused rather than cut short."""
        if self.importance_check_ahead_steps > 25:
            raise ValueError(
                "importance_check_ahead_steps > 25 cannot travel as a knob tensor (AHEAD_CAP); "
                "use the renderers that take the params as they are"
            )
        static = self.replace(
            density_threshold=0.0,
            raymarching_step_size=0.0,
            early_termination_alpha=0.0,
            importance_check_ahead_steps=0,
        )
        return static, self.dynamic(device)

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
