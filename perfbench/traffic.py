"""The one traffic generator: a mix's parameters and a seed -> the camera
of each frame or step.

Every seed gets the same set of views in another order, so that two seeds
ask for the same work and differ in their order only:

- ``orbit`` (one interactive viewer): frame i's azimuth is the start plus
  ``degrees_per_frame`` * (i + 1), as ``run`` turns its camera before each
  frame; the elevation sweeps ``elevation_range`` as a triangle wave of
  ``elevation_degrees_per_frame``.  The seed draws the start azimuth and the
  wave's phase.
- ``views`` (one fitting job): ``views`` cameras whose azimuths are evenly
  spaced around the orbit from an offset and whose elevations are evenly
  spaced over ``elevation_range``, paired and ordered by the seed; step i
  takes view i mod ``views``.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def triangle(x: float, lo: float, hi: float) -> float:
    """The triangle wave of period 2 (hi - lo) through [lo, hi] at ``x``."""
    span = hi - lo
    if span <= 0.0:
        return lo
    u = x % (2.0 * span)
    return lo + (u if u <= span else 2.0 * span - u)


class Views:
    """``angles(i)`` -> (azimuth, elevation) in degrees of frame or step i."""

    def __init__(self, traffic: dict, seed: int):
        self.kind = traffic["cameras"]
        lo, hi = (float(v) for v in traffic["elevation_range"])
        self.lo, self.hi = lo, hi
        rng = _rng(seed, 1)
        if self.kind == "orbit":
            self.step = float(traffic["degrees_per_frame"])
            self.el_step = float(traffic["elevation_degrees_per_frame"])
            self.az0 = float(rng.uniform(0.0, 360.0))
            self.phase = float(rng.uniform(0.0, 2.0 * (hi - lo)))
        elif self.kind == "views":
            n = int(traffic["views"])
            offset = float(rng.uniform(0.0, 360.0 / n))
            az = offset + 360.0 * np.arange(n) / n
            el = np.linspace(lo, hi, n)
            self.table = list(zip(az[rng.permutation(n)].tolist(), el[rng.permutation(n)].tolist()))
        else:
            raise ValueError(f"unknown camera kind {self.kind!r}")

    def angles(self, i: int) -> tuple[float, float]:
        if self.kind == "orbit":
            return (self.az0 + self.step * (i + 1)) % 360.0, triangle(self.phase + self.el_step * i, self.lo, self.hi)
        return self.table[i % len(self.table)]

    def __len__(self) -> int:
        return len(self.table) if self.kind == "views" else 0


def sample_indices(seed: int, count: int, below: int) -> list[int]:
    """``count`` distinct indices in [0, below), drawn from the seed."""
    return sorted(_rng(seed, 2).choice(below, size=min(count, below), replace=False).tolist())
