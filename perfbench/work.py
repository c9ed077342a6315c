"""The yardstick's peaks and the work each layer's kernels must do.

A roofline share is the least time the card could take over the time the
kernels took: the larger of the bytes over the memory rate and the float32
operations over the float32 rate.  The work is counted from the cell's
inputs and the algorithm, never from the program's intermediate tensors:

- bytes: each essential input byte read once and each output byte written
  once, from the configuration's sizes;
- operations: the steps the plain reference counts on these inputs (live:
  in the ray's window, before early termination, not gated; composited:
  live and at or over the threshold) times the per-step operation counts
  below, which count the arithmetic the algorithm needs and no more (a
  transcendental or a compare counts as one operation).

So a redesign of a kernel that does the same work reads against the same
bound, and a share above 100% means the count or the time is wrong.
"""

from __future__ import annotations

#: published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: NVLink 4 of one H100 SXM, one direction: 18 links at 25 GB/s
NVLINK_BYTES_PER_S = 450e9

#: per live step of the march: the step's coordinates (2 x 2 affine, 2
#: clamps, 2 x 3 snap) and t (2), the window and termination tests (3)
MARCH_LIVE_OPS = 17
#: per live step under smoothing: 5 taps, each its position in the box (3
#: adds, 6 compares), its value from the two nearest plain rows (3) and its
#: weighted sum (3); the normalisation (1)
SMOOTH_LIVE_OPS = 5 * 15 + 1
#: per composited step: the threshold test (1), the TF lookup (coordinate
#: 2, clamp 2, floor 1, fraction 1, four lerps 12), the opacity correction
#: (5) and the compositing (9)
MARCH_COMPOSITED_OPS = 1 + 18 + 5 + 9
#: per composited step when shaded: normalise the gradient (9), the
#: diffuse and half-vector dots (10), the specular power and clamps (3),
#: the shade (8)
SHADE_COMPOSITED_OPS = 30
#: per composited step of the replay: rebuild the transmittance and the
#: suffix (13), d_beta (13), d alpha through the correction (5), d_rgb (3),
#: the TF slope and its scatter into d_lut (8 + 16)
REPLAY_COMPOSITED_OPS = 13 + 13 + 5 + 3 + 24
#: per composited step of the replay when shaded: the shading's backward
REPLAY_SHADE_OPS = 40
#: per composited step of the fold under smoothing: the transpose of the 5
#: taps onto the plain rows (5 x (9 + 4)) and the scatter of the step's
#: density and gradient-field cotangents (4)
FOLD_COMPOSITED_OPS = 5 * 13 + 4
#: per valid step of the look-ahead: |pos| (7) and the probe range (2)
GATE_VALID_OPS = 9
#: per probe of a direction (8 in the cone, 1 straight) at a valid step whose
#: slice holds important material: its coordinates (6), the in-box test (5),
#: the range test (3)
GATE_PROBE_OPS = 14
CONE_DIRECTIONS = 8

F32 = 4


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time (s) the card could take and which rate bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _image_bytes(cfg: dict) -> int:
    return int(cfg["height"]) * int(cfg["width"]) * 4 * F32


def _grid_bytes(cfg: dict, planes: int, elem: int = F32) -> int:
    side = int(cfg["volume"]["side"])
    return planes * side * side * elem


def march(cfg: dict, planes: int, counts: dict) -> tuple[float, float]:
    """(bytes, operations) of one frame's march: the marched grid read once
    and the image written once; the live and composited steps' arithmetic."""
    p = cfg["params"]
    live = MARCH_LIVE_OPS + (SMOOTH_LIVE_OPS if p.get("use_gaussian_smoothing", True) else 0)
    comp = MARCH_COMPOSITED_OPS + (SHADE_COMPOSITED_OPS if p.get("use_shading", True) else 0)
    ops = counts["live_steps"] * live + counts["composited_steps"] * comp
    return _grid_bytes(cfg, planes) + _image_bytes(cfg), ops


def replay(cfg: dict, planes: int, counts: dict) -> tuple[float, float]:
    """(bytes, operations) of one step's replay: the image and its
    cotangent read, the LUT's cotangent written; the composited steps'
    backward arithmetic."""
    shaded = cfg["params"].get("use_shading", True)
    ops = counts["composited_steps"] * (REPLAY_COMPOSITED_OPS + (REPLAY_SHADE_OPS if shaded else 0))
    return 2 * _image_bytes(cfg) + 256 * 4 * F32, ops


def fold(cfg: dict, planes: int, counts: dict) -> tuple[float, float]:
    """(bytes, operations) of one step's fold and scatter: the density's
    cotangent on the marched grid written once; the composited steps'
    transpose and scatter."""
    return _grid_bytes(cfg, planes), counts["composited_steps"] * FOLD_COMPOSITED_OPS


def gate(cfg: dict, planes: int, counts: dict) -> tuple[float, float]:
    """(bytes, operations) of one frame's look-ahead gate: the importance
    levels read once (a byte a voxel) and a bit a march step and ray
    written; the valid steps' range and the probes at steps whose slice
    holds important material."""
    rays = int(cfg["height"]) * int(cfg["width"])
    n_bytes = _grid_bytes(cfg, planes, elem=1) + planes * rays / 8
    directions = CONE_DIRECTIONS if cfg["params"].get("use_cone_importance_check") else 1
    ops = counts["valid_steps"] * GATE_VALID_OPS + counts["probed_steps"] * directions * GATE_PROBE_OPS
    return n_bytes, ops


def allreduce_bytes(cfg: dict, lut_entries: int = 256) -> int:
    """The bytes a fitting step must sum across its ranks: the cotangents of
    its leaves (the volume's, the LUT's) and the loss; never what else a
    program may send along."""
    side = int(cfg["volume"]["side"])
    return side**3 * F32 + lut_entries * 4 * F32 + F32


def bus_bytes(n_bytes: float, ranks: int) -> float:
    """The bytes an all-reduce of ``n_bytes`` moves through each card's link
    by the bus-bandwidth convention of NCCL's tests: 2 (n - 1) / n of it."""
    return n_bytes * 2.0 * (ranks - 1) / ranks


WORK = {"march": march, "replay": replay, "fold": fold, "gate": gate}
