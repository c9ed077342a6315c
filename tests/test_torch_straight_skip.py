"""The straight gate kernel (B6, ``lookahead_kernel<false>`` in
``volym_tpu_torch/ops/csrc/lookahead.cu``) against the plain gate and the
TPU's, on the CPU.

The kernel runs one thread a ray, after a first pass that bounds, for each
slice, the rows and columns its important texels span.  It sweeps the
steps in reverse.  At a valid step it runs the range test ``ns <= j +
(exit - norm_pos) / ts`` only where ``ns`` is finite or where the per-ray
proof that no step with ``ns == FAR`` sets its bit fails (``ts > 0`` and
``(n - 1) + max(exit, 0) / ts < FAR``); then it takes the ray's own tap
only where the slice has important texels and the clamped coordinate lies
within a texel of their span, in integers (``snapped_tap``); the tap clears
the bit where opaque and sets ``ns`` where important.  The card is not
here, so the torch transcription of that kernel that ``chip_smoke.py``
counts B6's work with (``straight_gate``) is held bit for bit to
``slab.lookahead_gate`` and to
``volym_tpu.ops.lookahead_kernel.lookahead_call`` under the repo's Pallas
emulator (``tests/pallas_emu.py``), at every (major axis, sign) view, on
native and resampled planes, on the scene with importance at all three
levels, the 16^3 teapot stand-in, importance only on the grid's faces (so
that clamped coordinates tap row or column 0 and n - 1), no importance and
importance everywhere, and against the plain gate on a table with a tiny
``ts`` where the proof fails.  No (step, ray) is exempt, no skipped range
test would have been true, and no skipped tap would have read level >= 1.
"""

import re
from pathlib import Path

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the TPU gate's emulation needs)
import numpy as np
import pytest
import torch

import chip_smoke
import volym_tpu as vj
from tests.test_torch_lookahead import ORBITS, STEPS, H, W, params, port_gate, teapot_scene, three_level_scene, tpu_gate
from volym_tpu.render import slab as jslab
from volym_tpu_torch import parity
from volym_tpu_torch.render.slab import F_CB, F_CS, F_ENTRY, F_EXIT, F_RB, F_RS, F_SIGNOK, F_TB, F_TS, FAR, N_FEATURES
from volym_tpu_torch.render import slab

CSRC = Path(__file__).resolve().parents[1] / "volym_tpu_torch" / "ops" / "csrc"


def _check(arrays, h, v, step, label):
    """The transcription vs the plain gate and the emulated TPU gate at one
    view -> (plain gate, the transcription's counts, its inputs)."""
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    plain, (feats, _, levels, sign) = port_gate(arrays, mj, params(False, step))
    got, counts = chip_smoke.straight_gate(feats, levels, sign, 8)
    label = f"{label} view {jslab.dominant_axis(mj)} step {step}"
    parity.check_gate(plain, got, f"{label} vs plain")
    parity.check_gate(tpu_gate(arrays, mj, params(False, step)), got, f"{label} vs TPU")
    return plain, counts, (feats, levels, sign)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("h,v", ORBITS)
def test_straight_skip_matches_plain_and_tpu_gate(h, v, step):
    plain, counts, _ = _check(three_level_scene(), h, v, step, "three-level")
    assert plain.any(), "the gate never engages"
    # both skips engage and both leave work
    assert 0 < counts["range_tests"] < counts["valid"]
    assert 0 < counts["taps"] < counts["valid"]


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("h,v", [(30.0, 20.0), (210.0, 20.0)])
def test_teapot_straight_skip_matches_plain_and_tpu_gate(h, v, step):
    plain, counts, _ = _check(teapot_scene(), h, v, step, "teapot")
    assert plain.any(), "the gate never engages"
    assert counts["taps"] < counts["valid"] and counts["visited"] < counts["valid"]


def _faces_scene():
    """The three-level scene's volume with importance only on the grid's
    faces: the important texels of a slice lie on its rows and columns 0
    and n - 1 (and the end slices are whole)."""
    vol, _, lut = three_level_scene()
    imp = np.zeros_like(vol)
    for axis in range(3):
        face = [slice(None)] * 3
        face[axis] = [0, -1]
        imp[tuple(face)] = 0.6
    return vol, imp, lut


def _clamped_outside(feats, levels, sign, margin):
    """The valid steps whose raw coordinate lies more than ``margin`` texels
    outside the slice and whose clamped tap reads an important texel."""
    f = feats.reshape(N_FEATURES, -1)
    n, nr, nc = levels.shape
    count = 0
    for j in range(n):
        k = j if sign > 0 else n - 1 - j
        t = f[F_TS] * float(j) + f[F_TB]
        valid = (f[F_SIGNOK] > 0.5) & (t >= f[F_ENTRY]) & (t < f[F_EXIT])
        rows_u, cols_u = f[F_RS] * float(j) + f[F_RB], f[F_CS] * float(j) + f[F_CB]
        outside = (rows_u < -margin) | (rows_u > nr - 1.0 + margin) | (cols_u < -margin) | (cols_u > nc - 1.0 + margin)
        r = chip_smoke.snapped_tap(torch.clamp(rows_u, 0.0, nr - 1.0), 8)
        c = chip_smoke.snapped_tap(torch.clamp(cols_u, 0.0, nc - 1.0), 8)
        count += int((valid & outside & (levels.reshape(n, -1)[k][r * nc + c] >= 1)).sum())
    return count


@pytest.mark.parametrize("h,v", ORBITS)
def test_straight_skip_on_the_grid_faces(h, v):
    """Importance on the grid's faces: rays at the box's edges, their
    coordinate clamped to row or column 0 or n - 1, tap it there."""
    plain, _, (feats, levels, sign) = _check(_faces_scene(), h, v, STEPS[0], "faces")
    assert plain.any(), "the gate never engages"
    assert _clamped_outside(feats, levels, sign, 0.0) > 0


@pytest.mark.parametrize("edge", ["row 0", "row n-1", "col 0", "col n-1"])
@pytest.mark.parametrize("h,v", [(30.0, 20.0), (300.0, -10.0)])
def test_straight_skip_taps_clamped_edge_texels(h, v, edge):
    """Important texels only on one edge row or column of every slice, and
    half the rays (by the parity of their ``tb`` bits) shifted 4 texels
    past that edge: their coordinate, clamped to the edge, lies within the
    slice's important span although the raw one lies 3 or more texels
    outside it.  The kernel tests the clamped coordinate."""
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    _, (feats, _, levels, sign) = port_gate(three_level_scene(), mj, params(False, STEPS[0]))
    axis, end = edge.split()
    levels = torch.zeros_like(levels)
    index = 0 if end == "0" else -1
    if axis == "row":
        levels[:, index, :] = 1
    else:
        levels[:, :, index] = 1
    levels[::3] = levels[::3] * 2  # opaque in every third slice
    feats = feats.clone()
    odd = (feats[F_TB].view(torch.int32) & 1).bool()
    row = F_RB if axis == "row" else F_CB
    feats[row] = torch.where(odd, feats[row] + (-4.0 if end == "0" else 4.0), feats[row])
    want = slab.lookahead_gate(feats, None, levels, sign, 8)
    got, counts = chip_smoke.straight_gate(feats, levels, sign, 8)
    assert want.any(), "the gate never engages"
    parity.check_gate(want, got, f"{edge} view {jslab.dominant_axis(mj)}")
    assert _clamped_outside(feats, levels, sign, 2.0) > 0
    assert counts["taps"] < counts["valid"]


def test_straight_skip_empty_importance_takes_no_tap():
    vol, imp, lut = three_level_scene()
    plain, counts, _ = _check((vol, np.zeros_like(imp), lut), 30.0, 20.0, STEPS[0], "empty")
    assert not plain.any()
    assert counts["valid"] > 0 and counts["taps"] == counts["range_tests"] == counts["visited"] == 0


@pytest.mark.parametrize("step", STEPS)
def test_straight_skip_full_importance_skips_no_tap(step):
    vol, imp, lut = three_level_scene()
    levels = np.random.default_rng(9).choice(np.float32([153.0, 255.0]), imp.shape, p=[0.85, 0.15])
    plain, counts, _ = _check((vol, levels / np.float32(255.0), lut), 210.0, 20.0, step, "everywhere")
    assert plain.any(), "the gate never engages"
    assert counts["taps"] == counts["valid"] > 0


@pytest.mark.parametrize("h,v", [(30.0, 20.0), (300.0, -10.0)])
def test_straight_skip_runs_the_range_test_where_the_proof_fails(h, v):
    """A tiny ``ts`` on half the rays (chosen by the parity of their ``tb``
    bits), each ray's t held near the middle of its window so that every
    step is valid: there (n - 1) + exit / ts passes FAR, so ``FAR <= m_end``
    holds and sets bits while ``ns`` is FAR; the kernel runs the test."""
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    _, (feats, _, levels, sign) = port_gate(three_level_scene(), mj, params(False, STEPS[0]))
    feats = feats.clone()
    odd = (feats[F_TB].view(torch.int32) & 1).bool()
    feats[F_TS] = torch.where(odd, feats[F_TS] * 1e-9, feats[F_TS])
    feats[F_TB] = torch.where(odd, (feats[F_ENTRY] + feats[F_EXIT]) * 0.5, feats[F_TB])
    want = slab.lookahead_gate(feats, None, levels, sign, 8)
    got, counts = chip_smoke.straight_gate(feats, levels, sign, 8)
    parity.check_gate(want, got, f"tiny ts view {jslab.dominant_axis(mj)}")
    assert counts["set_while_far"] > 0


@pytest.mark.parametrize("bits", [0, 4])
def test_straight_skip_other_subtexel_bits(bits):
    """The integer taps at 0 and 4 fractional bits, against the plain gate."""
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(120.0, 10.0, 0.0).matrices()
    _, (feats, _, levels, sign) = port_gate(three_level_scene(), mj, params(False, STEPS[1]))
    want = slab.lookahead_gate(feats, None, levels, sign, bits)
    got, _ = chip_smoke.straight_gate(feats, levels, sign, bits)
    assert want.any()
    parity.check_gate(want, got, f"subtexel {bits}")


def test_straight_transcription_constants_are_the_kernels():
    """The transcription's FAR, per-ray proof, window, phases and one-texel
    margin are the straight kernel's (csrc/lookahead.cu), its bounds pass
    runs before either variant, and the per-ray table's rows that B6's
    bound counts are those the gate kernels read."""
    src = (CSRC / "lookahead.cu").read_text()
    assert set(re.findall(r"\bf\[(F_\w+) \* n_rays\]", src)) == set(chip_smoke.GATE_FEATURE_ROWS)
    assert float(re.search(r"constexpr float FAR = ([0-9.e]+)f;", src).group(1)) == FAR
    straight = src[src.index("    if constexpr (!CONE) {\n        // The valid steps"):src.index("    } else {\n        const float rhi")]
    phase1, phase2 = straight.split("// Phase 2")
    assert "if (ts > 0.0f && (float)(n - 1) + fmaxf(exit_, 0.0f) / ts < FAR) {" in phase1
    assert "j = marked_at_or_below(marked, j - 1)" in phase1
    for lo, hi, coord in (("x", "y", "rows_c"), ("z", "w", "cols_c")):
        assert f"{coord} >= (float)bd.{lo} - 1.0f" in phase1 and f"{coord} <= (float)bd.{hi} + 1.0f" in phase1
    assert "bit = ns <= jf + (exit_ - norm_pos(c2, cd, t)) / ts;" in phase2
    assert "const uint32_t m = marked[w];" in phase2 and "if ((m >> (j & 31)) & 1u) {" in phase2
    # the window: where t rounds monotone in j, the valid steps alone
    assert "if (ts > 0.0f && isfinite(ts) && isfinite(tb)) {" in phase1
    launch = src[src.index('extern "C" int lookahead_launch'):]
    assert launch.index("important_bounds_kernel<<<") < launch.index("if (cone_feats != nullptr)")
