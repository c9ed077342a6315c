"""The cone gate kernel (B7, ``lookahead_kernel<true>`` in
``volym_tpu_torch/ops/csrc/lookahead.cu``) against the plain gate and the
TPU's, on the CPU.

The kernel runs one thread a ray.  It sweeps the steps in reverse and, at
each step, forms the gate bit as the OR over the ray's eight cone
directions of ``valid && ns_c <= j + d_range * rate_c && rate_c > 0``, then
runs the eight probes, each moving its own ``ns_c``, then clears the bit
where the ray's own nearest sample is opaque, reading it only where the
bit is set.  A first pass bounds, for each slice, the rows and columns its
important texels span: a step whose slice has none runs no probe, and a
probe a texel or more outside them takes no tap; the taps that remain are
formed in integers (``snapped_tap``).  The card is not here, so a torch
transcription of that kernel, in this file, is held bit for bit to
``slab.lookahead_gate`` and to
``volym_tpu.ops.lookahead_kernel.lookahead_call`` under the repo's Pallas
emulator (``tests/pallas_emu.py``), at every (major axis, sign) view, on
native and resampled planes, on the scene with importance at all three
levels and on the 16^3 teapot stand-in.  No (step, ray) is exempt, and no
skipped probe would have found an important texel.
"""

import re
from pathlib import Path

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the TPU gate's emulation needs)
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.test_torch_lookahead import ORBITS, STEPS, H, W, params, port_gate, teapot_scene, three_level_scene, tpu_gate
from volym_tpu.render import slab as jslab
from volym_tpu_torch import parity
from volym_tpu_torch.ops import lookahead
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.rays import sqrt_rn
from volym_tpu_torch.render.slab import (
    CF_CB, CF_CS, CF_RATE, CF_RB, CF_RS, CF_STRIDE, CF_TB, CF_TS, CONE_SAMPLES, F_C2, F_CB, F_CD, F_CS, F_ENTRY,
    F_EXIT, F_RB, F_RS, F_SIGNOK, F_TB, F_TS, FAR, N_FEATURES,
)

CSRC = Path(__file__).resolve().parents[1] / "volym_tpu_torch" / "ops" / "csrc"


def _snapped_tap(c, bits):
    """The kernel's snapped_tap: floor(snap(c) + 0.5) in integers,
    (floor(c * 2^bits + 0.5) + 2^(bits-1)) >> bits."""
    i = torch.floor(c * float(1 << bits) + 0.5).long()
    return (i + (1 << (bits - 1))) >> bits


def cone_lanes_gate(feats, cone_feats, levels, sign, subtexel, return_terms=False):
    """The cone kernel, one thread a ray, over all rays at once -> the
    packed gate (ceil(N/32), H, W) int64 words (and, with
    ``return_terms``, each direction's term of every step (CONE_SAMPLES,
    N, R) before the OR)."""
    assert subtexel > 0
    _, height, width = feats.shape
    f = feats.reshape(N_FEATURES, -1)
    cf = cone_feats.reshape(CONE_SAMPLES, CF_STRIDE, -1)
    n, nr, nc = levels.shape
    lv = levels.reshape(n, -1)
    entry, exit_ = f[F_ENTRY], f[F_EXIT]
    live = (f[F_SIGNOK] > 0.5) & ~(exit_ <= entry)
    rate = cf[:, CF_RATE]
    # the first pass: each slice's important rows and columns, widened by a
    # texel (none: the slice runs no probe)
    imp = levels >= 1
    rows_any, cols_any = imp.any(2), imp.any(1)
    has = rows_any.any(1)
    idx_r, idx_c = torch.arange(nr).expand(n, nr), torch.arange(nc).expand(n, nc)
    r_lo = torch.where(rows_any, idx_r, nr).amin(1).float() - 1.0
    r_hi = torch.where(rows_any, idx_r, -1).amax(1).float() + 1.0
    c_lo = torch.where(cols_any, idx_c, nc).amin(1).float() - 1.0
    c_hi = torch.where(cols_any, idx_c, -1).amax(1).float() + 1.0
    ns = torch.full((CONE_SAMPLES, f.shape[1]), FAR, dtype=torch.float32)
    bits = torch.zeros((n, f.shape[1]), dtype=torch.bool)
    terms = torch.zeros((CONE_SAMPLES, n, f.shape[1]), dtype=torch.bool)
    for j in reversed(range(n)):
        jf = torch.tensor(float(j), dtype=torch.float32)
        k = j if sign > 0 else n - 1 - j
        t = f[F_TS] * jf + f[F_TB]
        valid = live & (t >= entry) & (t < exit_)
        d_range = exit_ - sqrt_rn(torch.clamp(f[F_C2] + 2.0 * t * f[F_CD] + t * t, min=0.0))
        terms[:, j] = valid[None] & (ns <= jf + d_range[None] * rate) & (rate > 0.0)
        if bool(has[k]):
            rows_u = cf[:, CF_RS] * jf + cf[:, CF_RB]
            cols_u = cf[:, CF_CS] * jf + cf[:, CF_CB]
            t_c = cf[:, CF_TS] * jf + cf[:, CF_TB]
            in_box = (rows_u >= -0.5) & (rows_u <= nr - 0.5) & (cols_u >= -0.5) & (cols_u <= nc - 0.5) & (t_c > 0.0)
            near = (rows_u >= r_lo[k]) & (rows_u <= r_hi[k]) & (cols_u >= c_lo[k]) & (cols_u <= c_hi[k])
            r = _snapped_tap(torch.clamp(rows_u, 0.0, nr - 1.0), subtexel)
            c = _snapped_tap(torch.clamp(cols_u, 0.0, nc - 1.0), subtexel)
            level = lv[k][r * nc + c]
            # the skipped probes are never important
            assert not bool((in_box & ~near & (level >= 1)).any())
            ns = torch.where(in_box & near & (level >= 1), jf, ns)
        else:
            assert not bool(imp[k].any())
        bit = terms[:, j].any(0)
        # the ray's own sample, read only where the bit is set
        idx = bit.nonzero().squeeze(1)
        rows = slab.snap(torch.clamp(f[F_RS][idx] * jf + f[F_RB][idx], 0.0, nr - 1.0), subtexel)
        cols = slab.snap(torch.clamp(f[F_CS][idx] * jf + f[F_CB][idx], 0.0, nc - 1.0), subtexel)
        bit[idx] = lv[k][slab._nearest_tap(rows, cols, nr, nc)] < 2
        bits[j] = bit
    n_words = lookahead.gate_words(n)
    padded = torch.zeros((32 * n_words, f.shape[1]), dtype=torch.int64)
    padded[:n] = bits.long()
    shifts = torch.arange(32, dtype=torch.int64)[None, :, None]
    words = (padded.reshape(n_words, 32, -1) << shifts).sum(1).reshape(n_words, height, width)
    return (words, terms) if return_terms else words


def _unpack(words, n):
    return lookahead.unpack_gate(words.to(torch.int32), n)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("h,v", ORBITS)
def test_cone_lanes_match_plain_and_tpu_gate(h, v, step):
    arrays = three_level_scene()
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    want = tpu_gate(arrays, mj, params(True, step))
    plain, (feats, cone_feats, levels, sign) = port_gate(arrays, mj, params(True, step))
    words, terms = cone_lanes_gate(feats, cone_feats, levels, sign, 8, return_terms=True)
    got = _unpack(words, levels.shape[0])
    assert want.any(), "the gate never engages"
    label = f"view {jslab.dominant_axis(mj)} step {step}"
    parity.check_gate(plain, got, f"{label} vs plain")
    parity.check_gate(want, got, f"{label} vs TPU")
    # more than one direction sets bits, and the main ray's check clears
    # some of the ORed bits (the scene has opaque importance)
    assert int(terms.flatten(1).any(1).sum()) > 1
    assert int(terms.any(0).sum()) > int(got.sum())


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("h,v", [(30.0, 20.0), (210.0, 20.0)])
def test_teapot_cone_lanes_match_plain_and_tpu_gate(h, v, step):
    arrays = teapot_scene()
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    want = tpu_gate(arrays, mj, params(True, step))
    plain, (feats, cone_feats, levels, sign) = port_gate(arrays, mj, params(True, step))
    got = _unpack(cone_lanes_gate(feats, cone_feats, levels, sign, 8), levels.shape[0])
    assert want.any(), "the gate never engages"
    parity.check_gate(plain, got, f"teapot view {jslab.dominant_axis(mj)} step {step} vs plain")
    parity.check_gate(want, got, f"teapot view {jslab.dominant_axis(mj)} step {step} vs TPU")


def test_transcription_constants_are_the_kernels():
    """The transcription's FAR (slab.FAR) and cone directions are the cone
    kernel's (csrc/lookahead.cu, csrc/slab_common.cuh)."""
    src = (CSRC / "lookahead.cu").read_text()
    assert float(re.search(r"constexpr float FAR = ([0-9.e]+)f;", src).group(1)) == FAR
    common = (CSRC / "slab_common.cuh").read_text()
    assert int(re.search(r"CONE_SAMPLES = (\d+)[,;]", common).group(1)) == CONE_SAMPLES


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("n_tex", [16, 256])
def test_snapped_tap_is_the_nearest_tap_of_the_snap(bits, n_tex):
    """snapped_tap's integer tap equals the plain version's nearest tap of
    the snapped coordinate, floor(snap(c) + 0.5), over [0, n_tex - 1]:
    every half-step of the snap grid (its ties) and random coordinates."""
    grid = torch.arange(0, (n_tex - 1) * (1 << (bits + 1)) + 1, dtype=torch.float32) / float(1 << (bits + 1))
    rand = torch.from_numpy(np.random.default_rng(bits).uniform(0.0, n_tex - 1.0, 100_000).astype(np.float32))
    c = torch.cat([grid, rand, torch.nextafter(grid, torch.tensor(float(n_tex)))]).clamp(0.0, n_tex - 1.0)
    want = torch.clamp(torch.floor(slab.snap(c, bits) + 0.5), 0, n_tex - 1).long()
    assert torch.equal(_snapped_tap(c, bits), want)
