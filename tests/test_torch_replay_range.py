"""The replay's step range as a contract, on the CPU.

Under Gaussian smoothing the CUDA replay (``ops/csrc/slab_replay.cu``)
writes its per-step cotangents ``dd`` only inside each ray's step range
``[first, last]`` and leaves the rest of its ``torch.empty`` allocation as
it finds it; the fused fold-and-scatter reads only inside the range.  The
card is not here, so:

- (a) the plain replay ``slab.replay_slabs``, the kernel's reference, gives
  ``dd`` exactly 0.0 outside the range, and ``(N, -1)`` exactly for the rays
  with no cotangent, in every march sign x filter x shading x route
  (stored residual, re-sampled, re-sampled with the camera chain): so
  holding the kernel's ``dd`` to it on the range (``slab.dense_dd``) loses
  nothing;
- (b) the torch transcription of the fused fold (``kernel_fold`` of
  ``tests/test_torch_fold.py``) on the plain replay's ``dd`` with NaN
  outside the range equals the same on the plain ``dd``, bit for bit, and
  the plain fold-and-scatter on ``dense_dd`` of it equals the plain one;
- (c) hypothesis: a smoothing stencil (``slab.smooth_row``, bilinear and
  box hats, rows clamped at the volume's ends, taps cut at the box faces)
  over plain rows whose largest value, times ``1 + 2**-16``, lies below a
  threshold lies below it too.  The march (B1) and the re-sampled replay
  (B2) skip such a step's stencil (``sample_bound`` in
  ``csrc/slab_common.cuh``), so the skip changes no bit.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_fold import kernel_fold
from volym_tpu_torch import Camera, RenderParams, Scene, parity
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.slab import F_CB, F_CS, F_RB, F_RS, F_TS, N_FEATURES, SMOOTH_HALO

SIDE, H, W = 16, 16, 24
#: orbits whose views march with sign +1 and -1
SIGN_ORBITS = [(30.0, 20.0), (210.0, 20.0)]
ROUTES = ["stored", "re-sampled", "camera"]


@pytest.fixture(scope="module")
def bonsai16():
    return Scene.synthetic("bonsai", side=SIDE, seed=2)


def _replay(scene, h, v, interp, shading, route):
    """The plain replay under smoothing on one route -> (dd, steps, vol,
    feats, sign, params)."""
    camera = route == "camera"
    p = RenderParams(use_gaussian_smoothing=True, interpolation=interp, use_shading=shading, u8_volume=not camera,
                     camera_grads=camera, density_threshold=0.12, raymarching_step_size=1.0 / SIDE)
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cam, p, H, W)
    img, dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32))
    res = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8, dens if route == "stored" else None)
    assert len(res) == (4 if camera else 3)
    return res[0], res[1], vol, feats, sign, p


def _inside(dd, steps):
    j = torch.arange(dd.shape[0])[:, None, None]
    inside = (j >= steps[0]) & (j <= steps[1])
    return inside[:, None].expand(dd.shape) if dd.dim() == 4 else inside


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shading", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", SIGN_ORBITS)
def test_plain_dd_is_zero_outside_the_step_range(bonsai16, h, v, interp, shading, route):
    dd, steps, vol, *_ = _replay(bonsai16, h, v, interp, shading, route)
    n = vol.shape[0]
    assert steps.dtype == torch.int32 and tuple(steps.shape) == (2, H, W)
    outside = dd[~_inside(dd, steps)]
    assert outside.numel() > 0 and bool((outside == 0.0).all())
    assert torch.equal(slab.dense_dd(dd, steps), dd)
    # a ray with no cotangent is (N, -1) and only such a ray; the others lie in the sweep
    empty = steps[0] > steps[1]
    carries = (dd != 0.0).reshape(n, -1, H, W).any(1).any(0) if shading else (dd != 0.0).any(0)
    assert torch.equal(empty, ~carries)
    assert bool((steps[0][empty] == n).all()) and bool((steps[1][empty] == -1).all())
    live = ~empty
    assert 0 < int(live.sum()) < H * W
    assert bool((steps[0][live] >= 0).all()) and bool((steps[1][live] <= n - 1).all())


@pytest.mark.parametrize("shading", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", SIGN_ORBITS)
def test_fold_never_reads_outside_the_step_range(bonsai16, h, v, interp, shading):
    dd, steps, vol, feats, sign, p = _replay(bonsai16, h, v, interp, shading, "re-sampled")
    _, nr, nc = vol.shape
    bilinear = interp == "trilinear"
    poisoned = torch.where(_inside(dd, steps), dd, float("nan"))
    assert bool(poisoned.isnan().any())
    d0, p0 = (dd[:, 0], poisoned[:, 0]) if shading else (dd, poisoned)
    want = kernel_fold(feats, d0, steps, nr, nc, bilinear)
    got = kernel_fold(feats, p0, steps, nr, nc, bilinear)
    assert float(want.abs().max()) > 0
    assert torch.equal(want, got)
    # the plain fold-and-scatter on the poisoned dd made dense again
    plain = slab.smooth_voxel_grad(feats, dd, steps, vol.shape, sign, p, want_folded=True)
    dense = slab.smooth_voxel_grad(feats, slab.dense_dd(poisoned, steps), steps, vol.shape, sign, p, want_folded=True)
    for a, b in zip(plain, dense):
        if a is not None:
            assert torch.equal(a, b)
    parity.check_close(plain[2], want, "folded rows")


def _stencil_case(rng, n_rays, bilinear, u8):
    """Random rays at random march steps with their 7 plain stencil rows
    clamped at the volume's ends -> (feats (N_FEATURES, R), jf (1, R), rows,
    n, nr, nc).  The rays' offsets put taps on and past the box faces and
    their steps reach the sweep's ends."""
    n = int(rng.integers(8, 301))
    nr, nc = (int(x) for x in rng.integers(2, 257, 2))
    f = np.zeros((N_FEATURES, n_rays), np.float32)
    f[F_RS] = rng.uniform(-3.0, 3.0, n_rays)
    f[F_CS] = rng.uniform(-3.0, 3.0, n_rays)
    f[F_RB] = rng.uniform(-2.0, nr + 1.0, n_rays)
    f[F_CB] = rng.uniform(-2.0, nc + 1.0, n_rays)
    f[F_TS] = rng.choice([0.0, 1e-4, 2e-3, 5e-3, 0.01, 0.05], n_rays) * rng.uniform(0.5, 1.5, n_rays)
    j = rng.integers(0, n, n_rays)
    j[::5] = rng.choice([0, 1, n - 2, n - 1], len(j[::5]))
    # plain rows of the sweep around each ray's step, the ends clamped
    top = 255.0 if u8 else 1.0
    plain = rng.uniform(0.0, top, (n, n_rays)).astype(np.float32)
    if u8:
        plain = np.round(plain)
    flat = rng.uniform(size=n_rays) < 0.3  # every row at one value: the sums' rounding at its worst
    plain[:, flat] = plain[0, flat]
    idx = np.clip(j[None, :] + np.arange(-SMOOTH_HALO, SMOOTH_HALO + 1)[:, None], 0, n - 1)
    rows = [torch.from_numpy(plain[idx[o], np.arange(n_rays)]) for o in range(2 * SMOOTH_HALO + 1)]
    return torch.from_numpy(f), torch.from_numpy(j.astype(np.float32))[None], rows, n, nr, nc


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**32 - 1), bilinear=st.booleans(), u8=st.booleans())
def test_stencil_of_rows_below_the_bound_is_below_it(seed, bilinear, u8):
    f, jf, rows, n, nr, nc = _stencil_case(np.random.default_rng(seed), 2048, bilinear, u8)
    smoothed = slab.smooth_row(f, jf, [r[None] for r in rows], n, nr, nc, bilinear)[0]
    top = torch.stack(rows).amax(0)
    bound = torch.clamp(top, min=0.0) * torch.tensor(1.0 + 2.0**-16, dtype=torch.float32)
    # any threshold above the bound is above the smoothed density: the skip is exact
    assert bool((smoothed <= bound).all()), float((smoothed - bound).max())
    assert float(smoothed.max()) > 0.0
