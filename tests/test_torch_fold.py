"""The smoothed backward's fold and scatter in volym_tpu_torch: the fused
kernel's algorithm, the replay's step range and the CPU dispatch.

Under Gaussian smoothing the replay writes each march step's cotangent
``dd`` and each ray's range of steps that carry one; the fused
fold-and-scatter kernel (``ops/csrc/voxel_grad.cu``, ``FOLD``) walks only
those steps, folds the stencil's transpose into the scatter one ray a
thread, and scatters each plain row once.  The card is not here, so:

- a torch transcription, in this file, of the kernel's gather form (the
  ray's 35 constants ``w_t * ker(u_t - off)`` and the 7 quotients of a
  step with every tap in the box, each source step's in-box bits and
  ``wsum``, each plain row summed over the offsets -3..3 in order, true
  division) is held to the plain transpose
  ``slab.smooth_dd_transpose`` bit for bit on the rows with one source an
  offset (1 <= k <= N-2) and within 1e-6 of the scale on the two end rows,
  whose clamped sources the plain ``index_add_`` sums in no fixed order on
  the card; nearest and trilinear, shaded and unshaded, both march signs,
  at 256 planes where every stencil row weighs;
- the plain replay's step range holds every nonzero of its own ``dd`` and
  is empty exactly where ``dd`` is all zero;
- ``smooth_backward`` on CPU tensors equals the JAX package's
  ``_smooth_dd_transpose`` followed by the TPU scatters
  ``_voxel_grad_kernel`` / ``_voxel_grad_shaded_kernel`` under the repo's
  emulator (``tests/pallas_emu.py``), launches no kernel, and the CUDA entry
  refuses CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_smooth import _tpu_feats, _tpu_scatter
from volym_tpu.ops import slab_bwd_kernel
from volym_tpu_torch import Camera, RenderParams, Scene, parity
from volym_tpu_torch.ops import feats_grad, slab_march, voxel_grad
from volym_tpu_torch.render import rays, slab
from volym_tpu_torch.render.slab import F_CB, F_CS, F_RB, F_RS, F_TS, GAUSS_TAPS, N_FEATURES, SMOOTH_HALO

H, W = 16, 24
#: orbits whose views march with sign +1 and -1
SIGN_ORBITS = [(30.0, 20.0), (210.0, 20.0)]


def _feats(h, v, planes, n_plane, height=H, width=W):
    """(march sign, the port's per-ray table (N_FEATURES, H, W)) of an orbit."""
    cam = Camera(aspect=width / height, distance=1.3).orbit(h, v, 0.0).matrices()
    major, sign = slab.dominant_axis(cam)
    origin, dirs = rays.generate_rays(cam, height, width)
    entry, exit_ = rays.ray_box_intersection(origin, dirs)
    feats = slab_march.features_from_rays(origin, dirs, entry, exit_, planes, major, sign, n_plane=n_plane)
    return sign, feats.reshape(N_FEATURES, height, width)


def _ranged_dd(rng, planes, height, width, shaded):
    """Random per-step cotangents that are 0.0 outside a random step range
    per ray (some rays empty, some touching either end of the sweep) and
    in a third of the steps inside it -> (dd, steps)."""
    n_rays = height * width
    first = rng.integers(0, planes, n_rays)
    last = np.minimum(first + rng.integers(0, 24, n_rays), planes - 1)
    first[::7], last[::11] = 0, planes - 1
    first = np.minimum(first, last)
    empty = rng.uniform(size=n_rays) < 0.15
    first[empty], last[empty] = planes, -1
    j = np.arange(planes)[:, None]
    inside = (j >= first) & (j <= last)
    shape = (planes, 4, n_rays) if shaded else (planes, n_rays)
    dd = rng.normal(0.0, 1.0, shape).astype(np.float32)
    dd[rng.uniform(size=shape) < 0.33] = 0.0
    dd *= (inside[:, None] if shaded else inside).astype(np.float32)
    steps = np.stack([first, last]).astype(np.int32).reshape(2, height, width)
    return torch.from_numpy(dd.reshape((planes, 4, height, width) if shaded else (planes, height, width))), \
        torch.from_numpy(steps)


def kernel_fold(feats, dd0, steps, nr, nc, bilinear):
    """The fused kernel's fold (``fold_scatter`` in csrc/voxel_grad.cu),
    transcribed op by op over all rays at once: (N, H, W) plain-row
    cotangents from the (N, H, W) smoothed-density cotangents ``dd0``, read
    only inside each ray's ``steps`` range."""
    m = dd0.shape[0]
    f = feats.reshape(N_FEATURES, -1)
    d = dd0.reshape(m, -1)
    first, last = steps.reshape(2, -1)
    rs, rb, cs, cb, ts_raw = f[F_RS], f[F_RB], f[F_CS], f[F_CB], f[F_TS]
    ts = torch.where(ts_raw == 0.0, 1.0, ts_raw)
    # constants of the ray
    taps = []
    for delta, w in GAUSS_TAPS:
        u = torch.full_like(ts, delta) / ts
        wk = []
        for o in range(2 * SMOOTH_HALO + 1):
            dl = u - float(o - SMOOTH_HALO)
            ker = torch.clamp(1.0 - torch.abs(dl), min=0.0) if bilinear else ((dl >= -0.5) & (dl < 0.5)).float()
            wk.append(w * ker)
        taps.append((w, u, u * rs, u * cs, wk))
    # the quotients of a step with every tap in the box
    w_all = torch.zeros_like(ts)
    for _, w in GAUSS_TAPS:
        w_all = w_all + w
    q_all = []
    for o in range(2 * SMOOTH_HALO + 1):
        coeff = torch.zeros_like(ts)
        for *_, wk in taps:
            coeff = coeff + wk[o]
        q_all.append(coeff / w_all)
    # the source steps: cotangent, in-box bits, wsum
    srcs = []
    for j in range(m):
        jf = float(j)
        rows_raw, cols_raw = rs * jf + rb, cs * jf + cb
        wsum = torch.zeros_like(ts)
        bits = []
        for w, u, urs, ucs, _ in taps:
            rt, ct, st = rows_raw + urs, cols_raw + ucs, jf + u
            in_box = (rt >= -0.5) & (rt <= nr - 0.5) & (ct >= -0.5) & (ct <= nc - 0.5) & (st >= -0.5) & (st <= m - 0.5)
            wsum = wsum + torch.where(in_box, w, 0.0)
            bits.append(in_box)
        v = torch.where((j >= first) & (j <= last), d[j], 0.0)
        all_in = torch.stack(bits).all(0)
        srcs.append((v, torch.where(wsum > 0.0, wsum, 1.0), bits, all_in))
    # the plain rows: offsets in order, an end row's clamped sources in order
    out = torch.zeros_like(d)
    for k in range(m):
        acc = torch.zeros_like(ts)
        for o in range(2 * SMOOTH_HALO + 1):
            off = o - SMOOTH_HALO
            j_lo = 0 if k == 0 else k - off
            j_hi = m - 1 if k == m - 1 else k - off
            for j in range(max(j_lo, 0), min(j_hi, m - 1) + 1):
                v, wsum, bits, all_in = srcs[j]
                coeff = torch.zeros_like(ts)
                for (_, _, _, _, wk), in_box in zip(taps, bits):
                    coeff = coeff + torch.where(in_box, wk[o], 0.0)
                term = torch.where(all_in, q_all[o] * v, coeff / wsum * v)
                acc = torch.where(v != 0.0, acc + term, acc)
        out[k] = acc
    return out.reshape(dd0.shape)


@pytest.mark.parametrize("shaded", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", SIGN_ORBITS)
def test_kernel_fold_matches_plain_transpose(h, v, interp, shaded):
    planes, nr, nc = 256, 24, 20
    sign, feats = _feats(h, v, planes, nr)
    dd, steps = _ranged_dd(np.random.default_rng(5), planes, H, W, shaded)
    bilinear = interp == "trilinear"
    dd0 = dd[:, 0] if shaded else dd
    got = kernel_fold(feats, dd0, steps, nr, nc, bilinear)
    want = slab.smooth_dd_transpose(feats, dd0, nr, nc, bilinear)
    scale = float(want.abs().max())
    assert scale > 0
    # the stencil's outer rows weigh (trilinear reaches +-3 at 256 planes)
    far = float((0.01 / feats[F_TS].abs()).max())
    assert (far > 2.0) if bilinear else (far > 1.5)
    assert torch.equal(got[1:-1], want[1:-1])
    assert float((got[[0, -1]] - want[[0, -1]]).abs().max()) <= 1e-6 * scale
    # the whole function: the folded density rows and the unfolded channels scattered
    p = RenderParams(interpolation=interp)
    d_vol, d_grad, folded = slab.smooth_voxel_grad(feats, dd, steps, (planes, nr, nc), sign, p, want_folded=True)
    assert torch.equal(folded, want)
    plain = torch.cat([got[:, None], dd[:, 1:]], dim=1) if shaded else got
    k_vol, k_grad = slab.voxel_grad(feats, plain, (planes, nr, nc), sign, p)
    parity.check_close(d_vol, k_vol, "d_vol")
    if shaded:
        parity.check_close(d_grad, k_grad, "d_grad")
    else:
        assert d_grad is None
    assert slab.smooth_voxel_grad(feats, dd, steps, (planes, nr, nc), sign, p)[2] is None


@pytest.fixture(scope="module")
def bonsai16():
    return Scene.synthetic("bonsai", side=16, seed=2)


@pytest.mark.parametrize("camera", [False, True])
@pytest.mark.parametrize("shading", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_replay_step_range_bounds_its_cotangents(bonsai16, interp, shading, camera):
    p = RenderParams(use_gaussian_smoothing=True, interpolation=interp, use_shading=shading, u8_volume=not camera,
                     camera_grads=camera, density_threshold=0.12, raymarching_step_size=1.0 / 16)
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(bonsai16, cam, p, H, W)
    assert u8 != camera  # camera cotangents replay the f32 volume
    img = slab.march_slabs(feats, vol, lut, sign, p, grad, u8)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32))
    res = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8)
    assert len(res) == (4 if camera else 3)
    dd, steps = res[0], res[1]
    n = vol.shape[0]
    assert steps.dtype == torch.int32 and tuple(steps.shape) == (2, H, W)
    nonzero = (dd != 0.0).any(1) if shading else dd != 0.0
    j = torch.arange(n)[:, None, None]
    inside = (j >= steps[0]) & (j <= steps[1])
    assert not bool((nonzero & ~inside).any()), "a cotangent outside its ray's range"
    empty = steps[0] > steps[1]
    assert torch.equal(empty, ~nonzero.any(0))
    assert bool((steps[0][empty] == n).all()) and bool((steps[1][empty] == -1).all())
    assert 0 < int((~empty).sum()) < H * W
    # the range is tight: its first and last steps carry a cotangent
    rays_ = torch.nonzero(~empty)
    for r, c in rays_.tolist():
        assert bool(nonzero[steps[0, r, c], r, c]) and bool(nonzero[steps[1, r, c], r, c])


@pytest.mark.parametrize("camera", [False, True])
@pytest.mark.parametrize("shaded", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_smooth_backward_on_cpu_matches_jax_transpose_and_tpu_scatters(interp, shaded, camera):
    """32x32 rays (one 1024-ray TPU chunk), 32 planes of 16x16 texels."""
    planes, nr = 32, 16
    sign, feats = _feats(30.0, 20.0, planes, nr, 32, 32)
    rng = np.random.default_rng(9)
    dd, steps = _ranged_dd(rng, planes, 32, 32, shaded)
    vol = torch.from_numpy(rng.uniform(0.0, 1.0, (planes, nr, nr)).astype(np.float32))
    bilinear = interp == "trilinear"
    p = RenderParams(interpolation=interp, use_shading=shaded, camera_grads=camera)
    counts = (voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES, voxel_grad.LAUNCHES,
              voxel_grad.SHADED_LAUNCHES, feats_grad.LAUNCHES)
    d_vol, d_grad, d_feats = slab_march.smooth_backward(feats, dd, steps, vol, sign, p)
    assert (voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES, voxel_grad.LAUNCHES,
            voxel_grad.SHADED_LAUNCHES, feats_grad.LAUNCHES) == counts

    dd_np = dd.numpy().reshape(planes, 4 if shaded else 1, -1)
    with jax.disable_jit():
        folded = np.asarray(slab_bwd_kernel._smooth_dd_transpose(
            _tpu_feats(feats), jnp.asarray(dd_np[:, :1].reshape(1, planes, 1, -1)), planes, bilinear, nr=nr, nc=nr
        ))[0, :, 0]
    plain = np.concatenate([folded[:, None], dd_np[:, 1:]], axis=1) if shaded else folded
    want_vol, want_grad = _tpu_scatter(feats, plain, planes, nr, nr, sign, bilinear)
    assert float(np.abs(want_vol).max()) > 0
    parity.check_close(want_vol, d_vol, f"{interp} d_vol")
    if shaded:
        parity.check_close(want_grad, d_grad, f"{interp} d_grad")
    else:
        assert d_grad is None
    if camera and bilinear:
        want_feats = slab.feats_grad(feats, vol, torch.from_numpy(folded.reshape(planes, 32, 32).copy()), sign, p)
        assert float(want_feats.abs().max()) > 0
        assert torch.equal(d_feats, want_feats)
    else:
        assert d_feats is None
    with pytest.raises(ValueError, match="CUDA tensors"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps, (planes, nr, nr), sign, p)
