"""The camera chain of volym_tpu_torch's plain replay and of the plain rows
(B5) against volym_tpu's TPU kernels, and the coordinate derivative's edge
cases.

The same numpy volume, LUT and image cotangent (made from a seed) go
through the port's plain functions on the CPU and through the JAX
package's Pallas kernels under the repo's emulator (``tests/pallas_emu.py``),
on one 1024-ray chunk (32x32 rays, the port's per-ray table in raster
order), 16 native f32 planes of the 16^3 volume.

- ``slab.replay_slabs``' ``d_feats`` (15 rows) against the d_feats of
  ``slab_bwd_kernel.backward`` / ``backward_shaded`` with
  ``camera_grads=True``, in {nearest, trilinear} x {shaded, unshaded} x
  {smoothing off, on}; under trilinear smoothing ``slab.feats_grad`` on
  the folded cotangents is added, as ``_run_feats_grad`` is there, and the
  two are also held to each other on the same cotangents.  The emulated
  kernels contract with the TPU package's full float32 dots
  (``slab_kernel.EXACT_DOT = "x6"``, its ``VOLYM_EXACT_DOT`` setting): with
  the default bf16 split ("x3") the emulated replay's own d_feats move by
  up to 9e-4 of the scale, while the port's agree with torch autograd of
  the plain march to 4e-7 (measured).  Held by the repo's rule
  (``parity.check_close``) on the whole table and on each nonzero row at
  its own scale; measured, within 6e-5.  The rows torch autograd of the
  plain march reaches (F_TS through the stencil's tap offsets, F_AEXP and
  the half vector; the snap cuts the coordinate rows) are held to it too.
- ``slab._dsample``, the coordinate derivative, against the TPU's ``_hat``
  and ``_dhat`` contraction at a coordinate on a texel (the right-sided
  difference) and at one snapped onto the last texel from below (texel n
  is absent: ``-v[n-1]``), and ``slab.feats_grad`` against
  ``_run_feats_grad`` on a ray whose raw coordinate lies just below the
  last texel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.pallas_emu import emulate
from volym_tpu.ops import slab_bwd_kernel, slab_kernel
from volym_tpu_torch import Camera, RenderParams, convert, parity
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.render import slab

SIDE, H, W = 16, 32, 32
SIGN_ORBITS = [(30.0, 20.0), (210.0, 20.0)]  # march sign +1 and -1
MODES = [
    ("nearest", False, False, SIGN_ORBITS[0]), ("nearest", False, True, SIGN_ORBITS[1]),
    ("nearest", True, False, SIGN_ORBITS[1]), ("nearest", True, True, SIGN_ORBITS[0]),
    ("trilinear", False, False, SIGN_ORBITS[0]), ("trilinear", False, True, SIGN_ORBITS[1]),
    ("trilinear", True, False, SIGN_ORBITS[1]), ("trilinear", True, True, SIGN_ORBITS[0]),
]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    vol = rng.integers(0, 170, (SIDE,) * 3).astype(np.float32) / np.float32(255.0)
    lut = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut[:, 3] *= 0.4
    g = rng.uniform(-1.0, 1.0, (H, W, 4)).astype(np.float32)
    return convert.scene(vol, np.zeros_like(vol), lut), torch.from_numpy(g)


def chunk(t) -> jnp.ndarray:
    """(rows, H, W) or (rows, R) -> the TPU's (1, 16, R) chunk, rows padded
    with zeros (H * W = R = one chunk)."""
    f = np.asarray(t, np.float32).reshape(t.shape[0], -1)
    out = np.zeros((1, 16, f.shape[1]), np.float32)
    out[0, : f.shape[0]] = f
    return jnp.asarray(out)


def hold_rows(want, got, label):
    """The repo's rule on the whole table and on each nonzero row."""
    parity.check_close(want, got, label)
    for row in range(slab.N_FEATURES):
        if np.abs(want[row]).max() > 0 or float(got[row].abs().max()) > 0:
            parity.check_close(want[row], got[row], f"{label} row {row}")


@pytest.mark.parametrize("interp,shading,smooth,orbit", MODES)
def test_replay_d_feats_match_tpu_kernels(inputs, monkeypatch, interp, shading, smooth, orbit):
    scene, g = inputs
    monkeypatch.setattr(slab_kernel, "EXACT_DOT", "x6")
    p = RenderParams(use_gaussian_smoothing=smooth, use_shading=shading, interpolation=interp,
                     density_threshold=0.15, raymarching_step_size=1.0 / SIDE)
    cam = Camera(aspect=W / H, distance=1.2).orbit(*orbit, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cam, p, H, W)
    assert not u8 and vol.shape[0] == SIDE
    label = f"{interp} shading={shading} smoothing={smooth} sign {sign}"

    # the plain replay, and torch autograd of the plain march
    fr = feats.clone().requires_grad_(True)
    img = slab.march_slabs(fr, vol, lut, sign, p, grad)
    (img * g).sum().backward()
    img = img.detach()
    res = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad)
    d_feats = res[-1]
    assert tuple(d_feats.shape) == (slab.N_FEATURES, H, W)
    rows = [slab.F_AEXP] + ([slab.F_HX, slab.F_HY, slab.F_HZ] if shading else [])
    rows += [slab.F_TS] if smooth and interp == "trilinear" else []
    parity.check_close(fr.grad[rows], d_feats[rows], f"{label} vs autograd")
    zero = [r for r in range(slab.N_FEATURES) if r not in rows + [slab.F_RS, slab.F_RB, slab.F_CS, slab.F_CB]]
    assert float(d_feats[zero].abs().max()) == 0.0
    if interp == "nearest":
        assert float(d_feats[: slab.F_CB + 1].abs().max()) == 0.0  # box hats: no coordinate chain

    # the TPU kernels, emulated, on the same table, volume and cotangent
    pj = vj.RenderParams(use_gaussian_smoothing=smooth, use_shading=shading, interpolation=interp,
                         density_threshold=0.15, camera_grads=True)
    major = slab.dominant_axis(cam)[0]
    vj_vol, vj_lut, vj_feats = jnp.asarray(vol.numpy()), jnp.asarray(lut.numpy()), chunk(feats)
    vj_grad = jnp.asarray(grad.numpy()) if shading else None
    gc = chunk(g.permute(2, 0, 1))[:, :4]
    with emulate(slab_kernel, slab_bwd_kernel):
        fin = slab_kernel._forward_call(pj, sign, vj_vol, vj_lut, vj_feats, None, vj_grad)
        if shading:
            want = slab_bwd_kernel.backward_shaded(pj, major, sign, vj_vol, vj_grad, vj_lut, vj_feats, fin, gc)[-1]
        else:
            want = slab_bwd_kernel.backward(pj, major, sign, vj_vol, vj_lut, vj_feats, fin, gc)[-1]
        if smooth and interp == "trilinear":
            plain_dd = slab.smooth_voxel_grad(feats, res[0], res[1], vol.shape, sign, p, want_folded=True)[2]
            b5 = slab.feats_grad(feats, vol, plain_dd, sign, p)
            b5_want = slab_bwd_kernel._run_feats_grad(
                vj_feats, vj_vol, chunk(plain_dd)[:, :, None], bilinear=True, win_rows=0, sb=slab_kernel.SLAB_BATCH,
                sign=sign, subtexel=p.subtexel_bits,
            )
            b5_want = np.asarray(b5_want)[0, : slab.N_FEATURES].reshape(slab.N_FEATURES, H, W)
            assert np.abs(b5_want[: slab.F_CB + 1]).max() > 0
            hold_rows(b5_want, b5, f"{label} feats_grad vs _run_feats_grad")
            d_feats = d_feats + b5
    want = np.asarray(want)[0, : slab.N_FEATURES].reshape(slab.N_FEATURES, H, W)
    assert np.abs(want).max() > 0
    hold_rows(want, d_feats, label)


def test_dsample_edge_cases():
    """At a snapped coordinate on texel i the derivative is v[i+1] - v[i];
    at one on the last texel, -v[n-1] (texel n is absent, not clamped); in
    between, the bilinear slope; both as the TPU's hat contraction."""
    rng = np.random.default_rng(4)
    nr, nc = 6, 5
    sl = rng.uniform(0.1, 1.0, (nr, nc)).astype(np.float32)
    rows = np.array([2.0, 5.0, 2.25, 5.0, 0.0], np.float32)
    cols = np.array([1.5, 3.0, 4.0, 4.0, 0.0], np.float32)
    d_rows, d_cols = slab._dsample(torch.from_numpy(sl), torch.from_numpy(rows), torch.from_numpy(cols))

    r = rows.size
    rj, cj = jnp.asarray(rows)[None], jnp.asarray(cols)[None]
    hat_x, dhat_x = slab_bwd_kernel._hat(cj, nc, r, True), slab_bwd_kernel._dhat(cj, nc, r, True)
    hat_y, dhat_y = slab_bwd_kernel._hat(rj, nr, r, True), slab_bwd_kernel._dhat(rj, nr, r, True)
    s = jnp.asarray(sl)
    want_rows = np.asarray(jnp.sum((s.T @ dhat_y) * hat_x, axis=0))
    want_cols = np.asarray(jnp.sum((s.T @ hat_y) * dhat_x, axis=0))
    np.testing.assert_allclose(d_rows.numpy(), want_rows, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(d_cols.numpy(), want_cols, rtol=1e-6, atol=1e-7)

    v = sl.astype(np.float64)
    assert d_rows[0] == pytest.approx(0.5 * (v[3, 1] - v[2, 1]) + 0.5 * (v[3, 2] - v[2, 2]), rel=1e-6)
    assert d_rows[1] == pytest.approx(-v[5, 3], rel=1e-6)  # on the last row
    assert d_cols[2] == pytest.approx(-(0.75 * v[2, 4] + 0.25 * v[3, 4]), rel=1e-6)  # on the last column
    assert d_rows[3] == pytest.approx(-v[5, 4], rel=1e-6) and d_cols[3] == pytest.approx(-v[5, 4], rel=1e-6)
    assert d_rows[4] == pytest.approx(v[1, 0] - v[0, 0], rel=1e-6)


def test_feats_grad_below_the_last_texel():
    """A ray whose raw row coordinate lies 2^-10 below the last texel snaps
    onto it (8 subtexel bits) and still carries the chain (the mask reads
    the raw coordinate), with derivative -v[n-1]; a ray at the raw last
    texel carries none.  The port's plain B5 against ``_run_feats_grad``."""
    rng = np.random.default_rng(6)
    n, nr, nc = 8, 6, 5
    vol = rng.uniform(0.1, 1.0, (n, nr, nc)).astype(np.float32)
    rays = 1024
    f = np.zeros((slab.N_FEATURES, rays), np.float32)
    f[slab.F_RB] = rng.uniform(0.2, nr - 1.2, rays)
    f[slab.F_CB] = rng.uniform(0.2, nc - 1.2, rays)
    f[slab.F_RS] = rng.uniform(-0.1, 0.1, rays)
    f[slab.F_CS] = rng.uniform(-0.1, 0.1, rays)
    f[slab.F_RS, :2] = f[slab.F_CS, :2] = 0.0
    f[slab.F_RB, 0] = np.float32(nr - 1 - 2.0**-10)
    f[slab.F_RB, 1] = nr - 1
    f[slab.F_TS] = 1.0
    dd = rng.normal(size=(n, rays)).astype(np.float32)
    p = RenderParams(interpolation="trilinear")
    feats = torch.from_numpy(f).reshape(slab.N_FEATURES, 32, 32)
    got = slab.feats_grad(feats, torch.from_numpy(vol), torch.from_numpy(dd).reshape(n, 32, 32), 1, p)
    got = got.reshape(slab.N_FEATURES, rays)
    with emulate(slab_kernel, slab_bwd_kernel):
        want = slab_bwd_kernel._run_feats_grad(
            chunk(f), jnp.asarray(vol), jnp.asarray(dd.reshape(1, n, 1, rays)), bilinear=True, win_rows=0,
            sb=slab_kernel.SLAB_BATCH, sign=1, subtexel=8,
        )
    want = np.asarray(want)[0, : slab.N_FEATURES]
    hold_rows(want, got, "feats_grad")
    c = f[slab.F_CB, 0]
    c0 = int(np.floor(c * 256 + 0.5)) / 256  # the snapped column
    i, t = int(np.floor(c0)), c0 - np.floor(c0)
    expect = sum(-float(dd[j, 0]) * ((1 - t) * vol[j, nr - 1, i] + t * vol[j, nr - 1, i + 1]) for j in range(n))
    assert float(got[slab.F_RB, 0]) == pytest.approx(expect, rel=1e-5)
    assert float(got[slab.F_RB, 1]) == 0.0 and float(got[slab.F_RS, 1]) == 0.0
