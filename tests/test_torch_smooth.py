"""Gaussian smoothing in volym_tpu_torch against volym_tpu: the plane count,
the stencil, its transpose and the voxel-gradient scatters.

The same numpy inputs (made from a seed) go through the port's plain
functions on the CPU and through the JAX package, run eagerly
(``jax.disable_jit``, see ``test_torch_march``); its Pallas kernels run
under the repo's emulator (``tests/pallas_emu.py``).

- ``resolve_planes`` equals JAX's exactly over a grid of step sizes and
  sides.
- ``smoothed_densities`` equals the jnp spec
  ``volym_tpu.render.slab.smoothed_densities`` bit for bit at 128 and 256
  planes (texel counts 32 and 24x20, so the in-plane bounds differ from
  the plane count), both filters, both march signs, with the outer stencil
  rows engaged (asserted).
- ``smooth_dd_transpose`` equals ``slab_bwd_kernel._smooth_dd_transpose``
  bit for bit on native and subsampled planes: every plain row is a sum of
  its contributions in the same order.
- ``voxel_grad`` (the plain B3/B4) against the TPU's ``_voxel_grad_kernel``
  and ``_voxel_grad_shaded_kernel`` under the emulator, on the same table
  and cotangents, by the repo rule (``parity.check_close``): the TPU
  contracts hat matrices in a bf16 split (``kernel_dot``), good to ~2^-16
  of each product.

The forward render with smoothing is held in ``test_torch_smooth_render``.
"""

import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.pallas_emu import emulate
from volym_tpu.ops import slab_bwd_kernel, slab_kernel
from volym_tpu.render import slab as jslab
from volym_tpu_torch import Camera, RenderParams, convert, parity
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.render import rays, slab

CSRC = Path(__file__).resolve().parents[1] / "volym_tpu_torch" / "ops" / "csrc"
H, W = 16, 24
#: orbits whose views march with sign +1 and -1
SIGN_ORBITS = [(30.0, 20.0), (210.0, 20.0)]


@pytest.mark.parametrize("side", [16, 64, 256, 512])
def test_resolve_planes_matches_jax(side):
    steps = [0.0, 0.001, 0.002, 0.003, 0.004, 0.005, 0.0075, 0.01, 0.015, 0.02, 0.04, 0.08, 0.2]
    for smoothing in (False, True):
        for step in steps:
            pj = vj.RenderParams(use_gaussian_smoothing=smoothing, raymarching_step_size=step)
            assert slab.resolve_planes(convert.render_params(pj), side) == jslab.resolve_planes(pj, side), (
                side, step, smoothing)
    p = RenderParams()
    assert slab.resolve_planes(p, 256) == 128
    assert slab.resolve_planes(p.replace(raymarching_step_size=0.002), 512) == 296


def test_kernel_constants_are_the_python_ones():
    """csrc/slab_common.cuh's stencil constants: the halo and the float32
    tap offsets and weights of ``slab.GAUSS_TAPS``."""
    src = (CSRC / "slab_common.cuh").read_text()
    assert int(re.search(r"SMOOTH_HALO = (\d+);", src).group(1)) == slab.SMOOTH_HALO
    assert int(re.search(r"GAUSS_TAPS = (\d+);", src).group(1)) == len(slab.GAUSS_TAPS)

    def literals(fn):
        body = re.search(fn + r"\(int i\) \{(.*?)\n\}", src, re.S).group(1)
        return [float.fromhex(s[:-1]) if s.startswith(("0x", "-0x")) else float(s[:-1])
                for s in re.findall(r"-?(?:0x[0-9a-f.]+p-?\d+|\d+\.\d+)f", body)]

    assert literals("gauss_delta") == [d for d, _ in slab.GAUSS_TAPS]
    w = [w for _, w in slab.GAUSS_TAPS]
    assert literals("gauss_weight") == [w[0], w[1], w[2]]
    assert slab.SMOOTH_MAX_PLANES == 300


def _rays(h, v, planes, n_plane):
    """(origin, dirs, major, sign, the port's per-ray table) of an orbit."""
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    major, sign = slab.dominant_axis(cam)
    origin, dirs = rays.generate_rays(cam, H, W)
    entry, exit_ = rays.ray_box_intersection(origin, dirs)
    feats = slab_march.features_from_rays(origin, dirs, entry, exit_, planes, major, sign, n_plane=n_plane)
    return origin, dirs, major, sign, feats.reshape(slab.N_FEATURES, H, W)


def _reach(feats, planes, bilinear):
    """The outermost stencil row any ray's taps weigh (|offset| 0..3)."""
    u = 0.01 / feats[slab.F_TS].abs().double()
    far = float(u.max())
    return min(3, int(np.ceil(far)) if bilinear else int(np.floor(far + 0.5)))


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("planes,nr,nc", [(128, 32, 32), (256, 24, 20)])
@pytest.mark.parametrize("h,v", SIGN_ORBITS)
def test_smoothed_densities_match_jax_bitwise(h, v, planes, nr, nc, interp):
    rng = np.random.default_rng(11)
    vol = rng.uniform(0.0, 1.0, (planes, nr, nc)).astype(np.float32)
    origin, dirs, major, sign, feats = _rays(h, v, planes, nr)
    got = slab.smoothed_densities(feats, torch.from_numpy(vol), sign, RenderParams(interpolation=interp))
    assert tuple(got.shape) == (planes, H, W)
    with jax.disable_jit():
        want = jslab.smoothed_densities(
            jnp.asarray(vol), jnp.asarray(origin.numpy()), jnp.asarray(dirs.numpy()), major, sign,
            vj.RenderParams(interpolation=interp),
        )
    reach = _reach(feats, planes, interp == "trilinear")
    assert reach >= (2 if planes == 128 else 3) - (interp == "nearest"), f"outer rows not engaged (reach {reach})"
    np.testing.assert_array_equal(got.reshape(planes, -1).numpy(), np.asarray(want))


def test_smoothed_densities_refuse_too_many_planes():
    _, _, _, sign, feats = _rays(30.0, 20.0, 304, 16)
    with pytest.raises(NotImplementedError, match="300"):
        slab.smoothed_densities(feats, torch.zeros((304, 16, 16)), sign, RenderParams())


def _tpu_feats(feats):
    """The port's (N_FEATURES, H, W) table as the TPU's (1, 16, R) chunk (the
    rows share their indices; H * W = R here)."""
    f = feats.reshape(slab.N_FEATURES, -1).numpy()
    out = np.zeros((1, 16, f.shape[1]), np.float32)
    out[0, : slab.N_FEATURES] = f
    return jnp.asarray(out)


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("planes,nr", [(256, 256), (128, 256), (64, 24)])
@pytest.mark.parametrize("h,v", SIGN_ORBITS)
def test_smooth_dd_transpose_matches_jax_bitwise(h, v, planes, nr, interp):
    _, _, _, _, feats = _rays(h, v, planes, nr)
    rng = np.random.default_rng(5)
    dd = rng.normal(0.0, 1.0, (planes, H, W)).astype(np.float32)
    dd[rng.uniform(size=dd.shape) < 0.5] = 0.0
    bilinear = interp == "trilinear"
    got = slab.smooth_dd_transpose(feats, torch.from_numpy(dd), nr, nr, bilinear)
    with jax.disable_jit():
        want = slab_bwd_kernel._smooth_dd_transpose(
            _tpu_feats(feats), jnp.asarray(dd.reshape(1, planes, 1, H * W)), planes, bilinear, nr=nr, nc=nr
        )
    np.testing.assert_array_equal(got.numpy().reshape(planes, -1), np.asarray(want)[0, :, 0])
    assert float(got.abs().max()) > 0


def _tpu_scatter(feats, dd, n, nr, nc, sign, bilinear):
    """The TPU's B3 (dd (N, R)) or B4 (dd (N, 4, R)) under the emulator,
    on one 1024-ray chunk, as ``slab_bwd_kernel._backward_call`` launches
    it (full slices, no row window)."""
    sb = slab_kernel.SLAB_BATCH
    n_blocks = n // sb
    shaded = dd.ndim == 3
    dd4 = jnp.asarray(dd.reshape(1, n, 4 if shaded else 1, -1))
    phys = (lambda j, c: (j, 0, 0)) if sign > 0 else (lambda j, c: (n_blocks - 1 - j, 0, 0))
    phys_g = (lambda j, c: (0, j, 0, 0)) if sign > 0 else (lambda j, c: (0, n_blocks - 1 - j, 0, 0))
    kw = dict(bilinear=bilinear, nr=nr, nc=nc, slab_batch=sb, march_sign=sign, subtexel=8)
    with emulate(slab_kernel, slab_bwd_kernel):
        pl = slab_bwd_kernel.pl
        kernel = partial(slab_bwd_kernel._voxel_grad_shaded_kernel if shaded else slab_bwd_kernel._voxel_grad_kernel,
                         **kw)
        out_specs = pl.BlockSpec((sb, nr, nc), phys)
        out_shape = jax.ShapeDtypeStruct((n, nr, nc), jnp.float32)
        if shaded:
            out_specs = [out_specs, pl.BlockSpec((3, sb, nr, nc), phys_g)]
            out_shape = [out_shape, jax.ShapeDtypeStruct((3, n, nr, nc), jnp.float32)]
        res = pl.pallas_call(
            kernel, grid=(n_blocks, 1),
            in_specs=[pl.BlockSpec((1, 16, 1024), lambda j, c: (c, 0, 0)),
                      pl.BlockSpec((1, sb, 4 if shaded else 1, 1024), lambda j, c: (c, j, 0, 0))],
            out_specs=out_specs, out_shape=out_shape,
        )(_tpu_feats(feats), dd4)
    return [np.asarray(x) for x in res] if shaded else [np.asarray(res), None]


@pytest.mark.parametrize("shaded", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", SIGN_ORBITS)
def test_voxel_grad_matches_tpu_kernels(h, v, interp, shaded):
    """One 1024-ray chunk (32x32 rays), 16 planes of 16x16 texels."""
    n = nr = 16
    cam = Camera(aspect=1.0, distance=1.3).orbit(h, v, 0.0).matrices()
    major, sign = slab.dominant_axis(cam)
    origin, dirs = rays.generate_rays(cam, 32, 32)
    entry, exit_ = rays.ray_box_intersection(origin, dirs)
    feats = slab_march.features_from_rays(origin, dirs, entry, exit_, n, major, sign, n_plane=nr).reshape(-1, 32, 32)
    rng = np.random.default_rng(9)
    dd = rng.normal(0.0, 1.0, (n, 4, 32, 32) if shaded else (n, 32, 32)).astype(np.float32)
    dd[rng.uniform(size=dd.shape) < 0.6] = 0.0
    p = RenderParams(interpolation=interp)
    d_vol, d_grad = slab.voxel_grad(feats, torch.from_numpy(dd), (n, nr, nr), sign, p)
    want_vol, want_grad = _tpu_scatter(feats, dd.reshape(n, 4, -1) if shaded else dd.reshape(n, -1), n, nr, nr, sign,
                                       interp == "trilinear")
    assert float(np.abs(want_vol).max()) > 0
    parity.check_close(want_vol, d_vol, f"{interp} d_vol")
    if shaded:
        parity.check_close(want_grad, d_grad, f"{interp} d_grad")
    else:
        assert d_grad is None
