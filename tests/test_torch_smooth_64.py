"""Gaussian smoothing at 64^3 with nearest sampling, against volym_tpu's
jnp golden: the forward image and the differentiable render's image,
d_volume and d_lut.

At 16^3 the nearest taps are the identity (|u| = 0.01 * N * |d_m| < 0.5);
at 64 native planes they reach the neighbouring rows for rays with
|d_m| >= 0.78, so the stencil, its transpose and the scatters run with the
box hats engaged.  The JAX side runs eagerly (``jax.disable_jit``);
tolerance: the repo's knife-edge rule (``volym_tpu_torch.parity``).
"""

import jax
import numpy as np

import volym_tpu as vj
from tests.test_torch_diff import DISTANCE, H, W, check, jax_step, port_step
from volym_tpu.render import slab as jslab
from volym_tpu_torch import convert, parity
from volym_tpu_torch.render import slab


def test_smoothed_render_nearest_64_engages():
    """The image against the jnp golden, and smoothing changes it."""
    sj = vj.Scene.synthetic("bonsai", side=64, seed=3)
    st = convert.scene_from_jax(sj)
    pj = vj.RenderParams(use_gaussian_smoothing=True, interpolation="nearest", use_shading=True, u8_volume=True,
                         raymarching_step_size=1.0 / 64, density_threshold=0.12)
    mj = vj.Camera(aspect=W / H, distance=1.2).orbit(20.0, 15.0, 0.0).matrices()
    with jax.disable_jit():
        want = np.asarray(jslab.render(sj, mj, pj, H, W))
    pt = convert.render_params(pj)
    mt = convert.camera_matrices_from_jax(mj)
    got = slab.render(st, mt, pt, H, W)
    assert float((got - slab.render(st, mt, pt.replace(use_gaussian_smoothing=False), H, W)).abs().max()) > 1e-3
    parity.check_close(want, got, "64^3 nearest")


def test_smoothed_render_diff_nearest_64_matches_golden():
    """64 native planes: the nearest taps reach rows +-1."""
    rng = np.random.default_rng(8)
    side = 64
    vol = rng.integers(0, 170, (side, side, side)).astype(np.float32) / np.float32(255.0)
    lut = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut[:, 3] *= 0.4
    w = rng.uniform(-1.0, 1.0, (H, W, 4)).astype(np.float32)
    pj = vj.RenderParams(use_gaussian_smoothing=True, camera_grads=False, u8_volume=True, use_shading=False,
                         interpolation="nearest", density_threshold=0.15, raymarching_step_size=1.0 / side)
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(20.0, 15.0, 0.0).matrices()

    def render(v_, l_):
        return jslab.render_diff(vj.Scene(v_, jax.numpy.zeros_like(v_), l_), mj, pj, H, W)

    want = jax_step(render, vol, lut, w)
    check(want, port_step(vol, lut, w, mj, pj), "64^3 nearest")
