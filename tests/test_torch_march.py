"""The plain slab march of volym_tpu_torch against volym_tpu's jnp golden.

Every (major axis, sign) view x {nearest, trilinear} x {native planes,
resampled planes}, unshaded here and shaded in ``test_torch_march_shaded``.
Both sides get the same numpy volume and LUT (made from a seed) through
``volym_tpu_torch.convert``.  The golden runs eagerly (``jax.disable_jit``):
XLA's CPU fusion contracts multiply-adds into FMAs and moves ray
coordinates by an ulp, which the subtexel snap turns into texel flips;
eager JAX rounds op by op, as PyTorch does.  The port's ray directions
equal eager JAX's bit for bit (``test_torch_rays``): its square roots are
correctly rounded, as JAX's are, where ``torch.sqrt`` on float32 CPU
tensors is not (``volym_tpu_torch.render.rays.sqrt_rn``), so no ray's
subtexel snap hangs on the last bit.  Tolerance: the repo's knife-edge rule
(``volym_tpu_torch.parity.check_close``).
"""

import jax
import numpy as np
import pytest

import volym_tpu as vj
from volym_tpu.render import slab as jslab
from volym_tpu_torch import convert, parity
from volym_tpu_torch.render import slab

SIDE = 16
H, W = 24, 32
ORBITS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]
#: native (16 planes) and resampled (step 1/8 -> 8 planes)
STEPS = [1.0 / SIDE, 2.0 / SIDE]


def make_scene(seed=7):
    """A u8-representable noise volume and a LUT with moderate alpha, so
    rays run deep before they saturate."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 170, (SIDE, SIDE, SIDE)).astype(np.float32) / np.float32(255.0)
    lut = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut[:, 3] *= 0.4
    imp = np.zeros_like(vol)
    return vj.Scene(volume=vol, importance=imp, tf_lut=lut), convert.scene(vol, imp, lut)


def compare(h, v, interp, step, shading):
    sj, st = make_scene()
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    pj = vj.RenderParams(
        use_gaussian_smoothing=False, use_shading=shading, interpolation=interp,
        raymarching_step_size=step, density_threshold=0.12,
    )
    with jax.disable_jit():
        want = np.asarray(jslab.render(sj, mj, pj, H, W))
    got = slab.render(st, convert.camera_matrices_from_jax(mj), convert.render_params(pj), H, W)
    assert got.shape == (H, W, 4)
    assert np.abs(want[..., 3]).max() > 0.5
    parity.check_close(want, got.numpy(), f"view {jslab.dominant_axis(mj)} {interp} step {step}")


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_march_matches_golden(h, v, interp, step):
    compare(h, v, interp, step, shading=False)
