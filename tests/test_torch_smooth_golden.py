"""The differentiable slab render of volym_tpu_torch under Gaussian smoothing
against volym_tpu's jnp golden ``volym_tpu.render.slab.render_diff``.

The numpy volume, LUT and loss weights of ``test_torch_diff`` go through the
port's ``render_diff`` on the CPU (the plain march, the plain replay's
per-step cotangents, the stencil's transpose and the plain scatter) and
through the golden, run eagerly (``jax.disable_jit``); the loss is
``sum(img * w)``, and the image, d_volume and d_lut are held to the repo's
knife-edge rule (``volym_tpu_torch.parity.check_close``), in the four
(filter x stream) combinations and shaded trilinear, at 16^3 (native 16
planes for u8, resampled 8 for f32).  This file runs a view that marches
with sign +1; ``test_torch_smooth_golden_neg`` runs the same cases on one
that marches with sign -1.
"""

import jax
import pytest

import volym_tpu as vj
from tests.test_torch_diff import DISTANCE, H, SIDE, W, check, inputs, jax_step, port_step  # noqa: F401
from volym_tpu.render import slab as jslab

#: (interpolation, stream, shading)
CASES = [("nearest", "u8", False), ("nearest", "f32", False), ("trilinear", "u8", False),
         ("trilinear", "f32", False), ("trilinear", "f32", True)]


def golden_case(inputs, h, v, interp, stream, shading):  # noqa: F811
    vol, lut, w = inputs
    pj = vj.RenderParams(
        use_gaussian_smoothing=True, camera_grads=False, u8_volume=True, use_shading=shading,
        interpolation=interp, density_threshold=0.15,
        raymarching_step_size=(1.0 if stream == "u8" else 2.0) / SIDE,
    )
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(h, v, 0.0).matrices()

    def render(v_, l_):
        return jslab.render_diff(vj.Scene(v_, jax.numpy.zeros_like(v_), l_), mj, pj, H, W)

    want = jax_step(render, vol, lut, w)
    check(want, port_step(vol, lut, w, mj, pj), f"{interp} {stream} shading={shading} view {jslab.dominant_axis(mj)}")


@pytest.mark.parametrize("interp,stream,shading", CASES)
def test_smoothed_render_diff_matches_golden(inputs, interp, stream, shading):  # noqa: F811
    golden_case(inputs, 30.0, 20.0, interp, stream, shading)
