"""volym_tpu_torch.render.diff shaded (the central-difference taps and
Blinn-Phong's eye vector in the replay's vector-Jacobian product) against
volym_tpu.render.diff under eager JAX, trilinear and nearest (whose camera
gradient comes from the shading's eye vector and the entry alone: nearest
sampling is piecewise constant in the positions)."""

import numpy as np
import pytest

from test_torch_tstep_diff import BASE, RES
from tstep_common import camera, check_grads, check_image, cotangent, jax_vjp, lit, params, port_vjp, sphere
from volym_tpu.render import diff as jdiff
from volym_tpu_torch.render import diff


@pytest.mark.parametrize("interpolation", ["trilinear", "nearest"])
def test_shaded_image_and_gradients_match_eager_jax(interpolation):
    sj, st = sphere()
    _, mj, mt = camera(20.0, 15.0)
    pj, pt = params(**{**BASE, "use_shading": True, "interpolation": interpolation})
    w = cotangent(RES)
    img_j, want = jax_vjp(jdiff.render, sj, mj, pj, w, RES)
    img_t, got = port_vjp(diff.render, st, mt, pt, w, RES)
    assert lit(img_j) > 0.1
    check_image(img_j, img_t, f"{interpolation} image")
    assert np.abs(want["volume"]).max() > 0 and np.abs(want["position"]).max() > 0
    check_grads(want, got, interpolation)
