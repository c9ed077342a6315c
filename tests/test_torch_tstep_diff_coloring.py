"""volym_tpu_torch.render.diff with importance coloring (d_importance
through the nearest scatter) against volym_tpu.render.diff under eager JAX,
on the teapot and with every sample at the coloring's kink (C9)."""

import numpy as np
import pytest

from test_torch_tstep_diff import BASE, RES
from test_torch_tstep_diff_modes import KINK
from tstep_common import camera, check_grads, check_image, cotangent, jax_vjp, lit, params, port_vjp, teapot
from volym_tpu import Scene as JScene
from volym_tpu.render import diff as jdiff
from volym_tpu_torch import convert
from volym_tpu_torch.render import diff


@pytest.mark.parametrize("kink", [False, True], ids=["teapot", "importance_170"])
def test_coloring_image_and_gradients_match_eager_jax(kink):
    """Coloring on the teapot (importance from 0 to 1), and on its volume
    with importance 170/255 everywhere: every sample at the kink, where
    the port must pass JAX's 0.75 of d_r (the slab path's clamp would pass
    1.5)."""
    sj, _ = teapot()
    if kink:
        sj = JScene(sj.volume, np.full(np.shape(sj.importance), KINK), sj.tf_lut)
    st = convert.scene_from_jax(sj)
    _, mj, mt = camera()
    pj, pt = params(**{**BASE, "use_importance_coloring": True})
    w = cotangent(RES)
    img_j, want = jax_vjp(jdiff.render, sj, mj, pj, w, RES)
    img_t, got = port_vjp(diff.render, st, mt, pt, w, RES)
    assert lit(img_j) > 0.1
    check_image(img_j, img_t, "coloring image")
    assert np.abs(want["importance"]).max() > 0
    check_grads(want, got, f"coloring kink={kink}")
