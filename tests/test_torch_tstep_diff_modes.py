"""volym_tpu_torch.render.diff with Gaussian smoothing (five density taps
a step) against volym_tpu.render.diff under eager JAX, and the coloring's
kink (C9): at importance 170/255 the red channel passes 0.75 of its
cotangent, as ``jnp.minimum`` does (the coloring cases against JAX:
``tests/test_torch_tstep_diff_coloring.py``)."""

import numpy as np
import torch

from test_torch_tstep_diff import BASE, RES
from tstep_common import camera, check_grads, check_image, cotangent, jax_vjp, lit, params, port_vjp, sphere
from volym_tpu.render import diff as jdiff
from volym_tpu_torch.render import diff, golden

KINK = np.float32(170.0 / 255.0)  # 1.5 * KINK == 1.0 exactly in float32


def test_gaussian_image_and_gradients_match_eager_jax():
    sj, st = sphere()
    _, mj, mt = camera(20.0, 15.0)
    pj, pt = params(**{**BASE, "use_gaussian_smoothing": True})
    w = cotangent(RES)
    img_j, want = jax_vjp(jdiff.render, sj, mj, pj, w, RES)
    img_t, got = port_vjp(diff.render, st, mt, pt, w, RES)
    assert lit(img_j) > 0.1
    check_image(img_j, img_t, "gaussian image")
    check_grads(want, got, "gaussian")


def test_kink_passes_half():
    """d red / d importance: 1.5 below the kink, 0 above it, and at it
    0.75 (``torch.minimum``), as ``jnp.minimum`` passes in ``diff.py``."""
    imp = torch.tensor(np.float32([169.0 / 255.0, KINK, 171.0 / 255.0]), requires_grad=True)
    assert float(imp[1].detach() * 1.5) == 1.0
    (g,) = torch.autograd.grad(golden.importance_to_color(imp)[:, 0].sum(), imp)
    np.testing.assert_array_equal(g.numpy(), np.float32([1.5, 0.75, 0.0]))
