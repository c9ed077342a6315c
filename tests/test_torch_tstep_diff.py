"""volym_tpu_torch.render.diff (the fixed-step march with its replay
backward) against volym_tpu.render.diff under eager JAX: the image, and
the gradients of the volume, the importance, the TF LUT and the camera
matrices, on the same 16^3 sphere and 8x8 rays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstep_common import camera, check_grads, check_image, cotangent, jax_vjp, lit, params, port_vjp, sphere
from volym_tpu.render import diff as jdiff
from volym_tpu.render import rays as jrays
from volym_tpu_torch.render import diff, golden

RES = 8
#: bounds the eager JAX replay (C8): 12 fixed steps of .05 reach 0.6 into
#: the box
MAX_STEPS = 12
BASE = dict(use_gaussian_smoothing=False, adaptive_stepping=False, raymarching_step_size=0.05,
            interpolation="trilinear", use_shading=False, max_steps=MAX_STEPS)


@pytest.mark.parametrize("kw", [{}], ids=["trilinear"])
def test_image_and_gradients_match_eager_jax(kw):
    """The unshaded trilinear march, whose camera gradient runs through the
    samples' positions (the shaded cases: ``test_torch_tstep_diff_shaded.py``)."""
    sj, st = sphere()
    _, mj, mt = camera(20.0, 15.0)
    pj, pt = params(**{**BASE, **kw})
    w = cotangent(RES)
    img_j, want = jax_vjp(jdiff.render, sj, mj, pj, w, RES)
    img_t, got = port_vjp(diff.render, st, mt, pt, w, RES)
    assert lit(img_j) > 0.1
    check_image(img_j, img_t, f"{kw} image")
    assert np.abs(want["volume"]).max() > 0 and np.abs(want["position"]).max() > 0
    check_grads(want, got, str(kw))


def test_forward_is_golden_with_fixed_steps():
    """``diff.render``'s image is the golden's without adaptive stepping
    but for the opacity exponent (the step times 100 in double, not in
    float32): within 1e-6."""
    _, st = sphere()
    _, _, mt = camera(20.0, 15.0)
    _, pt = params(**{**BASE, "max_steps": None, "use_shading": True})
    want = golden.render(st, mt, pt, RES, RES)
    got = diff.render(st, mt, pt.replace(adaptive_stepping=True), RES, RES)
    assert lit(want.numpy()) > 0.1
    check_image(want.numpy(), got, "diff vs golden")


def test_first_hit_raises():
    _, st = sphere()
    _, _, mt = camera()
    _, pt = params(**{**BASE, "use_opacity": False})
    with pytest.raises(NotImplementedError, match="first-hit"):
        diff.render(st, mt, pt, RES, RES)
    diff.render(st, mt, pt.replace(use_importance_coloring=True), RES, RES)  # coloring still composites


def test_entry_gradient_matches_jax_and_is_finite_on_zero_components():
    """``diff.ray_box_intersection`` against the JAX package's: the values
    bit for bit; the entry's gradient equal where JAX's is finite, half at
    the tie of a camera on a face (``jnp.maximum``'s rule), and finite on
    a ray with a zero direction component, where JAX's is NaN (C6)."""
    rng = np.random.default_rng(3)
    dirs = rng.standard_normal((64, 3)).astype(np.float32)
    dirs[:4, 0] = 0.0  # zero components
    dirs[4:8, 2] = -np.abs(dirs[4:8, 2])  # into the box from the face z = 1
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g = rng.standard_normal(64).astype(np.float32)
    for origin in (np.float32([0.4, 0.6, 1.0]), np.float32([0.3, 1.7, -0.4])):
        with jax.disable_jit():
            (ej, xj), vjp = jax.vjp(jrays.ray_box_intersection, jnp.asarray(origin), jnp.asarray(dirs))
            dorigin_j, ddirs_j = (np.asarray(a) for a in vjp((jnp.asarray(g), jnp.zeros_like(xj))))
        o, d = torch.tensor(origin, requires_grad=True), torch.tensor(dirs, requires_grad=True)
        et, xt = diff.ray_box_intersection(o, d)
        np.testing.assert_array_equal(et.detach().numpy(), np.asarray(ej))
        np.testing.assert_array_equal(xt.detach().numpy(), np.asarray(xj))
        (et * torch.from_numpy(g)).sum().backward()
        assert torch.isfinite(o.grad).all() and torch.isfinite(d.grad).all()
        assert np.isnan(ddirs_j[:4]).any()  # C6 in JAX
        np.testing.assert_allclose(d.grad.numpy()[4:], ddirs_j[4:], rtol=1e-6, atol=1e-6)
        if origin[2] == 1.0:
            assert (np.asarray(ej)[4:8] == 0.0).all()  # the tie
            # 0.5 of the gradient passes the tie, in both
            np.testing.assert_allclose(d.grad.numpy()[4:8], ddirs_j[4:8], rtol=1e-6, atol=0)
