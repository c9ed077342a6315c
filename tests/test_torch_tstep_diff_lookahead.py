"""volym_tpu_torch.render.diff gated by the straight look-ahead against
volym_tpu.render.diff under eager JAX."""

from test_torch_tstep_diff import BASE, RES
from tstep_common import camera, check_grads, check_image, cotangent, jax_vjp, lit, params, port_vjp, teapot
from volym_tpu.render import diff as jdiff
from volym_tpu_torch.render import diff


def test_look_ahead_gated_gradients_match_eager_jax():
    """The straight look-ahead (4 probes) gates the replay as it gates the
    forward; the gate has no gradient."""
    sj, st = teapot()
    _, mj, mt = camera()
    pj, pt = params(**{**BASE, "use_importance_rendering": True, "importance_check_ahead_steps": 4})
    w = cotangent(RES)
    img_j, want = jax_vjp(jdiff.render, sj, mj, pj, w, RES)
    img_t, got = port_vjp(diff.render, st, mt, pt, w, RES)
    assert lit(img_j) > 0.1
    check_image(img_j, img_t, "look-ahead image")
    check_grads(want, got, "look-ahead")
