"""volym_tpu_torch.render.diff at the TF LUT's opaque end (C11 in
``ROADMAP.md``): below a step of .01 the opacity correction's exponent
``100 step`` is below 1 and its derivative at alpha 1 infinite, so a step
masked off (here, after early termination) that samples alpha 1 makes the
JAX replay's gradients NaN (0 times infinity); the port's stay finite and
equal JAX's everywhere JAX's are finite."""

import numpy as np

import volym_tpu as vj
from test_torch_tstep_diff import BASE, RES
from tstep_common import camera, check_image, cotangent, jax_vjp, lit, params, port_vjp
from volym_tpu.render import diff as jdiff
from volym_tpu_torch import convert
from volym_tpu_torch.render import diff


def shell_scene(side=16):
    """A shell of density 153/255 (the default LUT's alpha 0.6: at a step
    of .008, 0.52 a step, opaque after four) 0.17 thick around a core of
    density 1 (alpha 1): every ray that reaches the core has terminated in
    the shell."""
    c = (np.arange(side) + 0.5) / side - 0.5
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    raw = np.where(r < 0.25, 255, np.where(r < 0.42, 153, 0))
    return vj.Scene.from_uint8(raw.astype(np.uint8))


def test_masked_steps_at_the_opaque_end_stay_finite():
    sj = shell_scene()
    st = convert.scene_from_jax(sj)
    _, mj, mt = camera(20.0, 15.0)
    # nearest sampling: a core sample is exactly 1, and so is its alpha;
    # 40 steps of .008 reach the core
    pj, pt = params(**{**BASE, "raymarching_step_size": 0.008, "max_steps": 40, "interpolation": "nearest"})
    w = cotangent(RES)
    img_j, want = jax_vjp(jdiff.render, sj, mj, pj, w, RES)
    img_t, got = port_vjp(diff.render, st, mt, pt, w, RES)
    assert lit(img_j) > 0.1
    check_image(img_j, img_t, "shell image")
    assert not np.isfinite(want["tf_lut"]).all()  # C11 in the JAX package
    for leaf in ("volume", "importance", "tf_lut", "inverse_view_proj", "position"):
        a, b = want[leaf], got[leaf]
        assert b is not None and np.isfinite(b).all(), leaf
        ok = np.isfinite(a)
        scale = max(float(np.abs(a[ok]).max()), 1e-6)
        assert float(np.abs(a[ok] - b[ok]).max()) <= 1e-4 * scale, leaf
    # the opaque end's alpha entry gets nothing from the masked steps
    assert got["tf_lut"][-1, 3] == 0.0
