"""volym_tpu_torch.render.golden (the t-step golden march) against
volym_tpu.render.golden under eager JAX in every mode, and against the
per-pixel scalar transcription of the reference kernel
(``tests/reference_scalar.py``)."""

import numpy as np
import pytest
import torch

from reference_scalar import render_scalar
from tstep_common import camera, check_image, eager, lit, params, teapot
from volym_tpu.render import golden as jgolden
from volym_tpu_torch.render import golden

RES = 16
#: bounds the eager JAX march (C8); at step .05 the adaptive march's
#: smallest step is .0125, so 32 steps reach at least 0.4 into the box
MAX_STEPS = 32

CASES = {
    "base": dict(use_gaussian_smoothing=False),
    "first_hit": dict(use_gaussian_smoothing=False, use_opacity=False),
    "unshaded_fixed_step": dict(use_gaussian_smoothing=False, use_shading=False, adaptive_stepping=False),
    "trilinear_gaussian": dict(interpolation="trilinear"),
}
#: the look-ahead and coloring modes (tests/test_torch_tstep_golden_modes.py)
MODES = {
    "straight_ahead4": dict(use_gaussian_smoothing=False, use_importance_rendering=True,
                            importance_check_ahead_steps=4),
    "cone_ahead4": dict(use_gaussian_smoothing=False, use_importance_rendering=True,
                        use_cone_importance_check=True, importance_check_ahead_steps=4),
    "coloring": dict(use_gaussian_smoothing=False, use_importance_coloring=True),
}


@pytest.fixture(scope="module")
def scenes():
    return teapot()


@pytest.mark.parametrize("name", list(CASES))
def test_golden_matches_eager_jax(scenes, name):
    sj, st = scenes
    _, mj, mt = camera()
    pj, pt = params(raymarching_step_size=0.05, max_steps=MAX_STEPS, **CASES[name])
    want = eager(jgolden.render, sj, mj, pj, RES, RES)
    got = golden.render(st, mt, pt, RES, RES)
    assert tuple(got.shape) == (RES, RES, 4) and got.dtype == torch.float32
    assert lit(want) > 0.1, "the camera misses the volume"
    check_image(want, got, name)


@pytest.mark.parametrize("name", ["base", "trilinear_gaussian", "straight_ahead4", "coloring"])
def test_golden_matches_scalar_reference(scenes, name):
    """The port against the per-pixel numpy oracle on the JAX package's
    rule for it (``tests/test_golden_vs_scalar.py``): at most 5% of the
    pixels off by more than 2e-3 (knife-edge flips of nearest sampling and
    central differences), the guard against a black frame."""
    sj, st = scenes
    cam, _, mt = camera()
    pj, pt = params(raymarching_step_size=0.03, **{**CASES, **MODES}[name])
    expect = render_scalar(np.asarray(sj.volume), np.asarray(sj.importance), np.asarray(sj.tf_lut), cam, pj, 8, 8)
    got = golden.render(st, mt, pt, 8, 8).numpy()
    assert lit(expect) > 0.1
    err = np.abs(got - expect).max(-1)
    assert (err > 2e-3).mean() <= 0.05, f"max err {err.max():.4f}"


def test_miss_paints_black_opaque():
    from volym_tpu_torch import RenderParams, Scene, camera_matrices

    scene = Scene.synthetic("sphere", side=8)
    # a camera outside the box that looks away from it
    cam = camera_matrices((0.5, 0.5, -5.0), (0.5, 0.5, -10.0), (0.0, 1.0, 0.0), 90.0, 1.0, 0.01, 1000.0)
    img = golden.render(scene, cam, RenderParams(use_gaussian_smoothing=False), 4, 4).numpy()
    np.testing.assert_array_equal(img, np.broadcast_to(np.float32([0, 0, 0, 1]), (4, 4, 4)))
