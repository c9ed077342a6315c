"""volym_tpu_torch.render.golden's look-ahead (straight and cone, with the
probe count of the tests of the JAX package) and importance coloring
against volym_tpu.render.golden under eager JAX; each engages."""

import numpy as np
import pytest

from test_torch_tstep_golden import MAX_STEPS, MODES, RES
from tstep_common import camera, check_image, eager, lit, params, teapot
from volym_tpu.render import golden as jgolden
from volym_tpu_torch.render import golden


@pytest.fixture(scope="module")
def scenes():
    return teapot()


@pytest.mark.parametrize("name", list(MODES))
def test_mode_matches_eager_jax(scenes, name):
    sj, st = scenes
    _, mj, mt = camera()
    pj, pt = params(raymarching_step_size=0.05, max_steps=MAX_STEPS, **MODES[name])
    want = eager(jgolden.render, sj, mj, pj, RES, RES)
    got = golden.render(st, mt, pt, RES, RES)
    assert lit(want) > 0.1, "the camera misses the volume"
    check_image(want, got, name)


def test_look_ahead_and_coloring_engage(scenes):
    """Each mode changes the frame (else the cases above compare Base
    with itself), and the adaptive step changes it too."""
    _, st = scenes
    _, _, mt = camera()
    frames = {}
    for name, kw in [("base", {}), ("adaptive off", dict(adaptive_stepping=False))] + [
            (n, MODES[n]) for n in ("straight_ahead4", "cone_ahead4", "coloring")]:
        _, pt = params(raymarching_step_size=0.05, max_steps=MAX_STEPS, **{"use_gaussian_smoothing": False, **kw})
        frames[name] = golden.render(st, mt, pt, RES, RES).numpy()
    for name, img in frames.items():
        if name != "base":
            assert np.abs(img - frames["base"]).max() > 1e-3, name


