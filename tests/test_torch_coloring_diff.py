"""Importance coloring's backward: d_importance, d_volume and d_lut of
volym_tpu_torch's differentiable render against volym_tpu's TPU kernels.

The scene of ``test_torch_coloring`` (made from a seed, through
``convert.scene``) and a loss ``sum(img * w)`` go through the port's
``render_diff`` on the CPU (the plain march and replay in coloring mode:
d_imp = d_r * 1.5 * [1.5 imp < 1] - 1.2 d_g + d_a scattered with the
importance tap's box hat into the permuted grid, which autograd carries
back through the nearest gather and the permute to ``scene.importance``)
and through ``slab_kernel._render_pallas_diff_jit`` (``march_pallas_coloring``)
under the repo's Pallas emulator, eagerly.  The image and d_importance are
held to the repo's knife-edge rule; d_volume too when shaded (it comes
only through the gradient field), and it is exactly zero unshaded, as is
d_lut (the density only gates the threshold mask).  Native planes, both
filters, shaded and not, smoothing off and on, one view of each march sign;
the jnp golden's backward is held in ``test_torch_coloring_golden`` and
the camera gradients in ``test_torch_coloring_camera``.  The importance
includes 170/255, where 1.5 imp rounds to exactly 1.0: the port passes no
d_r there, as the TPU kernel's ``where(1.5 imp < 1, 1.5, 0)`` does.
"""

import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.test_torch_coloring import H, SIDE, W, coloring_params, coloring_scene
from tests.test_torch_diff import DISTANCE
from tests.test_torch_lookahead_diff import pallas_step, port_step
from volym_tpu.render import slab as jslab
from volym_tpu_torch import parity


@pytest.fixture(scope="module")
def inputs():
    w = np.random.default_rng(13).uniform(-1.0, 1.0, (H, W, 4)).astype(np.float32)
    return (*coloring_scene(), w)


def check_coloring_step(want, got, shading, label, bulk=2e-4):
    """Hold the port's (image, d_volume, d_lut, d_importance) to JAX's."""
    assert np.abs(want[3]).max() > 0, "no importance gradient"
    parity.check_close(want[0], got[0], f"{label} image", bulk=bulk)
    parity.check_close(want[3], got[3], f"{label} d_importance", bulk=bulk)
    assert not torch.any(got[2]) and not np.any(want[2]), "coloring has no LUT gradient"
    if shading:
        assert np.abs(want[1]).max() > 0
        parity.check_close(want[1], got[1], f"{label} d_volume", bulk=bulk)
    else:
        assert not torch.any(got[1]) and not np.any(want[1]), "unshaded coloring has no volume gradient"


#: (interpolation, shading, smoothing, orbit)
CASES = [("trilinear", False, False, (30.0, 20.0)), ("trilinear", True, True, (210.0, 20.0)),
         ("nearest", True, False, (120.0, 10.0)), ("nearest", False, True, (300.0, -10.0))]


@pytest.mark.parametrize("interp,shading,smooth,orbit", CASES)
def test_coloring_render_diff_matches_tpu_kernels(inputs, interp, shading, smooth, orbit):
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(*orbit, 0.0).matrices()
    pj = coloring_params(interp, "u8", shading, smooth, camera_grads=False)
    assert jslab.resolve_planes(pj, SIDE) == SIDE
    assert (inputs[1] == np.float32(170.0) / np.float32(255.0)).any()
    label = f"{interp} shading={shading} smoothing={smooth} view {jslab.dominant_axis(mj)}"
    check_coloring_step(pallas_step(inputs, mj, pj), port_step(inputs, mj, pj), shading, label)
