"""Importance coloring's camera gradients: the port's ``render_diff`` with
``camera_grads=True`` (f32 planes, the re-sampled replay's camera chain in
coloring mode: F_AEXP, the half vector and, shaded with trilinear
sampling, the gradient field's coordinates; nothing through the
box-sampled importance or the density) against ``jax.grad`` of the
emulated TPU kernels' ``_render_pallas_diff_jit`` with respect to its
``CameraMatrices``, on the scene and loss of ``test_torch_coloring_diff``
at native planes.  The camera leaves and the image are held to the repo's
rule (``parity.check_camera_grad``), d_importance and (shaded) d_volume to
bulk 1e-3, as the camera-mode gradients of ``test_torch_lookahead_camera``
are (the f32 stream and the re-sampled replay against the emulated TPU
kernel).
"""

import numpy as np
import pytest

import volym_tpu as vj
from tests.test_torch_coloring import H, W, coloring_params
from tests.test_torch_coloring_diff import check_coloring_step, inputs  # noqa: F401
from tests.test_torch_diff import DISTANCE
from tests.test_torch_lookahead_diff import pallas_step, port_step
from volym_tpu_torch import parity

LEAVES = ("view", "proj", "inverse_view_proj", "position")


@pytest.mark.parametrize("interp,shading,smooth,orbit", [("trilinear", True, True, (30.0, 20.0)),
                                                          ("nearest", False, False, (210.0, 20.0))])
def test_coloring_camera_grads_match_tpu_kernels(inputs, interp, shading, smooth, orbit):  # noqa: F811
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(*orbit, 0.0).matrices()
    pj = coloring_params(interp, "u8", shading, smooth)
    assert pj.camera_grads
    label = f"{interp} shading={shading} smoothing={smooth}"
    want = pallas_step(inputs, mj, pj, wrt_camera=True)
    got = port_step(inputs, mj, pj, LEAVES)
    cam = {name: np.asarray(getattr(want[4], name)) for name in LEAVES}
    assert np.abs(cam["position"]).max() > 0 and got[4]["view"] is None and got[4]["proj"] is None
    parity.check_camera_grad(cam, got[4], label)
    check_coloring_step(want[:4], got[:4], shading, label, bulk=1e-3)
