"""Camera gradients of the look-ahead backward: the port's ``render_diff``
with ``camera_grads=True`` (the default; f32 planes, the re-sampled replay
with its camera chain and, under trilinear smoothing, the plain rows'
chain, all gated) against ``jax.grad`` of the emulated TPU kernels'
``_render_pallas_diff_jit`` with respect to its ``CameraMatrices``, on the
scene and loss of ``test_torch_lookahead_diff``, at native planes (on
resampled planes the emulated TPU kernel departs from its own jnp golden,
``test_torch_diff``).

The camera leaves ``inverse_view_proj`` and ``position`` and the image are
held to the repo's rule (``parity.check_camera_grad``: bulk 2e-4 of each
leaf's scale).  d_volume and d_lut (by the two-group rule) are held to bulk
1e-3: with camera gradients (the f32 stream, the re-sampled replay) the
port departs from the emulated TPU kernel by 2.6e-4..3.1e-4 of the scale
in d_volume and 1.5e-4..4.9e-4 in d_lut without the gate, and by
1.7e-4..3.1e-4 and 2.3e-4 with it (measured on this scene in these two
cases), where the gate's own cases without camera gradients
(``test_torch_lookahead_diff``) agree within 2e-4.
"""

import numpy as np
import pytest

import volym_tpu as vj
from tests.test_torch_diff import DISTANCE, H, SIDE, W
from tests.test_torch_lookahead_diff import inputs, pallas_step, params, port_step  # noqa: F401
from volym_tpu_torch import convert, parity

LEAVES = ("view", "proj", "inverse_view_proj", "position")


@pytest.mark.parametrize("cone,smooth,orbit", [(False, True, (30.0, 20.0)), (True, False, (210.0, 20.0))])
def test_gated_camera_grads_match_tpu_kernels(inputs, cone, smooth, orbit):  # noqa: F811
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(*orbit, 0.0).matrices()
    pj = params("bench", cone, smooth, camera_grads=True, raymarching_step_size=1.0 / SIDE)
    label = f"cone={cone} smoothing={smooth}"
    want = pallas_step(inputs, mj, pj, wrt_camera=True)
    got = port_step(inputs, mj, pj, LEAVES)
    cam = {name: np.asarray(getattr(want[4], name)) for name in LEAVES}
    assert np.abs(cam["position"]).max() > 0 and got[3] is None
    assert got[4]["view"] is None and got[4]["proj"] is None
    parity.check_close(want[0], got[0], f"{label} image")
    parity.check_camera_grad(cam, got[4], label)
    parity.check_close(want[1], got[1], f"{label} d_volume", bulk=1e-3)
    parity.check_lut_grad(want[2], got[2], convert.scene(*inputs[:3]).tf_lut, f"{label} d_lut", bulk=1e-3)
