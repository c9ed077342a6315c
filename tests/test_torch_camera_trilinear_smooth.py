"""The smoothed trilinear cases of ``test_torch_camera`` (the camera
gradients of volym_tpu_torch's ``render_diff`` against ``jax.grad`` of
volym_tpu's jnp golden): the coordinate chains of the density, the plain
rows' (``slab.feats_grad``) and the stencil's tap offsets (F_TS)."""

import pytest

from tests.test_torch_camera import CASES, golden_case
from tests.test_torch_diff import inputs  # noqa: F401


@pytest.mark.parametrize("interp,shading,smooth,orbit", [c for c in CASES if c[0] == "trilinear" and c[2]])
def test_camera_grads_match_golden(inputs, interp, shading, smooth, orbit):  # noqa: F811
    golden_case(inputs, interp, shading, smooth, orbit)
