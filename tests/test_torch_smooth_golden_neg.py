"""The cases of ``test_torch_smooth_golden`` (the smoothed ``render_diff``
of volym_tpu_torch against volym_tpu's jnp golden, by the repo's
knife-edge rule) on a view that marches with sign -1."""

import pytest

from tests.test_torch_diff import inputs  # noqa: F401
from tests.test_torch_smooth_golden import CASES, golden_case


@pytest.mark.parametrize("interp,stream,shading", CASES)
def test_smoothed_render_diff_matches_golden(inputs, interp, stream, shading):  # noqa: F811
    golden_case(inputs, 210.0, 20.0, interp, stream, shading)
