"""The look-ahead backward in the CLI-default configuration (nearest,
shaded, resampled f32 planes) against the TPU kernels: the cases of
``test_torch_lookahead_diff`` (straight with smoothing, cone without),
held by ``test_torch_diff``'s rule for this configuration (bulk 1e-3, edge
share 5e-3: on resampled planes the emulated TPU kernel departs from its
own jnp golden, as named there; measured here up to 4.8e-4 of the scale,
in d_lut)."""

import pytest

from tests.test_torch_lookahead_diff import SIGN_ORBITS, gated_case, inputs  # noqa: F401


@pytest.mark.parametrize("cone,smooth,orbit", [(False, True, SIGN_ORBITS[0]), (True, False, SIGN_ORBITS[1])])
def test_gated_render_diff_matches_tpu_kernels_cli(inputs, monkeypatch, cone, smooth, orbit):  # noqa: F811
    gated_case(inputs, monkeypatch, "cli", cone, smooth, orbit)
