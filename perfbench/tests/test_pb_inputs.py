"""The torch generators against the program's numpy stand-ins at a small side."""

import numpy as np
import pytest
import torch

from perfbench import inputs


def test_teapot_equals_the_repository_stand_in():
    from volym_tpu_torch import assets

    vol, labels, infos = assets.synthetic_teapot_segments(48)
    imp = assets.map_segments_to_importance(labels, infos)
    got_vol, got_imp = inputs.teapot_u8(48, "cpu")
    assert got_vol.shape == (48, 48, 48)
    assert np.array_equal(got_vol.numpy(), vol)
    assert np.array_equal(got_imp.numpy(), imp)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11])
def test_bonsai_has_the_stand_in_shape_and_occupancy(seed):
    from volym_tpu_torch import assets

    side = 48
    want = assets.synthetic_bonsai(side, seed % 1000)
    got = inputs.bonsai_u8(side, seed, seed, "cpu")
    assert got.shape == want.shape and got.dtype == torch.uint8
    for threshold in (0.12, 0.15):
        occ_want = float((want / 255.0 >= threshold).mean())
        occ_got = float((got.float() / 255.0 >= threshold).float().mean())
        assert occ_got == pytest.approx(occ_want, rel=0.35)


def test_the_same_seed_gives_the_same_volume_and_the_layout_stays():
    a = inputs.bonsai_u8(24, 0, 5, "cpu")
    assert torch.equal(a, inputs.bonsai_u8(24, 0, 5, "cpu"))
    b = inputs.bonsai_u8(24, 0, 6, "cpu")
    assert not torch.equal(a, b)
    assert float((a.float() - b.float()).abs().max()) <= 0.05 * 255 + 1  # the noise alone differs


def test_default_lut_equals_the_program_ramp():
    from volym_tpu_torch.transfer_function import TransferFunction

    assert np.array_equal(inputs.default_lut(), TransferFunction.default().build_lut())


def test_orbit_matrices_equal_the_program_camera():
    from volym_tpu_torch.camera import Camera

    cam = {"target": [0.5, 0.5, 0.5], "distance": 1.0, "fovy": 90.0, "znear": 0.01, "zfar": 1000.0}
    for az, el in ((0.0, 0.0), (37.0, -21.5), (271.0, 30.0)):
        want = Camera(aspect=4 / 3).orbit(az, el, 0.0).matrices()
        got = inputs.orbit_matrices(az, el, cam, 4 / 3)
        for k in ("view", "proj", "inverse_view_proj", "position"):
            assert np.array_equal(got[k], getattr(want, k).numpy())
