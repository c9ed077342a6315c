"""The port's numpy UI helpers against the JAX package's:
``camera.CameraController``, ``TransferFunction.get``, ``quantize_lut``
and ``save_png`` (decoded with ``zlib``; the JAX package's PNG with PIL)."""

import numpy as np
import pytest
from PIL import Image

from test_torch_entry import read_png
from volym_tpu import camera as jcamera
from volym_tpu import transfer_function as jtf
from volym_tpu_torch import camera, transfer_function as tf


def _tfs():
    """The default TF and one with unsorted, uneven control points."""
    mine, theirs = [tf.TransferFunction.default()], [jtf.TransferFunction.default()]
    for mod, out in ((tf, mine), (jtf, theirs)):
        t = mod.TransferFunction(max_density=127)
        for c, iso in (((0.2, 0.9, 0.1, 0.0), 0.8), ((1.0, 0.0, 0.5, 0.3), 0.1), ((0.0, 0.3, 1.0, 0.9), 0.45)):
            t.add_rgb(mod.ControlPoint(c, iso))
            t.add_alpha(mod.ControlPoint(c, iso))
        out.append(t)
    return zip(mine, theirs)


def test_camera_controller_matches_jax():
    cam, jcam = camera.Camera(aspect=1.5), jcamera.Camera(aspect=1.5)
    ctl, jctl = camera.CameraController(), jcamera.CameraController(sensitivity=0.2)
    for dx, dy, wheel in ((10.0, -4.0, 1.0), (-300.0, 600.0, -80.0), (0.5, 0.25, 0.0), (0.0, 0.0, 0.0)):
        ctl.process_mouse(dx, dy)
        jctl.process_mouse(dx, dy)
        ctl.process_scroll(wheel)
        jctl.process_scroll(wheel)
        cam, jcam = ctl.update_camera(cam), jctl.update_camera(jcam)
        for f in ("horizontal_angle", "vertical_angle", "distance"):
            assert getattr(cam, f) == getattr(jcam, f), f
        np.testing.assert_array_equal(cam.position, jcam.position)
        assert (ctl.rotate_horizontal, ctl.rotate_vertical, ctl.scroll) == (0.0, 0.0, 0.0)
    assert cam.vertical_angle == -89.0 and cam.distance == 10.0  # clamped on the way


@pytest.mark.parametrize("value", [-0.5, 0.0, 0.1234, 0.5, 0.999, 1.0, 3.0])
def test_tf_get_matches_jax(value):
    for mine, theirs in _tfs():
        np.testing.assert_array_equal(mine.get(value), theirs.get(value))


def test_quantize_lut_matches_jax():
    rng = np.random.default_rng(3)
    lut = rng.uniform(-0.2, 1.2, (256, 4)).astype(np.float32)
    lut[:4] = [[0.0, 1.0, 1 / 255, 254.9 / 255]] * 4
    got = tf.quantize_lut(lut)
    np.testing.assert_array_equal(got, jtf.quantize_lut(lut))
    assert got.dtype == np.float32


def test_save_png_matches_jax(tmp_path):
    for i, (mine, theirs) in enumerate(_tfs()):
        tf.save_png(mine, tmp_path / f"mine{i}.png")
        jtf.save_png(theirs, tmp_path / f"theirs{i}.png")
        got = read_png(tmp_path / f"mine{i}.png")
        want = np.asarray(Image.open(tmp_path / f"theirs{i}.png"))
        assert got.shape == (1, mine.max_density + 1, 4)
        np.testing.assert_array_equal(got, want)
