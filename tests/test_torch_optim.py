"""volym_tpu_torch.optim.fit_scene against the JAX package's fit_scene on
the same numpy inputs, a longer descent of the port alone, and the
checkpoints each package writes, read by the other.

The JAX side runs eagerly (``jax.disable_jit()``, which also turns the
JAX fit's jitted step eager), one fit a file: eager JAX dispatches every
primitive of the replay from Python, ~11 s a step on these 12^3 / 8x8
inputs after ~25 s of first calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volym_tpu as vj
from volym_tpu import io as jio
from volym_tpu.optim import fit_scene as jax_fit_scene
from volym_tpu_torch import Camera, Scene, convert
from volym_tpu_torch import io as vio
from volym_tpu_torch.optim import LEAVES, fit_scene, l2_image_loss
from volym_tpu_torch.render import golden

# tests/test_optim_io.py's inverse problem: no density threshold (every
# sample differentiable), trilinear, unshaded, unsmoothed, fixed steps of .05
FIT_PARAMS = vj.RenderParams(
    use_gaussian_smoothing=False, adaptive_stepping=False, raymarching_step_size=0.05, interpolation="trilinear",
    use_shading=False, max_steps=40, density_threshold=0.0,
)
SIDE, RES, STEPS = 12, 8, 3
#: Each Adam update is lr * m_hat / (sqrt(v_hat) + eps): on the first step
#: about lr * sign(g) for every voxel a ray reaches, so a gradient that the
#: two packages round differently moves a leaf by a fraction of lr of that
#: rounding's relative size (~1e-5 seen on a voxel, 2e-7 on the LUT).  The
#: leaves are held to LEAF_ATOL (2e-3 of the learning rate) but for at most
#: KNIFE_EDGE entries (BASELINE.md's count at 64^3), each within
#: 2 lr a step (a gradient near zero whose sign differs); the losses to
#: LOSS_RTOL.
LEAF_ATOL = 2e-5
KNIFE_EDGE = 8
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def problem():
    """(JAX init scene, JAX camera matrices, target image as numpy): the
    sphere at 12^3, 8x8 rays, a flat 0.2 init.  The target is the port's
    golden frame of the sphere (the port's golden equals eager JAX's to the
    ulp: tests/test_torch_tstep_golden.py)."""
    target_scene = vj.Scene.synthetic("sphere", side=SIDE)
    mj = vj.Camera(aspect=1.0, distance=1.1).orbit(15.0, 10.0, 0.0).matrices()
    target = golden.render(convert.scene_from_jax(target_scene), convert.camera_matrices_from_jax(mj),
                           convert.render_params(FIT_PARAMS), RES, RES).numpy()
    init = vj.Scene(volume=jnp.full_like(target_scene.volume, 0.2), importance=target_scene.importance,
                    tf_lut=target_scene.tf_lut)
    return init, mj, target


def test_fit_scene_matches_jax(problem):
    init, mj, target = problem
    with jax.disable_jit():
        want = jax_fit_scene(init, mj, target, FIT_PARAMS, steps=STEPS, optimize=("volume", "tf_lut"))
    seen = []
    got = fit_scene(convert.scene_from_jax(init), convert.camera_matrices_from_jax(mj), target,
                    convert.render_params(FIT_PARAMS), steps=STEPS, optimize=("volume", "tf_lut"),
                    callback=lambda i, loss: seen.append((i, loss)))
    assert seen == list(enumerate(got.losses))
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL, atol=0)
    assert got.losses[-1] < got.losses[0]
    for name in ("volume", "tf_lut"):
        a, b = np.asarray(getattr(want.scene, name)), getattr(got.scene, name).numpy()
        err = np.abs(a - b)
        off = err > LEAF_ATOL
        assert off.sum() <= KNIFE_EDGE and err.max() <= 2 * 1e-2 * STEPS, (name, int(off.sum()), err.max())
        assert b.min() >= 0.0 and b.max() <= 1.0
        # the leaves moved: a fit that did nothing would pass the rule
        assert np.abs(b - np.asarray(getattr(init, name))).max() > 1e-3
    np.testing.assert_array_equal(got.scene.importance.numpy(), np.asarray(init.importance))


def test_fit_volume_reduces_loss(problem):
    """The port alone, as tests/test_optim_io.py's descent: 40 steps of the
    volume at lr 5e-2 halve the loss, the volume stays in [0, 1], and the
    result holds detached tensors while the input scene is untouched."""
    init, mj, target = problem
    scene = convert.scene_from_jax(init)
    before = scene.volume.clone()
    res = fit_scene(scene, convert.camera_matrices_from_jax(mj), torch.from_numpy(target),
                    convert.render_params(FIT_PARAMS), steps=40, learning_rate=5e-2, optimize=("volume",))
    assert res.losses[-1] < res.losses[0] * 0.5, res.losses[:3] + res.losses[-3:]
    v = res.scene.volume
    assert float(v.min()) >= 0.0 and float(v.max()) <= 1.0
    assert not v.requires_grad and res.scene.tf_lut is scene.tf_lut
    assert torch.equal(scene.volume, before)


def test_fit_forces_the_f32_stream_and_any_leaf_subset():
    """``u8_volume`` is cleared (a fitted volume leaves the u8 grid), and
    every subset of the leaves trains: the importance too, under coloring."""
    scene = Scene.synthetic("teapot", side=8)
    cm = Camera(distance=1.1).orbit(30.0, 20.0, 0.0).matrices()
    p = convert.render_params(FIT_PARAMS).replace(use_importance_coloring=True, u8_volume=True)
    target = golden.render(scene, cm, p, 6, 6) * 0.5
    res = fit_scene(scene, cm, target, p, steps=2, optimize=LEAVES, loss_fn=l2_image_loss)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert float((res.scene.importance - scene.importance).abs().max()) > 0
    assert res.scene.volume_u8 is None


def test_checkpoints_read_across(tmp_path):
    rng = np.random.default_rng(0)
    vol, lut = rng.random((4, 5, 6), dtype=np.float32), rng.random((256, 4), dtype=np.float32)
    # the JAX package writes, the port reads
    jio.save_checkpoint(tmp_path / "jax.npz", {"volume": jnp.asarray(vol), "tf_lut": jnp.asarray(lut)})
    back = vio.load_checkpoint(tmp_path / "jax.npz")
    assert set(back) == {"volume", "tf_lut"}
    np.testing.assert_array_equal(back["volume"], vol)
    np.testing.assert_array_equal(back["tf_lut"], lut)
    # the port writes tensors (one with a gradient), the JAX package reads
    vio.save_checkpoint(tmp_path / "port.npz", {"volume": torch.from_numpy(vol).requires_grad_(True),
                                                 "tf_lut": torch.from_numpy(lut), "note": np.arange(3)})
    back = jio.load_checkpoint(tmp_path / "port.npz")
    assert set(back) == {"volume", "tf_lut", "note"}
    np.testing.assert_array_equal(back["volume"], vol)
    np.testing.assert_array_equal(back["tf_lut"], lut)
    assert back["volume"].dtype == np.float32
    np.testing.assert_array_equal(vio.load_checkpoint(tmp_path / "port.npz")["note"], np.arange(3))
