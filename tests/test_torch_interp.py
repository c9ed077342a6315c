"""volym_tpu_torch.ops.interp (the t-step renderers' samplers and their
transposes) against volym_tpu.ops.interp under eager JAX, on the same
numpy grids and positions inside and outside the unit box."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volym_tpu.ops import interp as jinterp
from volym_tpu_torch.ops import interp

SHAPE = (5, 6, 7)  # (D, H, W): three sizes, so a swapped axis shows


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    grid = rng.uniform(0.0, 1.0, SHAPE).astype(np.float32)
    pos = rng.uniform(-0.3, 1.3, (40, 3)).astype(np.float32)
    # on the faces, the corners, and texel centres and edges exactly
    n = np.array([SHAPE[2], SHAPE[1], SHAPE[0]], np.float32)
    edges = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [1.0, 0.0, 0.25]], np.float32)
    centres = ((np.array([[0, 0, 0], [3, 2, 1], [6, 5, 4]], np.float32) + 0.5) / n).astype(np.float32)
    on_edges = (np.array([[1, 2, 3], [2, 3, 4]], np.float32) / n).astype(np.float32)
    pos = np.concatenate([pos, edges, centres, on_edges]).reshape(7, 7, 3)
    g = rng.standard_normal(pos.shape[:-1]).astype(np.float32)
    return grid, pos, g


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("name", ["sample_nearest", "sample_trilinear"])
def test_sampler_matches_jax(inputs, name):
    grid, pos, _ = inputs
    with jax.disable_jit():
        want = np.asarray(getattr(jinterp, name)(jnp.asarray(grid), jnp.asarray(pos)))
    got = getattr(interp, name)(_t(grid), _t(pos)).numpy()
    assert got.shape == want.shape == pos.shape[:-1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("into", [False, True], ids=["fresh", "into"])
@pytest.mark.parametrize("name", ["nearest", "trilinear"])
def test_scatter_matches_jax(inputs, name, into):
    grid, pos, g = inputs
    acc0 = np.full(SHAPE, 0.25, np.float32) if into else np.zeros(SHAPE, np.float32)
    with jax.disable_jit():
        if into:
            want = np.asarray(getattr(jinterp, f"scatter_{name}_into")(jnp.asarray(acc0), jnp.asarray(pos),
                                                                       jnp.asarray(g)))
        else:
            want = np.asarray(getattr(jinterp, f"scatter_{name}")(SHAPE, jnp.asarray(pos), jnp.asarray(g)))
    if into:
        acc = _t(acc0)
        got = getattr(interp, f"scatter_{name}_into")(acc, _t(pos), _t(g))
        assert got is acc  # accumulated in place
    else:
        got = getattr(interp, f"scatter_{name}")(SHAPE, _t(pos), _t(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", ["nearest", "trilinear"])
def test_scatter_is_the_samplers_transpose(inputs, name):
    """<scatter(g), v> == <g, sample(v)> for a random grid v: the scatter
    is the sampler's transpose in the grid."""
    grid, pos, g = inputs
    lhs = float((getattr(interp, f"scatter_{name}")(SHAPE, _t(pos), _t(g)).double() * _t(grid).double()).sum())
    rhs = float((_t(g).double() * getattr(interp, f"sample_{name}")(_t(grid), _t(pos)).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(rhs))


def test_trilinear_position_gradient_matches_jax(inputs):
    """The trilinear sample's gradient in the positions (the camera chain of
    the replay backward) against ``jax.vjp``."""
    grid, pos, g = inputs
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda p: jinterp.sample_trilinear(jnp.asarray(grid), p), jnp.asarray(pos))
        (want,) = vjp(jnp.asarray(g))
    p = _t(pos).requires_grad_(True)
    (got,) = torch.autograd.grad(interp.sample_trilinear(_t(grid), p), p, _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_make_sampler_and_scatter_select_by_interpolation():
    assert interp.make_sampler("nearest") is interp.sample_nearest
    assert interp.make_sampler("trilinear") is interp.sample_trilinear
    assert interp.make_scatter_into("nearest") is interp.scatter_nearest_into
    assert interp.make_scatter_into("trilinear") is interp.scatter_trilinear_into
    with pytest.raises(ValueError):
        interp.make_sampler("cubic")
