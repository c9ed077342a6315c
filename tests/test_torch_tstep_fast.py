"""volym_tpu_torch.render.fast (the early-exit t-step march, with the
params' floats or the knobs in a tensor) against the port's golden march
bit for bit in every mode, and against volym_tpu.render.fast under eager
JAX; the knob tensor and the step bounds against volym_tpu.config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstep_common import camera, check_image, eager, lit, params, teapot
from volym_tpu.render import fast as jfast
from volym_tpu_torch import RenderParams
from volym_tpu_torch.render import fast, golden
from volym_tpu_torch.render import rays as rays_mod

RES = 16
MODES = {
    "base": dict(use_gaussian_smoothing=False),
    "first_hit": dict(use_gaussian_smoothing=False, use_opacity=False),
    "unshaded_fixed_step": dict(use_gaussian_smoothing=False, use_shading=False, adaptive_stepping=False),
    "trilinear_gaussian": dict(interpolation="trilinear"),
    "straight_ahead4": dict(use_gaussian_smoothing=False, use_importance_rendering=True,
                            importance_check_ahead_steps=4),
    "cone_ahead4": dict(use_gaussian_smoothing=False, use_importance_rendering=True,
                        use_cone_importance_check=True, importance_check_ahead_steps=4),
    "coloring": dict(use_gaussian_smoothing=False, use_importance_coloring=True),
    "bench_preset": dict(density_threshold=0.15, use_gaussian_smoothing=False, importance_check_ahead_steps=15,
                         raymarching_step_size=0.02, use_importance_rendering=True),
}


@pytest.fixture(scope="module")
def scenes():
    return teapot()


def render_with_knob_tensor(scene, m, p, height, width, stats):
    """``fast.render`` with the float knobs in :meth:`RenderParams.split_dynamic`'s
    tensor, as the JAX package's ``fast.render`` passes them."""
    static, dyn = p.split_dynamic()
    origin, dirs = rays_mod.generate_rays(m, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    img = fast.march(scene, origin, dirs, entry, exit_, m.position, static, dyn=dyn, stats=stats)
    img = torch.where((exit_ <= entry)[:, None], golden.miss_color(img.device)[None, :], img)
    return img.reshape(height, width, 4)


RENDER = {"params": fast.render, "tensor": render_with_knob_tensor}


@pytest.mark.parametrize("knobs", list(RENDER))
@pytest.mark.parametrize("max_steps", [None, 16])
@pytest.mark.parametrize("name", list(MODES))
def test_fast_equals_golden(scenes, name, max_steps, knobs):
    """The early exit changes nothing: the extra masked steps of the last
    block are no-ops, and the knobs from the tensor equal the params'
    floats (the quarter step is exact in float32 and in double)."""
    _, st = scenes
    _, _, mt = camera()
    p = RenderParams(**{"raymarching_step_size": 0.05, "max_steps": max_steps, **MODES[name]})
    want = golden.render(st, mt, p, RES, RES)
    stats = {}
    got = RENDER[knobs](st, mt, p, RES, RES, stats=stats)
    assert torch.equal(want, got), name
    assert stats["steps"] <= stats["step_bound"]
    if max_steps is None:
        assert lit(want.numpy()) > 0.1
        # every ray ends before the worst case
        assert stats["steps"] < stats["step_bound"], stats


@pytest.mark.parametrize("kw", [
    dict(interpolation="trilinear", use_shading=False, max_steps=13),
    dict(use_importance_rendering=True, importance_check_ahead_steps=7, max_steps=24),
    dict(use_importance_rendering=True, use_cone_importance_check=True, importance_check_ahead_steps=5,
         early_termination_alpha=0.9, max_steps=24),
], ids=["trilinear_13_steps", "straight_ahead7", "cone_ahead5"])
@pytest.mark.parametrize("knobs", list(RENDER))
def test_fast_matches_eager_jax(scenes, kw, knobs):
    """Both paths against the JAX package's knob-tensor path: a probe count
    below ``AHEAD_CAP`` (probed as set, or masked in the tensor's 25), and
    a ``max_steps`` that is no multiple of the block (both run whole
    blocks: 16 steps for 13)."""
    sj, st = scenes
    _, mj, mt = camera()
    pj, pt = params(use_gaussian_smoothing=False, raymarching_step_size=0.05, **kw)
    want = eager(jfast.render, sj, mj, pj, RES, RES)
    stats = {}
    got = RENDER[knobs](st, mt, pt, RES, RES, stats=stats)
    assert lit(want) > 0.1
    check_image(want, got, str(kw))
    if kw["max_steps"] == 13:
        assert stats == dict(steps=16, step_bound=16)


@pytest.mark.parametrize("step", [0.005, 0.01, 0.02, 0.03, 0.05, 0.1, 1e-7])
@pytest.mark.parametrize("adaptive", [True, False])
def test_step_bounds_match_jax(step, adaptive):
    """``resolved_max_steps`` (double) and the knob tensor's bound (float32,
    ``fast.dynamic_step_bound``) are the JAX package's two numbers."""
    import volym_tpu as vj

    pj = vj.RenderParams(raymarching_step_size=step, adaptive_stepping=adaptive)
    pt = RenderParams(raymarching_step_size=step, adaptive_stepping=adaptive)
    assert pt.resolved_max_steps() == pj.resolved_max_steps()
    assert pt.min_step_size == pj.min_step_size
    static, dyn = pt.split_dynamic()
    with jax.disable_jit():
        _, jdyn = pj.split_dynamic()
        min_step = jdyn[1] * (0.25 if adaptive else 1.0)
        want = int(jnp.ceil(jnp.sqrt(3.0) / jnp.maximum(min_step, 1e-6)).astype(jnp.int32)) + 2
    assert fast.dynamic_step_bound(static, dyn) == want
    np.testing.assert_array_equal(dyn.numpy(), np.asarray(jdyn))


def test_the_two_step_bounds_differ():
    """At step .01 the float32 bound is 695 and ``resolved_max_steps`` 694:
    both are kept, each where the JAX package uses it."""
    p = RenderParams()
    static, dyn = p.split_dynamic()
    assert (p.resolved_max_steps(), fast.dynamic_step_bound(static, dyn)) == (694, 695)
    assert fast.dynamic_step_bound(static.replace(max_steps=40), dyn) == 40


def test_split_dynamic():
    p = RenderParams(density_threshold=0.2, raymarching_step_size=0.03, early_termination_alpha=0.9,
                     importance_check_ahead_steps=25)
    static, dyn = p.split_dynamic()
    assert dyn.dtype == torch.float32 and dyn.shape == (4,)
    np.testing.assert_array_equal(dyn.numpy(), np.float32([0.2, 0.03, 0.9, 25]))
    assert RenderParams.DYNAMIC_FIELDS == ("density_threshold", "raymarching_step_size", "early_termination_alpha",
                                           "importance_check_ahead_steps")
    assert all(getattr(static, f) == 0 for f in RenderParams.DYNAMIC_FIELDS)
    assert static.use_shading == p.use_shading and static.interpolation == p.interpolation
    with pytest.raises(ValueError, match="AHEAD_CAP"):
        p.replace(importance_check_ahead_steps=26).split_dynamic()
    # the static renderers take a count above the cap
    golden.render(teapot(8)[1], camera()[2], p.replace(importance_check_ahead_steps=26, max_steps=4,
                                                       use_importance_rendering=True), 4, 4)
