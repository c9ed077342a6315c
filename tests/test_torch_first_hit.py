"""First-hit (``use_opacity=False``) forward: volym_tpu_torch's render
against volym_tpu's.

The scene of ``test_torch_coloring`` (made from a seed, through
``convert.scene``) renders first-hit in the port's plain render
(``slab.render``: the first step that passes the mask sets the colour and
alpha becomes ``max(acc_a, 1)``, ``slab_kernel.py:1248-1256``) and in the
JAX package's jnp golden ``slab.render`` (eager), with and without shading
and smoothing and with the straight and the cone look-ahead gate, and
against the TPU kernel ``slab_kernel.render`` under the repo's Pallas
emulator.  Tolerance: the repo's knife-edge rule.  First-hit is on only
without coloring (``slab_kernel.py:1451``): coloring with
``use_opacity=False`` composites.  The differentiable render refuses
first-hit, as the JAX package's does.
"""

import jax
import numpy as np
import pytest

import volym_tpu as vj
from tests.pallas_emu import emulate
from tests.test_torch_coloring import H, W, coloring_params, coloring_scene
from volym_tpu.ops import lookahead_kernel, slab_kernel
from volym_tpu.render import slab as jslab
from volym_tpu_torch import Camera, RenderParams, Scene, convert, parity
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.renderer import make_renderer

#: (interpolation, stream, shading, smoothing, look-ahead, orbit)
CASES = [
    ("trilinear", "u8", False, False, None, (30.0, 20.0)), ("nearest", "f32", True, False, None, (210.0, 20.0)),
    ("trilinear", "f32", False, True, None, (120.0, 10.0)), ("nearest", "u8", True, True, None, (300.0, -10.0)),
    ("trilinear", "u8", True, False, "straight", (30.0, 20.0)), ("nearest", "u8", False, True, "cone", (210.0, 20.0)),
]


def first_hit_params(interp, stream, shading, smooth, lookahead):
    return coloring_params(interp, stream, shading, smooth, use_importance_coloring=False, use_opacity=False,
                           use_importance_rendering=lookahead is not None,
                           use_cone_importance_check=lookahead == "cone")


def inputs(orbit):
    arrays = coloring_scene()
    arrays = (arrays[0], np.where(arrays[1] > 0.8, arrays[1], 0.0).astype(np.float32), arrays[2])  # sparse importance
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(*orbit, 0.0).matrices()
    return arrays, mj, convert.scene(*arrays), convert.camera_matrices_from_jax(mj)


@pytest.mark.parametrize("interp,stream,shading,smooth,lookahead,orbit", CASES)
def test_first_hit_matches_golden(interp, stream, shading, smooth, lookahead, orbit):
    arrays, mj, st, mt = inputs(orbit)
    pj = first_hit_params(interp, stream, shading, smooth, lookahead)
    with jax.disable_jit():
        want = np.asarray(jslab.render(vj.Scene(*arrays), mj, pj, H, W))
    pt = convert.render_params(pj)
    got = slab.render(st, mt, pt, H, W).numpy()
    label = f"{interp} {stream} shading={shading} smoothing={smooth} {lookahead} view {jslab.dominant_axis(mj)}"
    assert np.abs(got - slab.render(st, mt, pt.replace(use_opacity=True), H, W).numpy()).max() > 0.05, label
    if lookahead:
        assert not np.array_equal(got, slab.render(st, mt, pt.replace(use_importance_rendering=False), H, W).numpy())
    parity.check_close(want, got, label)


@pytest.mark.parametrize("case", [CASES[3], CASES[4]])
def test_first_hit_matches_tpu_kernel(case):
    """On native planes (on resampled ones the emulated TPU kernel departs
    from its own jnp golden, ``test_torch_diff``)."""
    interp, stream, shading, smooth, lookahead, orbit = case
    arrays, mj, st, mt = inputs(orbit)
    pj = first_hit_params(interp, stream, shading, smooth, lookahead)
    with emulate(slab_kernel, lookahead_kernel), jax.disable_jit():
        want = np.asarray(slab_kernel.render(vj.Scene(*arrays), mj, pj, H, W))
    parity.check_close(want, slab.render(st, mt, convert.render_params(pj), H, W).numpy(), f"{case}")


def test_coloring_without_opacity_composites():
    """``use_opacity=False`` with coloring is not first-hit: the image is
    coloring's, bit for bit, in the port, and within the rule in the
    golden."""
    arrays, mj, st, mt = inputs((30.0, 20.0))
    pj = coloring_params("trilinear", "u8", True, False, use_opacity=False)
    pt = convert.render_params(pj)
    got = slab.render(st, mt, pt, H, W)
    assert np.array_equal(got.numpy(), slab.render(st, mt, pt.replace(use_opacity=True), H, W).numpy())
    with jax.disable_jit():
        want = np.asarray(jslab.render(vj.Scene(*arrays), mj, pj, H, W))
    parity.check_close(want, got.numpy(), "coloring, use_opacity=False")


def test_differentiable_first_hit_raises():
    scene = Scene.synthetic("teapot", side=8)
    for p in (RenderParams(use_opacity=False), RenderParams(use_opacity=False, use_gaussian_smoothing=False)):
        with pytest.raises(NotImplementedError, match="first-hit"):
            slab_march.render_diff(scene, Camera().matrices(), p, 8, 8)
        with pytest.raises(NotImplementedError, match="first-hit"):
            make_renderer(scene, p, 8, 8, backend="slab", device="cpu", differentiable=True)
    sj = vj.Scene.synthetic("teapot", side=8)
    with pytest.raises(NotImplementedError, match="first-hit"):
        jslab.render_diff(sj, vj.Camera().matrices(), vj.RenderParams(use_opacity=False), 8, 8)
    with pytest.raises(NotImplementedError, match="first-hit"):
        slab_kernel.render_diff(sj, vj.Camera().matrices(), vj.RenderParams(use_opacity=False), 8, 8)
