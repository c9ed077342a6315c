"""Importance coloring's forward: volym_tpu_torch's render against
volym_tpu's.

The volume of ``test_torch_lookahead``'s three-level scene with an
importance grid of u8-representable uniform noise (so that the heat map's
``1.5 imp < 1`` kink falls on both sides), made from a seed, goes through
``convert.scene`` into the port's plain render (``slab.render``: the
importance grid permuted and resampled nearest to the march's planes,
sampled with the box tap at each step's snapped coordinates, rgba =
``golden.importance_to_color``) and into the JAX package's jnp golden
``volym_tpu.render.slab.render``, run eagerly (``jax.disable_jit``), in
every combination of {nearest, trilinear} x {u8 native planes, f32
resampled planes} x {shaded, unshaded} x {smoothing off, on}, one orbit
each; four of them also against the TPU kernel ``slab_kernel.render``
under the repo's Pallas emulator.  Tolerance: the repo's knife-edge rule
(``parity.check_close``).  Each case asserts that coloring engages (the
image differs from the TF render) and that look-ahead asked for beside it
changes nothing (coloring replaces it).
"""

import jax
import numpy as np
import pytest

import volym_tpu as vj
from tests.pallas_emu import emulate
from tests.test_torch_lookahead import ORBITS, three_level_scene
from volym_tpu.ops import slab_kernel
from volym_tpu.render import slab as jslab
from volym_tpu_torch import convert, parity
from volym_tpu_torch.render import slab

SIDE, H, W = 16, 24, 32
#: (interpolation, stream, shading, smoothing): every combination
CASES = [(i, s, sh, sm) for i in ("nearest", "trilinear") for s in ("u8", "f32") for sh in (False, True)
         for sm in (False, True)]


def coloring_scene(side=SIDE, seed=21):
    """(volume, importance, LUT) float32 arrays: the three-level scene's
    volume and LUT, and u8-representable uniform importance."""
    vol, _, lut = three_level_scene(side)
    imp = np.round(np.random.default_rng(seed).uniform(0.0, 1.0, (side,) * 3) * 255.0) / np.float32(255.0)
    return vol, imp.astype(np.float32), lut


def coloring_params(interp, stream, shading, smooth, **kw):
    return vj.RenderParams(**{
        "use_gaussian_smoothing": smooth, "interpolation": interp, "use_shading": shading, "u8_volume": True,
        "density_threshold": 0.12, "use_importance_coloring": True,
        "raymarching_step_size": (1.0 if stream == "u8" else 2.0) / SIDE, **kw,
    })


@pytest.mark.parametrize("interp,stream,shading,smooth", CASES)
def test_coloring_matches_golden(interp, stream, shading, smooth):
    arrays = coloring_scene()
    h, v = ORBITS[CASES.index((interp, stream, shading, smooth)) % len(ORBITS)]
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    pj = coloring_params(interp, stream, shading, smooth)
    with jax.disable_jit():
        want = np.asarray(jslab.render(vj.Scene(*arrays), mj, pj, H, W))
    st, mt, pt = convert.scene(*arrays), convert.camera_matrices_from_jax(mj), convert.render_params(pj)
    got = slab.render(st, mt, pt, H, W).numpy()
    label = f"{interp} {stream} shading={shading} smoothing={smooth} view {jslab.dominant_axis(mj)}"
    assert np.abs(want - slab.render(st, mt, pt.replace(use_importance_coloring=False), H, W).numpy()).max() > 0.05
    assert np.array_equal(got, slab.render(st, mt, pt.replace(use_importance_rendering=True), H, W).numpy())
    parity.check_close(want, got, label)


@pytest.mark.parametrize("interp,stream,shading,smooth", [CASES[0], CASES[5], CASES[10], CASES[15]])
def test_coloring_matches_tpu_kernel(interp, stream, shading, smooth):
    arrays = coloring_scene()
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(210.0, 20.0, 0.0).matrices()
    pj = coloring_params(interp, stream, shading, smooth)
    with emulate(slab_kernel), jax.disable_jit():
        want = np.asarray(slab_kernel.render(vj.Scene(*arrays), mj, pj, H, W))
    got = slab.render(convert.scene(*arrays), convert.camera_matrices_from_jax(mj), convert.render_params(pj), H, W)
    parity.check_close(want, got.numpy(), f"{interp} {stream} shading={shading} smoothing={smooth}")
