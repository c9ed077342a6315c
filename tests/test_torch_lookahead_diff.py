"""The look-ahead backward: volym_tpu_torch's differentiable render gated by
importance look-ahead against volym_tpu's TPU kernels.

The three-level scene of ``test_torch_lookahead`` (a noise volume, dense
shells around importance spheres at both look-ahead levels, a LUT made from
a seed) goes through ``convert.scene`` into the port's ``render_diff`` on
the CPU (the plain gate, march and replay, gated by the same bits) and
through ``slab_kernel._render_pallas_diff_jit`` under the repo's Pallas
emulator (``tests/pallas_emu.py``: ``lookahead_call``, then
``march_pallas_lookahead``, whose backward reads the same gate and gives the
gate and the importance zero cotangents, ``slab_kernel.py:1798-1822``), run
eagerly (``jax.disable_jit``).  The loss is ``sum(img * w)``.

Every case is straight or cone x the bench or the CLI-default
configuration (``test_torch_diff.CONFIGS``) x smoothing off or on, one view
of each march sign in turn; the port runs its replay from the stored
residual and re-sampled (a zero residual budget), which must give the same
bits, and both are held to the TPU kernels by ``test_torch_diff``'s rule
(``KERNEL_RULE``: the CLI default on resampled planes to bulk 1e-3, as
named there).  The importance gets no gradient: None in the port, zeros in
JAX.  The camera gradients of the gated step are in
``test_torch_lookahead_camera``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.pallas_emu import emulate
from tests.test_torch_diff import CONFIGS, DISTANCE, H, KERNEL_RULE, SIDE, W
from tests.test_torch_lookahead import three_level_scene
from volym_tpu.ops import lookahead_kernel, slab_bwd_kernel, slab_kernel
from volym_tpu.render import slab as jslab
from volym_tpu_torch import convert, parity
from volym_tpu_torch.ops import slab_march, slab_replay
from volym_tpu_torch.render import slab

SIGN_ORBITS = [(30.0, 20.0), (210.0, 20.0)]  # march sign +1 and -1


@pytest.fixture(scope="module")
def inputs():
    vol, imp, lut = three_level_scene(SIDE)
    w = np.random.default_rng(11).uniform(-1.0, 1.0, (H, W, 4)).astype(np.float32)
    return vol, imp, lut, w


def pallas_step(inputs, mj, pj, wrt_camera=False):
    """(image, d_volume, d_lut, d_importance[, d_camera]) of the emulated
    TPU kernels' ``render_diff``."""
    vol, imp, lut, w = inputs
    major, sign = jslab.dominant_axis(mj)
    planes = jslab.resolve_planes(pj, SIDE)
    pk = pj if planes == SIDE else pj.replace(u8_volume=False)  # as slab_kernel.render_diff does

    def loss(v, l, i, mm):
        img = slab_kernel._render_pallas_diff_jit.__wrapped__(
            vj.Scene(v, i, l), mm, pk.pallas_static(), H, W, major, sign, knobs=pk.knobs(), planes=planes
        )
        return jnp.sum(img * w), img

    argnums = (0, 1, 2, 3) if wrt_camera else (0, 1, 2)
    with emulate(slab_kernel, slab_bwd_kernel, lookahead_kernel), jax.disable_jit():
        (_, img), grads = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(
            jnp.asarray(vol), jnp.asarray(lut), jnp.asarray(imp), mj
        )
    return (np.asarray(img), *(np.asarray(g) for g in grads[:3]), *grads[3:])


def port_step(inputs, mj, pj, camera_leaves=()):
    """(image, d_volume, d_lut, d_importance, {leaf: gradient}) of the
    port's ``render_diff`` on the CPU."""
    vol, imp, lut, w = inputs
    st = convert.scene(vol, imp, lut)
    for t in (st.volume, st.tf_lut, st.importance):
        t.requires_grad_(True)
    cm = convert.camera_matrices_from_jax(mj)
    for name in camera_leaves:
        getattr(cm, name).requires_grad_(True)
    img = slab_march.render_diff(st, cm, convert.render_params(pj), H, W)
    (img * torch.from_numpy(w)).sum().backward()
    return (img.detach(), st.volume.grad, st.tf_lut.grad, st.importance.grad,
            {name: getattr(cm, name).grad for name in camera_leaves})


def params(config, cone, smooth, **kw):
    return vj.RenderParams(**{
        "use_gaussian_smoothing": smooth, "camera_grads": False, "u8_volume": True, "use_importance_rendering": True,
        "use_cone_importance_check": cone, **CONFIGS[config], "density_threshold": 0.12, **kw,
    })


#: (configuration, cone, smoothing, orbit): the bench configuration in
#: every case here, the CLI default's in ``test_torch_lookahead_diff_cli``
CASES = [("bench", False, False, SIGN_ORBITS[0]), ("bench", True, False, SIGN_ORBITS[1]),
         ("bench", False, True, SIGN_ORBITS[1]), ("bench", True, True, SIGN_ORBITS[0])]


def gated_case(inputs, monkeypatch, config, cone, smooth, orbit):
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(*orbit, 0.0).matrices()
    pj = params(config, cone, smooth)
    label = f"{config} cone={cone} smoothing={smooth} view {jslab.dominant_axis(mj)}"
    want = pallas_step(inputs, mj, pj)
    assert np.abs(want[1]).max() > 0 and np.abs(want[2]).max() > 0 and not np.abs(want[3]).any()
    pt = convert.render_params(pj)
    planes = slab.resolve_planes(pt, SIDE)
    assert slab_replay.use_stored_density(pt, planes, H * W)
    stored = port_step(inputs, mj, pj)
    monkeypatch.setattr(slab_replay, "STORE_DENSITY_BUDGET_MB", 0)
    assert not slab_replay.use_stored_density(pt, planes, H * W)
    resampled = port_step(inputs, mj, pj)
    for a, b in zip(stored[:3], resampled[:3]):
        assert torch.equal(a, b), f"{label}: the stored and re-sampled replays differ"
    assert stored[3] is None, "the importance only builds the gate"
    # the gate engages: the gated image differs from the ungated one
    st = convert.scene(*inputs[:3])
    cm = convert.camera_matrices_from_jax(mj)
    assert not torch.equal(stored[0], slab.render(st, cm, pt.replace(use_importance_rendering=False), H, W))
    bulk, edge_frac = KERNEL_RULE[config]
    for name, a, b in zip(("image", "d_volume"), want[:2], stored[:2]):
        parity.check_close(a, b, f"{label} {name}", bulk=bulk, edge_frac=edge_frac)
    parity.check_lut_grad(want[2], stored[2], st.tf_lut, f"{label} d_lut", bulk=bulk, edge_frac=edge_frac)


@pytest.mark.parametrize("config,cone,smooth,orbit", CASES)
def test_gated_render_diff_matches_tpu_kernels(inputs, monkeypatch, config, cone, smooth, orbit):
    gated_case(inputs, monkeypatch, config, cone, smooth, orbit)
