"""The port's distributed train step (``parallel.mesh.make_train_step``) on
8 virtual CPU shards: against the JAX package's on its 8-device CPU mesh
("ray" and "slab"), against single-device autograd through the port's
differentiable render, and the order of its all-reduces on a one-rank
gloo group (the same with and without ``split_psum``)."""

from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from volym_tpu import Camera as JCamera
from volym_tpu import RenderParams as JParams
from volym_tpu import Scene as JScene
from volym_tpu.parallel import mesh as jmesh
from volym_tpu.render import slab as jslab
from volym_tpu_torch import Scene, convert
from volym_tpu_torch.parallel import launch
from volym_tpu_torch.parallel import mesh as pmesh
from volym_tpu_torch.render.renderer import make_renderer

JPARAMS = JParams(use_gaussian_smoothing=False, raymarching_step_size=0.1, max_steps=40, use_shading=False)
PARAMS = convert.render_params(JPARAMS)
RES = 16
CPU8 = [torch.device("cpu")] * 8
NAMES = ("volume", "importance", "tf_lut")


def _cam():
    return JCamera(aspect=1.0, distance=1.1).orbit(25.0, 10.0, 0.0)


@pytest.fixture(scope="module")
def case():
    """(JAX scene, JAX camera, the port's scene and camera, the target)."""
    js, jm = JScene.synthetic("sphere", side=16), _cam().matrices()
    target = np.asarray(jslab.render(js, jm, JPARAMS.replace(adaptive_stepping=False), RES, RES)) * 0.8
    return js, jm, convert.scene_from_jax(js), convert.camera_matrices_from_jax(jm), target


def _close(got, want, name, rtol=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-9)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5 * scale, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("backend", ["ray", "slab"])
def test_train_step_matches_jax(case, backend):
    """Loss and gradients within 1e-4 relative of the JAX package's step."""
    js, jm, sc, m, target = case
    jloss, jgrads = jmesh.make_train_step(JPARAMS, RES, RES, jmesh.make_mesh(), backend=backend,
                                          camera_matrices=jm)(js, jm, jnp.asarray(target))
    loss, grads = pmesh.make_train_step(PARAMS, RES, RES, pmesh.make_mesh(CPU8), backend=backend,
                                        camera_matrices=m)(sc, m, torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(loss) > 0
    for name in NAMES:
        _close(getattr(grads, name).numpy(), getattr(jgrads, name), name)
    assert float(grads.volume.abs().max()) > 0


@pytest.mark.parametrize("backend,mode", [("ray", "base"), ("slab", "base"), ("slab", "smoothing"),
                                          ("slab", "lookahead")])
def test_train_step_matches_single_device(case, backend, mode):
    """Against autograd through the single-device differentiable render of
    the same backend (``torch.mean`` of the squared error)."""
    _, _, sc, m, _ = case
    if mode == "lookahead":
        from test_torch_parallel import _lookahead_scene

        sc = _lookahead_scene()
    fixed = PARAMS.replace(adaptive_stepping=False, use_gaussian_smoothing=mode == "smoothing",
                           use_importance_rendering=mode == "lookahead")
    target = make_renderer(sc, fixed, RES, RES, backend="slab", device="cpu")(m) * 0.8
    loss, grads = pmesh.make_train_step(fixed, RES, RES, pmesh.make_mesh(CPU8), backend=backend,
                                        camera_matrices=m)(sc, m, target)
    leaves = Scene(*(getattr(sc, n).clone().requires_grad_() for n in NAMES))
    img = make_renderer(leaves, fixed.replace(u8_volume=False), RES, RES, backend=backend, device="cpu",
                        differentiable=True)(m)
    ref = torch.mean((img - target) ** 2)
    ref.backward()
    np.testing.assert_allclose(float(loss), float(ref.detach()), rtol=1e-5)
    for name in NAMES:
        want = getattr(leaves, name).grad
        want = torch.zeros_like(getattr(sc, name)) if want is None else want
        _close(getattr(grads, name).numpy(), want.numpy(), name)
    assert float(grads.volume.abs().max()) > 0


def test_train_step_guards(case):
    _, _, _, m, _ = case
    with pytest.raises(NotImplementedError, match="first-hit"):
        pmesh.make_train_step(PARAMS.replace(use_opacity=False), RES, RES, pmesh.make_mesh(CPU8))
    with pytest.raises(ValueError, match="camera_matrices"):
        pmesh.make_train_step(PARAMS, RES, RES, pmesh.make_mesh(CPU8), backend="slab")


@pytest.fixture
def gloo_world(request):
    """A one-rank gloo group, destroyed by a finaliser."""
    request.addfinalizer(lambda: dist.is_initialized() and dist.destroy_process_group())
    assert launch.maybe_initialize(True, device="cpu", timeout=timedelta(seconds=60), env={})
    return dist.group.WORLD


def test_split_psum_order_and_values(case, gloo_world, monkeypatch):
    """The step issues the importance and LUT all-reduces first,
    asynchronously, then the loss and the volume, blocking, with
    ``split_psum`` or without it (torch has no all-reduce combiner to
    split): the calls and the values are the same bit for bit.  The steps
    run under torch's deterministic algorithms: on the CPU the backward of
    a gather may add its terms by parallel atomics, in no fixed order."""
    _, _, sc, m, target = case
    calls = []
    real = dist.all_reduce

    def spy(tensor, *args, async_op=False, **kwargs):
        calls.append((tuple(tensor.shape), async_op))
        return real(tensor, *args, async_op=async_op, **kwargs)

    monkeypatch.setattr(dist, "all_reduce", spy)
    mesh = pmesh.make_mesh(CPU8)
    assert mesh.distributed and mesh.world == 1
    out = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for split in (False, True):
            calls.clear()
            step = pmesh.make_train_step(PARAMS, RES, RES, mesh, backend="slab", camera_matrices=m,
                                         split_psum=split)
            out[split] = step(sc, m, torch.from_numpy(target))
            out[split, "calls"] = list(calls)
    finally:
        torch.use_deterministic_algorithms(was)
    vol, lut = (RES,) * 3, (256, 4)
    for split in (False, True):
        assert out[split, "calls"] == [(vol, True), (lut, True), ((), False), (vol, False)], split
    assert torch.equal(out[False][0], out[True][0])
    for name in NAMES:
        assert torch.equal(getattr(out[False][1], name), getattr(out[True][1], name)), name
