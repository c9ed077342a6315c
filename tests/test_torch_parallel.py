"""The port's ray-sharded render (``volym_tpu_torch.parallel.mesh``) on 8
virtual CPU shards, against its single-device render (bit for bit) and
against the JAX package's ``render_sharded`` on its 8-device CPU mesh
(within 1e-6), at 16^3 and 16x16 rays (the JAX package's
``tests/test_parallel.py`` settings)."""

import jax
import numpy as np
import pytest
import torch

from volym_tpu import Camera as JCamera
from volym_tpu import RenderParams as JParams
from volym_tpu import Scene as JScene
from volym_tpu.parallel import mesh as jmesh
from volym_tpu_torch import Camera, Scene, convert
from volym_tpu_torch.parallel import mesh as pmesh
from volym_tpu_torch.render import diff
from volym_tpu_torch.render.renderer import make_renderer

JPARAMS = JParams(use_gaussian_smoothing=False, raymarching_step_size=0.1, max_steps=40, use_shading=False)
PARAMS = convert.render_params(JPARAMS)
RES = 16
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def jscene():
    return JScene.synthetic("sphere", side=16)


@pytest.fixture(scope="module")
def scene(jscene):
    return convert.scene_from_jax(jscene)


def _cam():
    return Camera(aspect=1.0, distance=1.1).orbit(25.0, 10.0, 0.0)


def _lookahead_scene():
    """16^3 haze and an important dense band (``tests/test_parallel.py``)."""
    side = 16
    vol = np.full((side, side, side), 0.45, np.float32)
    imp = np.zeros((side, side, side), np.float32)
    vol[10:13, 4:12, 4:12] = 0.9
    imp[10:13, 4:12, 4:12] = 1.0
    return Scene(torch.from_numpy(vol), torch.from_numpy(imp), Scene.synthetic("sphere", side=8).tf_lut)


def test_mesh_layout():
    mesh, host = pmesh.make_mesh(CPU8), pmesh.make_host_mesh(CPU8)
    assert mesh.axis_names == (pmesh.RAY_AXIS,) and mesh.shape == (8,) and mesh.size == 8
    assert host.axis_names == ("host", pmesh.RAY_AXIS) and host.shape == (1, 8)
    assert [k for k, _ in host.local_shards()] == list(range(8)) and not mesh.distributed


@pytest.mark.parametrize("backend", ["ray", "slab"])
@pytest.mark.parametrize("size", [(RES, RES), (12, RES)])
def test_sharded_render_equals_single_device(scene, backend, size):
    """Bit for bit with the single-device frame: 16 rows make 2 whole rows
    a shard, 12 rows 24 rays a shard (not whole rows: a one-row table)."""
    h, w = size
    m = _cam().matrices()
    got = pmesh.render_sharded(scene, m, PARAMS, h, w, pmesh.make_mesh(CPU8), backend=backend)
    want = make_renderer(scene, PARAMS, h, w, backend=backend, device="cpu")(m)
    assert (want[..., :3].amax(-1) > 0.01).float().mean() > 0.05
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["ray", "slab"])
def test_sharded_render_matches_jax_sharded(jscene, scene, backend):
    """Within 1e-6 of the JAX package's ``render_sharded`` on its 8-device
    mesh (jitted: FMA contraction may move an entry by an ulp)."""
    jm = JCamera(aspect=1.0, distance=1.1).orbit(25.0, 10.0, 0.0).matrices()
    want = np.asarray(jmesh.render_sharded(jscene, jm, JPARAMS, RES, RES, jmesh.make_mesh(), backend=backend))
    got = pmesh.render_sharded(scene, convert.camera_matrices_from_jax(jm), PARAMS, RES, RES, pmesh.make_mesh(CPU8),
                               backend=backend)
    assert len(jax.devices()) == 8
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize(
    "mode",
    ["smoothing", "lookahead", "lookahead_cone", "smoothing_shading", "first_hit", "coloring_shading"],
)
def test_sharded_slab_modes_equal_single_device(mode):
    """The slab modes of the JAX package's ``test_sharded_slab_modes_match_single``,
    bit for bit with the single-device frame; the gate engages."""
    sc, m = _lookahead_scene(), _cam().matrices()
    params = PARAMS.replace(
        use_gaussian_smoothing="smoothing" in mode,
        use_shading="shading" in mode,
        use_importance_rendering="lookahead" in mode,
        use_cone_importance_check="cone" in mode,
        use_importance_coloring="coloring" in mode,
        use_opacity="first_hit" not in mode,
    )
    got = pmesh.render_sharded(sc, m, params, RES, RES, pmesh.make_mesh(CPU8), backend="slab")
    want = make_renderer(sc, params, RES, RES, backend="slab", device="cpu")(m)
    assert torch.equal(got, want)
    if "lookahead" in mode:
        base = make_renderer(sc, PARAMS, RES, RES, backend="slab", device="cpu")(m)
        assert (want - base).abs().max() > 0.05


def test_sharded_render_rejects_uneven_split():
    with pytest.raises(ValueError, match="divide evenly"):
        pmesh.render_sharded(Scene.synthetic("sphere", side=8), Camera().matrices(), PARAMS, 3, 3,
                             pmesh.make_mesh(CPU8))
    with pytest.raises(ValueError, match="divide evenly"):
        pmesh.make_train_step(PARAMS, 3, 3, pmesh.make_mesh(CPU8))


def test_slab_cuda_needs_cuda_devices(scene):
    """No fallback: the CUDA backend on CPU shards raises."""
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.render_sharded(scene, _cam().matrices(), PARAMS, RES, RES, pmesh.make_mesh(CPU8), backend="slab_cuda")


@pytest.mark.parametrize("backend", ["ray", "slab"])
def test_sharded_diff_render_matches(scene, backend):
    """The differentiable frame equals the single-device differentiable
    render (``diff.render`` for "ray"), and its gradients the
    single-device frame's (summation order aside)."""
    m = _cam().matrices()
    leaves = [t.clone().requires_grad_() for t in (scene.volume, scene.importance, scene.tf_lut)]
    ref_leaves = [t.clone().requires_grad_() for t in (scene.volume, scene.importance, scene.tf_lut)]
    got = pmesh.render_sharded(Scene(*leaves), m, PARAMS, RES, RES, pmesh.make_mesh(CPU8), differentiable=True,
                               backend=backend)
    if backend == "ray":
        want = diff.render(Scene(*ref_leaves), m, PARAMS.replace(adaptive_stepping=False), RES, RES)
    else:
        want = make_renderer(Scene(*ref_leaves), PARAMS, RES, RES, backend="slab", device="cpu",
                             differentiable=True)(m)
    assert torch.equal(got, want)
    got.sum().backward()
    want.sum().backward()
    for a, b in zip(leaves, ref_leaves):
        assert (a.grad is None) == (b.grad is None)
        if b.grad is None:  # the slab march's importance outside coloring
            continue
        scale = max(float(b.grad.abs().max()), 1e-9)
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6 * scale, rtol=1e-5)
    assert float(ref_leaves[0].grad.abs().max()) > 0


def test_make_renderer_with_mesh(scene):
    m = _cam().matrices()
    render = make_renderer(scene, PARAMS, RES, RES, backend="slab", mesh=pmesh.make_mesh(CPU8))
    assert torch.equal(render(m), pmesh.render_sharded(scene, m, PARAMS, RES, RES, pmesh.make_mesh(CPU8),
                                                       backend="slab"))
