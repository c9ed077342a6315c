"""The per-ray and cone tables' dispatch (``ops/slab_march.py::_table``) and
the CUDA kernels' wrapper (``ops/ray_table.py``) on the CPU: the rule that
picks the kernel, the chain's values on CPU tensors, the wrapper's input
checks and the constants it hands the kernel.  The kernels themselves run
in ``tests/test_torch_cuda.py``, on the card."""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from volym_tpu_torch import Camera
from volym_tpu_torch.camera import CameraMatrices
from volym_tpu_torch.ops import ray_table, slab_march
from volym_tpu_torch.render import golden
from volym_tpu_torch.render import rays as rays_mod
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.slab import CONE_FEATURES, N_FEATURES

H, W = 12, 16
CSRC = Path(ray_table.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("grad_enabled", [False, True])
@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
def test_use_kernel_rule(device, grad_enabled, requires_grad):
    """The kernel on every CUDA device, through the function whose backward
    re-runs the chain where autograd records a camera that requires grad;
    the chain on the CPU."""
    if device == "cpu":
        want = "chain"
    else:
        want = "kernel_vjp" if grad_enabled and requires_grad else "kernel"
    assert ray_table.route(torch.device(device), grad_enabled, requires_grad) == want


def _camera(h=30.0, v=20.0):
    return Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()


@pytest.mark.parametrize("cone", [False, True])
@pytest.mark.parametrize("h,v", [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0),
                                 (20.0, -70.0)])
def test_cpu_tables_are_the_chain(h, v, cone):
    """On CPU tensors ``_features`` / ``_cone_features`` are the chain of
    PyTorch ops, bit for bit, and launch nothing."""
    cm = _camera(h, v)
    major, sign = slab.dominant_axis(cm)
    ndc = rays_mod.pixel_ndc(H, W)
    before = (ray_table.LAUNCHES, ray_table.CONE_LAUNCHES)
    fn = slab_march._cone_features if cone else slab_march._features
    got = fn(cm, ndc, (H, W), 64, major, sign, 32)
    assert (ray_table.LAUNCHES, ray_table.CONE_LAUNCHES) == before
    origin, dirs = rays_mod.rays_from_ndc(cm, ndc)
    if cone:
        want = slab_march.cone_features_from_rays(origin, dirs, 64, major, sign, n_plane=32)
    else:
        entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
        want = slab_march.features_from_rays(origin, dirs, entry, exit_, 64, major, sign, n_plane=32)
    assert got.shape == ((CONE_FEATURES if cone else N_FEATURES), H, W)
    assert torch.equal(got.reshape(want.shape), want)


def test_cpu_table_keeps_camera_gradients():
    """A CPU table built with autograd on from a camera that requires grad
    carries the gradient to the camera."""
    cm = _camera()
    cm.position.requires_grad_(True)
    major, sign = slab.dominant_axis(cm)
    feats = slab_march._features(cm, rays_mod.pixel_ndc(H, W), (H, W), 64, major, sign, None)
    feats[slab.F_RB].sum().backward()
    assert cm.position.grad is not None and bool(torch.isfinite(cm.position.grad).all())


def _chain_as_kernel(ivp, pos, ndc, planes, major, sign, n_plane=None, cone=False):
    """A CPU stand-in for ``table_cuda``: the chain's values, no graph."""
    cm = CameraMatrices(None, None, ivp, pos)
    with torch.no_grad():
        return slab_march.table_chain(cm, ndc, planes, major, sign, n_plane, cone)


@pytest.mark.parametrize("ndc_grad", [False, True])
@pytest.mark.parametrize("cone", [False, True])
def test_kernel_table_gradients_are_the_chain_s(monkeypatch, cone, ndc_grad):
    """``KernelTable`` (the kernel's table where it carries camera
    gradients), its kernel stood in for by the chain's values: the forward
    keeps no graph of the chain, and the backward gives the chain's own
    gradients bit for bit, for the inputs that require grad and no others."""
    monkeypatch.setattr(ray_table, "table_cuda", _chain_as_kernel)
    cm = _camera(120.0, 10.0)
    major, sign = slab.dominant_axis(cm)
    ndc = rays_mod.pixel_ndc(H, W)
    d_table = torch.randn((CONE_FEATURES if cone else N_FEATURES, H * W), generator=torch.Generator().manual_seed(3))
    grads = []
    for use_fn in (False, True):
        ivp, pos = cm.inverse_view_proj.clone().requires_grad_(True), cm.position.clone().requires_grad_(True)
        pts = ndc.clone().requires_grad_(ndc_grad)
        leaves = (ivp, pos, pts) if ndc_grad else (ivp, pos)
        cam = CameraMatrices(cm.view, cm.proj, ivp, pos)
        if use_fn:
            table = slab_march.KernelTable.apply(ivp, pos, pts, cam, 64, major, sign, 32, cone)
            assert type(table.grad_fn).__name__ == "KernelTableBackward"
        else:
            table = slab_march.table_chain(cam, pts, 64, major, sign, 32, cone)
        grads.append(torch.autograd.grad(table, leaves, d_table))
    for want, got in zip(*grads):
        assert torch.equal(want, got)


def test_cone_offsets_are_the_reference_s():
    """``golden.CONE_OFFSETS`` are the reference's cos and sin of each cone
    direction's angle (with 3.14159) times the cone angle, and the kernel's
    argument holds them as float32, right offsets then up."""
    for s, (off0, off1) in enumerate(golden.CONE_OFFSETS):
        angle = (s / golden.CONE_SAMPLES) * 2.0 * 3.14159
        assert (off0, off1) == (math.cos(angle) * golden.CONE_ANGLE, math.sin(angle) * golden.CONE_ANGLE)
    want = np.float32([o[0] for o in golden.CONE_OFFSETS] + [o[1] for o in golden.CONE_OFFSETS])
    assert np.array_equal(np.ctypeslib.as_array(ray_table._CONE_OFFSETS), want)


def test_slab_origin_is_ray_affine_s():
    """The step and first plane the wrapper passes are those of
    ``slab.ray_affine``: its ts and tb of an axis-aligned ray."""
    origin = torch.tensor([0.25, 0.5, 0.75])
    for n, sign in ((64, 1), (64, -1), (100, 1)):
        sz, z0 = slab.slab_origin(n, sign)
        dirs = torch.tensor([[0.0, 0.0, float(sign)]])
        _, _, _, _, ts, tb = slab.ray_affine(origin, dirs, n, 2, sign)
        assert float(ts) == np.float32(sz) / np.float32(sign)
        assert float(tb) == (np.float32(z0) - np.float32(0.75)) / np.float32(sign)


def _inputs():
    cm = _camera()
    return cm.inverse_view_proj, cm.position, rays_mod.pixel_ndc(H, W)


@pytest.mark.parametrize("case,match", [
    ("ivp_f64", "inverse_view_proj must be float32"),
    ("ivp_shape", r"inverse_view_proj must be float32 \(4, 4\)"),
    ("pos_shape", r"position must be float32 \(3,\)"),
    ("ndc_shape", r"ndc must be float32 \(R, 2\)"),
    ("ndc_cols", r"ndc must be float32 \(R, 2\)"),
    ("ivp_strided", "inverse_view_proj must be contiguous"),
    ("ndc_strided", "ndc must be contiguous"),
    ("cpu", "table_cuda needs CUDA tensors"),
])
def test_table_cuda_checks_inputs(case, match):
    """The wrapper raises before it loads the library, as ``march_cuda``
    does: dtype, shape, contiguity, then the device."""
    ivp, pos, ndc = _inputs()
    if case == "ivp_f64":
        ivp = ivp.double()
    elif case == "ivp_shape":
        ivp = ivp[:3]
    elif case == "pos_shape":
        pos = torch.cat([pos, pos.new_ones(1)])
    elif case == "ndc_shape":
        ndc = ndc.reshape(-1)
    elif case == "ndc_cols":
        ndc = torch.cat([ndc, ndc[:, :1]], dim=1)
    elif case == "ivp_strided":
        ivp = ivp.t()
    elif case == "ndc_strided":
        ndc = ndc.t().contiguous().t()
    with pytest.raises(ValueError, match=match):
        ray_table.table_cuda(ivp, pos, ndc, 64, 2, 1)


def test_bind_matches_the_c_entry():
    """The argument types ``_bind`` sets are those of ``ray_table_launch``
    in ``csrc/ray_table.cu``, in order: a pointer for each pointer and the
    stream, an int for each int, a float for each float."""
    src = (CSRC / "ray_table.cu").read_text()
    params = re.search(r'extern "C" int ray_table_launch\(([^)]*)\)', src).group(1).split(",")
    kinds = {"float*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    want = [kinds[re.sub(r"^const\s+", "", q.strip()).rsplit(" ", 1)[0].replace(" ", "")] for q in params]

    class Lib:
        ray_table_launch = type("Fn", (), {"argtypes": None, "restype": None})()

    fn = ray_table._bind(Lib())
    assert fn.argtypes == want and fn.restype is ctypes.c_int
