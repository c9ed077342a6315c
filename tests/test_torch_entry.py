"""volym_tpu_torch's entry points on a machine without CUDA: the import
boundary (no jax), the CLI, the PNG writer, the render modes held to the
plain render and to the JAX package's jnp golden, and the modes and devices
that must raise rather than fall back."""

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import volym_tpu as vj
from volym_tpu.render import slab as jslab
from volym_tpu_torch import Camera, RenderParams, Scene, cli, convert, parity
from volym_tpu_torch import io as vio
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.renderer import make_renderer

REPO = Path(__file__).resolve().parents[1]
BASE = RenderParams(use_gaussian_smoothing=False)


def _run(args, cwd, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300, **kw)


def read_png(path):
    """Decode an 8-bit non-interlaced PNG with no filters: (H, W, C) uint8."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0] == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = {0: 1, 2: 3, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * c)
    assert depth == 8 and (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, c)


def test_port_never_imports_jax():
    code = (
        "import sys, volym_tpu_torch, volym_tpu_torch.cli, volym_tpu_torch.convert, "
        "volym_tpu_torch.parity, volym_tpu_torch.io, volym_tpu_torch.ops.slab_march, volym_tpu_torch.ops.slab_replay, "
        "volym_tpu_torch.ops.lookahead, volym_tpu_torch.ops.voxel_grad, volym_tpu_torch.ops._build, "
        "volym_tpu_torch.render.renderer, "
        "volym_tpu_torch.render.golden, volym_tpu_torch.render.fast, volym_tpu_torch.render.diff, "
        "volym_tpu_torch.render.debug_vis, volym_tpu_torch.ops.interp\n"
        "volym_tpu_torch.cli.build_parser().parse_args(['screenshot'])\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')"
    )
    r = _run(["-c", code], cwd=REPO)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_cli_screenshot_writes_png(tmp_path):
    out = tmp_path / "shot.png"
    r = _run(
        ["-m", "volym_tpu_torch", "screenshot", "--no-gaussian", "--side", "32", "--width", "64",
         "--height", "48", "--device", "cpu", "--renderer", "slab", "--output", str(out)],
        cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    img = read_png(out)
    assert img.shape == (48, 64, 4)
    assert img[..., :3].max() > 0  # the bonsai is visible


def test_cli_run_saves_last_frame(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["run", "--no-gaussian", "--side", "16", "--width", "32", "--height", "24",
                   "--device", "cpu", "--renderer", "slab", "--frames", "2"])
    assert rc == 0
    (png,) = tmp_path.glob("screenshot_*.png")
    assert read_png(png).shape == (24, 32, 4)


@pytest.mark.parametrize(
    "flags",
    [["--first-hit"], ["--no-gaussian", "--first-hit"], ["--importance", "--cone", "--coloring"],
     ["--no-gaussian", "--coloring"], ["--no-gaussian", "--profile", "x"]],
)
def test_cli_unported_modes_raise(tmp_path, flags):
    """``--first-hit`` and ``--coloring`` (which replaces ``--importance``)
    write the plain render of their flags' parameters; ``screenshot``
    ignores ``--profile``, as the JAX package's does (``run`` and
    ``benchmark`` trace: tests/test_torch_cli_tools.py)."""
    argv = ["screenshot", *flags, "--scene", "teapot", "--side", "8", "--width", "8", "--height", "8",
            "--device", "cpu", "--renderer", "slab", "--output", str(tmp_path / "x.png")]
    assert cli.main(argv) == 0
    args = cli.build_parser().parse_args(argv)
    p = cli._params(args)
    assert p.use_importance_coloring == ("--coloring" in flags) and p.use_opacity == ("--first-hit" not in flags)
    want = slab.render(cli._default_scene(args), cli._camera(args).matrices(), p, 8, 8)
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), vio.to_uint8_image(want.numpy()))


@pytest.mark.parametrize(
    "kw",
    [dict(use_gaussian_smoothing=True, use_opacity=False), dict(use_importance_coloring=True),
     dict(use_importance_rendering=True, use_importance_coloring=True), dict(use_opacity=False)],
)
def test_renderer_unported_modes_raise(kw):
    """First-hit and coloring (with look-ahead asked for too: coloring
    replaces it) through ``make_renderer``, held to the JAX package's jnp
    golden (eager) on the same 8^3 teapot by the repo's rule."""
    sj = vj.Scene.synthetic("teapot", side=8)
    mj = vj.Camera(distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    pj = vj.RenderParams(**{"use_gaussian_smoothing": False, "raymarching_step_size": 1.0 / 8, **kw})
    with jax.disable_jit():
        want = np.asarray(jslab.render(sj, mj, pj, 8, 8))
    got = make_renderer(convert.scene_from_jax(sj), convert.render_params(pj), 8, 8, backend="slab",
                        device="cpu")(convert.camera_matrices_from_jax(mj))
    parity.check_close(want, got.numpy(), f"{kw}")


def test_renderer_differentiable_raises():
    """The differentiable render trains with the default ``RenderParams()``
    (``camera_grads=True``, smoothing on) and yields camera gradients, with
    importance coloring (d_importance) and importance look-ahead too; only
    first-hit raises, naming the mode, as in the JAX package."""
    scene = Scene.synthetic("sphere", side=8)
    vol = scene.volume.clone().requires_grad_(True)
    render = make_renderer(Scene(vol, scene.importance, scene.tf_lut), RenderParams(), 8, 8, backend="slab",
                           device="cpu", differentiable=True)
    cm = Camera().orbit(20.0, 10.0, 0.0).matrices()
    cm.inverse_view_proj.requires_grad_(True)
    cm.position.requires_grad_(True)
    render(cm).sum().backward()
    assert float(vol.grad.abs().max()) > 0
    assert float(cm.inverse_view_proj.grad.abs().max()) > 0 and float(cm.position.grad.abs().max()) > 0
    diff = BASE.replace(camera_grads=False)
    for kw in (dict(use_gaussian_smoothing=True, use_opacity=False), dict(use_opacity=False)):
        with pytest.raises(NotImplementedError, match="first-hit"):
            make_renderer(scene, diff.replace(**kw), 8, 8, backend="slab", device="cpu", differentiable=True)
    teapot = Scene.synthetic("teapot", side=8)
    for kw, leaf in ((dict(use_importance_coloring=True), "importance"), (dict(use_importance_rendering=True), "volume")):
        s = Scene(teapot.volume.clone(), teapot.importance.clone(), teapot.tf_lut)
        getattr(s, leaf).requires_grad_(True)
        img = make_renderer(s, diff.replace(**kw), 8, 8, backend="slab", device="cpu", differentiable=True)(cm)
        img.sum().backward()
        grad = getattr(s, leaf).grad
        assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0, kw


def test_renderer_differentiable_renders_on_cpu():
    scene = Scene.synthetic("sphere", side=8)
    vol = scene.volume.clone().requires_grad_(True)
    p = BASE.replace(camera_grads=False, raymarching_step_size=1.0 / 8)
    render = make_renderer(Scene(vol, scene.importance, scene.tf_lut), p, 8, 8, backend="slab", device="cpu",
                           differentiable=True)
    img = render(Camera().orbit(20.0, 10.0, 0.0).matrices())
    img.sum().backward()
    assert tuple(vol.grad.shape) == (8, 8, 8) and float(vol.grad.abs().max()) > 0


def test_slab_cuda_without_cuda_raises():
    scene = Scene.synthetic("sphere", side=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_renderer(scene, BASE, 8, 8, backend="slab_cuda", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_renderer(scene, BASE, 8, 8, backend="slab_cuda", device="cuda")
    with pytest.raises(ValueError, match="unknown renderer backend"):
        make_renderer(scene, BASE, 8, 8, backend="slab_pallas", device="cpu")


def test_ray_backend_renders_on_cpu():
    """``make_renderer(backend="ray", device="cpu")``: the early-exit
    ``fast`` frame, equal to the golden's, and the differentiable
    ``diff`` frame with gradients for the volume, the LUT and the camera."""
    from volym_tpu_torch.render import diff, golden

    scene = Scene.synthetic("sphere", side=16)
    p = BASE.replace(raymarching_step_size=0.05, interpolation="trilinear")
    cm = Camera().orbit(20.0, 10.0, 0.0).matrices()
    img = make_renderer(scene, p, 8, 8, backend="ray", device="cpu")(cm)
    assert img.device.type == "cpu" and tuple(img.shape) == (8, 8, 4)
    assert torch.equal(img, golden.render(scene, cm, p, 8, 8))
    assert float(img[..., :3].max()) > 0.1
    vol, lut = scene.volume.clone().requires_grad_(True), scene.tf_lut.clone().requires_grad_(True)
    cm.inverse_view_proj.requires_grad_(True)
    render = make_renderer(Scene(vol, scene.importance, lut), p, 8, 8, backend="ray", device="cpu",
                           differentiable=True)
    out = render(cm)
    torch.testing.assert_close(out, diff.render(scene, cm, p, 8, 8), rtol=0, atol=0)
    out.sum().backward()
    for leaf in (vol, lut, cm.inverse_view_proj):
        assert bool(torch.isfinite(leaf.grad).all()) and float(leaf.grad.abs().max()) > 0
    with pytest.raises(NotImplementedError, match="first-hit"):
        make_renderer(scene, p.replace(use_opacity=False), 8, 8, backend="ray", device="cpu", differentiable=True)


def test_cli_screenshot_ray_writes_the_fast_frame(tmp_path):
    """``screenshot --renderer ray --device cpu`` renders through ``fast``
    with the CLI's parameters (the flags of the JAX package's default
    renderer)."""
    from volym_tpu_torch.render import fast

    out = tmp_path / "ray.png"
    argv = ["screenshot", "--renderer", "ray", "--device", "cpu", "--side", "16", "--width", "12", "--height", "8",
            "--step-size", "0.05", "--importance", "--cone", "--ahead-steps", "4", "--scene", "teapot",
            "--output", str(out)]
    assert cli.main(argv) == 0
    args = cli.build_parser().parse_args(argv)
    want = fast.render(cli._default_scene(args), cli._camera(args).matrices(), cli._params(args), 8, 12)
    np.testing.assert_array_equal(read_png(out), vio.to_uint8_image(want.numpy()))
    assert read_png(out)[..., :3].max() > 0


def _inputs(params, side=8, h=6, w=5):
    scene = Scene.synthetic("sphere", side=side)
    return slab_march.prepare(scene, Camera(aspect=w / h).orbit(30.0, 10.0, 0.0).matrices(), params, h, w)


def test_march_dispatches_cpu_tensors_to_plain_version():
    feats, vol, lut, sign, grad, u8 = _inputs(BASE)
    before = slab_march.LAUNCHES
    got = slab_march.march(feats, vol, lut, sign, BASE, grad, u8=u8)
    torch.testing.assert_close(got, slab.march_slabs(feats, vol, lut, sign, BASE, grad, u8), rtol=0, atol=0)
    assert slab_march.LAUNCHES == before


def test_march_cuda_refuses_cpu_tensors():
    feats, vol, lut, sign, grad, u8 = _inputs(BASE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        slab_march.march_cuda(feats, vol, lut, sign, BASE, grad, u8=u8)


def test_u8_domain_selection():
    p = BASE.replace(u8_volume=True, interpolation="trilinear", raymarching_step_size=1.0 / 16.0, camera_grads=False)
    assert slab_march.u8_active(p, 16, 16)
    assert not slab_march.u8_active(p, 8, 16)  # resampled planes
    assert not slab_march.u8_active(p.replace(subtexel_bits=0), 16, 16)
    assert slab_march.u8_active(p.replace(subtexel_bits=0, interpolation="nearest"), 16, 16)
    assert _inputs(p, side=16)[1].dtype == torch.uint8
    assert _inputs(p.replace(raymarching_step_size=0.5), side=16)[1].dtype == torch.float32


def test_write_png_round_trip(tmp_path, rng):
    img = rng.uniform(-0.2, 1.2, (5, 7, 4)).astype(np.float32)
    vio.write_png(tmp_path / "a.png", torch.tensor(img))
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), vio.to_uint8_image(img))
    rgb = rng.integers(0, 256, (3, 4, 3)).astype(np.uint8)
    vio.write_png(tmp_path / "b.png", rgb)
    np.testing.assert_array_equal(read_png(tmp_path / "b.png"), rgb)
