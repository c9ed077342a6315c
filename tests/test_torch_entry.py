"""volym_tpu_torch's entry points on a machine without CUDA: the import
boundary (no jax), the CLI, the PNG writer, and the modes and devices that
must raise rather than fall back."""

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from volym_tpu_torch import Camera, RenderParams, Scene, cli
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
        "volym_tpu_torch.render.golden\n"
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
    with pytest.raises(NotImplementedError):
        cli.main(["screenshot", *flags, "--side", "8", "--width", "8", "--height", "8",
                  "--device", "cpu", "--renderer", "slab", "--output", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize(
    "kw",
    [dict(use_gaussian_smoothing=True, use_opacity=False), dict(use_importance_coloring=True),
     dict(use_importance_rendering=True, use_importance_coloring=True), dict(use_opacity=False)],
)
def test_renderer_unported_modes_raise(kw):
    with pytest.raises(NotImplementedError):
        make_renderer(Scene.synthetic("sphere", side=8), BASE.replace(**kw), 8, 8, backend="slab", device="cpu")


def test_renderer_differentiable_raises():
    """The differentiable render trains with the default ``RenderParams()``
    (``camera_grads=True``, smoothing on) and yields camera gradients; the
    unported render modes raise, naming the mode."""
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
    for kw, name in ((dict(use_gaussian_smoothing=True, use_opacity=False), "first-hit"),
                     (dict(use_importance_coloring=True), "coloring"),
                     (dict(use_importance_rendering=True), "look-ahead"), (dict(use_opacity=False), "first-hit")):
        with pytest.raises(NotImplementedError, match=name):
            make_renderer(scene, diff.replace(**kw), 8, 8, backend="slab", device="cpu", differentiable=True)


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
        make_renderer(scene, BASE, 8, 8, backend="ray", device="cpu")


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
