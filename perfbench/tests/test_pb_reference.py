"""The frozen plain reference against the port's plain ``slab`` backend at
32^3 on the CPU.  The test imports the port; the reference may not."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import inputs, reference, spec, traffic

SIDE, W, H = 32, 32, 24


def _scene_and_cams(root, name, seed=1234567890123):
    from volym_tpu_torch.config import RenderParams

    cell = spec.load_cell(name, root)
    vol, imp, _ = inputs.make_volume(dict(cell.config["volume"], side=SIDE), seed, "cpu")
    lut = torch.as_tensor(inputs.default_lut())
    views = traffic.Views(cell.traffic, seed)
    cams = [inputs.orbit_matrices(*views.angles(i), cell.config["camera"], W / H) for i in range(4)]
    cams += [inputs.orbit_matrices(az, 25.0, cell.config["camera"], W / H) for az in (0.0, 90.0, 180.0, 270.0)]
    return cell, vol, imp, lut, cams, RenderParams(**cell.config["params"])


def _port_cm(m):
    from volym_tpu_torch.camera import CameraMatrices

    return CameraMatrices(*(torch.from_numpy(np.asarray(m[k], np.float32))
                            for k in ("view", "proj", "inverse_view_proj", "position")))


#: the cells' parameters, and the modes a later configuration can take as data:
#: trilinear sampling (smoothed and not) and the straight look-ahead gate
VARIANTS = [
    ("orbit_view.bonsai256_default", {}),
    ("orbit_view.teapot256_cone", {}),
    ("orbit_view.bonsai256_default", {"interpolation": "trilinear"}),
    ("orbit_view.teapot256_cone", {"interpolation": "trilinear", "use_cone_importance_check": False}),
]


@pytest.mark.parametrize("name,changes", VARIANTS, ids=["bonsai", "teapot_cone", "bonsai_trilinear", "teapot_straight"])
def test_frames_equal_the_port_plain_backend(root, name, changes):
    from volym_tpu_torch.render.renderer import make_renderer
    from volym_tpu_torch.scene import Scene

    cell, vol, imp, lut, cams, params = _scene_and_cams(root, name)
    params = params.replace(**changes)
    render = make_renderer(Scene(volume=vol, importance=imp, tf_lut=lut), params, H, W, backend="slab", device="cpu")
    p = reference.Params.from_config(dict(cell.config["params"], **changes))
    for m in cams:
        want = render(_port_cm(m))
        got, counts = reference.render(vol, imp, lut, m, p, H, W, rows_per_block=7)
        assert torch.equal(got, want)
        assert 0 < counts["composited_steps"] <= counts["live_steps"]


def test_gradients_match_the_port_plain_backward(root):
    from volym_tpu_torch import optim
    from volym_tpu_torch.render.renderer import make_renderer
    from volym_tpu_torch.scene import Scene

    cell, vol, imp, lut, cams, params = _scene_and_cams(root, "fit_views.bonsai256_default")
    p = reference.Params.from_config(cell.config["params"])
    start_lut = lut.clone()
    start_lut[:, 3] *= 0.9
    for m in cams[:3] + cams[4:]:
        target, _ = reference.render(vol, imp, lut, m, p, H, W)
        leaves = {"volume": vol.clone().requires_grad_(), "tf_lut": start_lut.clone().requires_grad_()}
        render = make_renderer(Scene(importance=imp, **leaves), params, H, W, backend="slab", device="cpu",
                               differentiable=True)
        loss = optim.l2_image_loss(render(_port_cm(m)), target)
        loss.backward()
        r_loss, d_vol, d_lut, _, _ = reference.loss_and_grads(vol, imp, start_lut, m, target, p, H, W, rows_per_block=5)
        assert r_loss == pytest.approx(float(loss.detach()), rel=1e-6)
        for a, b in ((leaves["volume"].grad, d_vol), (leaves["tf_lut"].grad, d_lut)):
            scale = float(b.abs().max())
            assert scale > 0
            assert float((a - b).abs().max()) <= 1e-5 * scale


def test_the_reference_imports_nothing_of_the_program_or_jax(root):
    code = ("import sys; sys.path.insert(0, %r); import perfbench.reference, perfbench.inputs, perfbench.work, "
            "perfbench.check, perfbench.trace, perfbench.traffic, perfbench.stats; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"volym_tpu_torch", "volym_tpu", "jax", "jaxlib", "flax"}


def test_the_control_in_bfloat16_reads_off(root):
    cell, vol, imp, lut, cams, _ = _scene_and_cams(root, "orbit_view.bonsai256_default")
    p = reference.Params.from_config(cell.config["params"])
    want, _ = reference.render(vol, imp, lut, cams[0], p, H, W)
    got, _ = reference.render(vol, imp, lut, cams[0], p, H, W, dtype=torch.bfloat16)
    assert float((got - want).abs().max()) > 1e-2
