"""The port's viewer (``volym_tpu_torch.viewer``) on the CPU: the cases of
the JAX package's ``tests/test_viewer.py`` on the port's server, its query
parsing against the JAX package's on the same queries, ``/frame`` decoded
with ``zlib`` against the renderer's own frame, and the port's HTTP 400
for an unknown renderer."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_entry import read_png
from volym_tpu import RenderParams as JParams
from volym_tpu import viewer as jviewer
from volym_tpu_torch import Scene, convert, viewer
from volym_tpu_torch import io as vio
from volym_tpu_torch.render.renderer import make_renderer

RES = 16
JPARAMS = JParams(use_gaussian_smoothing=False, use_shading=False, raymarching_step_size=0.05, max_steps=60)
PARAMS = convert.render_params(JPARAMS)
QUERIES = [
    {},
    {"use_importance_rendering": ["1"], "use_opacity": ["0"]},
    {"use_cone_importance_check": ["1"]},
    {"use_cone_importance_check": ["true"], "use_importance_rendering": ["True"], "use_shading": ["false"]},
    {"threshold": ["0.3"], "step": ["0.02"], "ahead": ["7.0"], "interpolation": ["trilinear"], "fast_math": ["0"]},
    {"h": ["-40"], "v": ["200"], "dist": ["99"], "mind": ["2"], "maxd": ["5"]},
    {"v": ["-95.5"], "dist": ["0.2"]},
]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    scene = Scene.synthetic("sphere", side=16)
    shots = tmp_path_factory.mktemp("shots")
    srv = viewer.make_server(scene, PARAMS, RES, RES, port=0, screenshot_dir=str(shots), backend="slab",
                             device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, shots, scene
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _get(srv, path):
    host, port = srv.server_address
    return urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60)


def _png(tmp_path, data: bytes) -> np.ndarray:
    path = tmp_path / "frame.png"
    path.write_bytes(data)
    return read_png(path)


def test_index_page(server):
    srv, _, _ = server
    with _get(srv, "/") as r:
        body = r.read().decode()
    assert r.status == 200
    assert "canvas" in body or "img" in body
    assert "__INIT__" not in body  # payload substituted
    assert '"width": 16' in body and '"renderer": "slab"' in body


def test_frame_endpoint_renders(server, tmp_path):
    srv, _, _ = server
    with _get(srv, "/frame?h=30&v=20&dist=1.2&renderer=ray") as r:
        data = r.read()
    assert r.status == 200
    assert data[:4] == b"\x89PNG"
    assert _png(tmp_path, data).shape == (RES, RES, 4)
    assert float(r.headers["X-Render-Ms"]) > 0
    assert len(r.headers["X-Camera-Pos"].split(",")) == 3


@pytest.mark.parametrize("backend", ["slab", "ray"])
def test_frame_slab_backends(server, tmp_path, backend):
    """Each backend's /frame is ``io.to_uint8_image`` of ``make_renderer``'s
    frame of the query's camera and params, bit for bit."""
    srv, _, scene = server
    q = "h=10&v=5&dist=1.1"
    with _get(srv, f"/frame?{q}&renderer={backend}") as r:
        data = r.read()
    assert data[:4] == b"\x89PNG"
    query = {k: [v] for k, v in (kv.split("=") for kv in q.split("&"))}
    cam = viewer.camera_from_query(query, 1.0)
    want = make_renderer(scene, viewer.params_from_query(query, PARAMS), RES, RES, backend=backend,
                         device="cpu")(cam.matrices())
    np.testing.assert_array_equal(_png(tmp_path, data), vio.to_uint8_image(want))


def test_frame_live_knobs_change_image(server):
    srv, _, _ = server
    base = "/frame?h=30&v=20&dist=1.2&renderer=ray&threshold="
    with _get(srv, base + "0.05") as r:
        a = r.read()
    with _get(srv, base + "0.6") as r:
        b = r.read()
    assert a != b  # the knob reached the march


def test_mode_dependency_rules():
    # gui.rs: importance rendering forces opacity on; cone needs imp on
    p = viewer.params_from_query({"use_importance_rendering": ["1"], "use_opacity": ["0"]}, PARAMS)
    assert p.use_opacity and p.use_importance_rendering
    p = viewer.params_from_query({"use_cone_importance_check": ["1"]}, PARAMS)
    assert not p.use_cone_importance_check


def test_camera_clamps():
    cam = viewer.camera_from_query({"v": ["200"], "dist": ["99"]}, 1.0)
    assert cam.vertical_angle == 89.0
    assert cam.distance == 10.0


def test_screenshot_endpoint(server):
    srv, shots, _ = server
    with _get(srv, "/screenshot?h=0&v=0&dist=1.2&renderer=ray") as r:
        meta = json.loads(r.read())
    assert (shots / meta["path"].split("/")[-1]).exists()


def test_unknown_path_404(server):
    srv, _, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, "/nope")
    assert e.value.code == 404


def test_frame_live_resize(server, tmp_path):
    """Per-request render size: pw/ph override the launch resolution,
    clamped and rounded to /8."""
    srv, _, _ = server
    with _get(srv, "/frame?h=30&v=20&dist=1.2&renderer=ray&pw=32&ph=24") as r:
        data = r.read()
    assert r.status == 200
    assert _png(tmp_path, data).shape == (24, 32, 4)
    with _get(srv, "/frame?h=30&v=20&dist=1.2&renderer=ray&pw=70&ph=70") as r:
        data = r.read()
    assert _png(tmp_path, data).shape == (64, 64, 4)


def test_unknown_renderer_400_and_no_cpu_fallback(server):
    """An unknown renderer is a bad request (the JAX package renders "ray"
    for it); ``slab_cuda`` on a CPU server fails, it does not render on the
    CPU."""
    srv, _, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, "/frame?renderer=slab_pallas")
    assert e.value.code == 400 and b"unknown renderer" in e.value.read()
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, "/frame?renderer=slab_cuda")
    assert e.value.code == 500 and b"CUDA" in e.value.read()


@pytest.mark.parametrize("q", QUERIES)
def test_queries_match_jax(q):
    """``params_from_query`` and ``camera_from_query`` as the JAX
    package's on the same query."""
    assert viewer.params_from_query(q, PARAMS) == convert.render_params(jviewer.params_from_query(q, JPARAMS))
    mine, theirs = viewer.camera_from_query(q, 4 / 3), jviewer.camera_from_query(q, 4 / 3)
    for f in ("aspect", "horizontal_angle", "vertical_angle", "distance", "min_distance", "max_distance"):
        assert getattr(mine, f) == getattr(theirs, f), f
    np.testing.assert_array_equal(mine.position, theirs.position)
