"""A whole run on the CPU at a tiny size (the card's look skipped): the
result line, the exit without CUDA, and no JAX in the process."""

import json
import subprocess
import sys

import pytest

from conftest import tiny
from perfbench import run, spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, name, trace=False, seconds=0.3, **kw):
    cell = spec.load_cell(name, root)
    return run.run_cell(name, 2**31 + 12345, seconds, trace, device="cpu", backend="slab", overrides=tiny(cell),
                        **kw)[0]


@pytest.mark.parametrize("name", ["fit_views.bonsai256_default", "orbit_view.bonsai256_default"])
def test_result_line_keys(root, name):
    r = _run(root, name)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    cell = spec.load_cell(name, root)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in r["metrics"].values())
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def test_traced_run_reports_per_layer_metrics_it_can_read(root):
    r = _run(root, "orbit_view.bonsai256_default", trace=True)
    # no device trace on the CPU: only the host clock's metrics have something to read
    assert set(r["metrics"]) == {"host_ms.view", "frame_p95_ms.host"}
    assert r["correct"] is True


def test_exits_2_without_cuda_and_prints_no_result(root, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "orbit_view.bonsai256_default", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_jax_loaded_after_the_window_exits_2_and_prints_no_result(root, monkeypatch, capsys):
    """JAX loaded while the reference judges, after the window: no result."""
    import functools

    import torch

    from perfbench import cells

    name = "orbit_view.bonsai256_default"
    cell = spec.load_cell(name, root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", functools.partial(run.run_cell, device="cpu", backend="slab",
                                                           overrides=tiny(cell)))
    numbers = cells.ViewJob.numbers

    def loads_jax(self, *a, **k):
        monkeypatch.setitem(sys.modules, "jax", sys)
        return numbers(self, *a, **k)

    monkeypatch.setattr(cells.ViewJob, "numbers", loads_jax)
    assert run.main(["--workload", name, "--seed", "3", "--seconds", "0.2"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "volym_tpu_torch_like", sys)
    assert "volym_tpu" not in run.forbidden_modules() or "volym_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "volym_tpu.fake", sys)
    assert "volym_tpu" in run.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    code = (
        "import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny\n"
        "from perfbench import run, spec\n"
        "for name in ['fit_views.bonsai256_default', 'orbit_view.teapot256_cone']:\n"
        "    c = spec.load_cell(name, run.ROOT)\n"
        "    ov = tiny(c)\n"
        "    run.run_cell(name, 7, 0.05, False, device='cpu', backend='slab', overrides=ov)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (str(root), str(root / "perfbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=600)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "volym_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)
