"""On the card: each cell runs through the command line and comes out
correct (``python -m pytest perfbench/tests -m cuda`` on a machine with an
H100; skipped where there is no CUDA device)."""

import json
import subprocess
import sys

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fit_views.bonsai256_default", "orbit_view.teapot256_cone",
                                  "orbit_view.bonsai256_default"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cuda, root, name, trace):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed", str(2**31 + 5),
                           "--seconds", "2", "--trace", str(trace)], cwd=root, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert all(v["value"] <= 105 for k, v in r["metrics"].items() if "roofline" in k or "mfu" in k)
