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


@pytest.mark.cuda
def test_the_ranks_loop_at_a_world_of_one_is_correct_on_the_card(cuda, root):
    """The fit_ranks loop with one rank (a test's override of the mix's 4):
    a NCCL world of one card, the cell's sizes."""
    code = ("import json, sys, time; sys.path.insert(0, %r)\n"
            "from perfbench import ranks, spec\n"
            "cell = spec.load_cell('fit_views4.bonsai256_default', ranks.SCRIPT.parents[1])\n"
            "r, notes = ranks.run_cell(cell, cell.config, %d, 2.0, False, 'cuda', 'slab_cuda', time.perf_counter(),\n"
            "                          world=1)\n"
            "print(json.dumps(r))\n") % (str(root), 2**31 + 6)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["count"] == 1
    assert r["checks"]["replica_gap"]["value"] == 0.0


@pytest.mark.cuda
def test_the_four_card_cell_runs_correct(cuda, root):
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "fit_views4.bonsai256_default", "--seed",
                           str(2**31 + 7), "--seconds", "2", "--trace", "1"], cwd=root, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["count"] == 4
    assert r["metrics"]["allreduce_busbw_pct"]["value"] <= 100
