"""CPU tests of the benchmark; tests marked ``cuda`` need a card and skip here."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU with CUDA; skips where torch.cuda.is_available() is false")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def root():
    return ROOT


def tiny(cell, side=16, width=16, height=12):
    """Configuration overrides that shrink a cell to a CPU test's size."""
    return {"volume": dict(cell.config["volume"], side=side), "width": width, "height": height}


#: a fit_ranks cell run by ``ranks_run``
RANKS_CELL = "fit_views4.bonsai256_default"

RANKS_CODE = """
import json, sys, time
from pathlib import Path
sys.path[:0] = [{root!r}, {tests!r}]
from conftest import tiny
from perfbench import calibrate, ranks, spec
cell = spec.load_cell({name!r}, Path({root!r}))
extra = calibrate.control_notes if {control!r} else None
fault = [calibrate.FAULT_HOOK, {fault!r}] if {fault!r} else None
result, notes = ranks.run_cell(cell, dict(cell.config, **tiny(cell)), {seed!r}, {seconds!r}, {traced!r}, "cpu",
                               "slab", time.perf_counter(), overrides=tiny(cell), world={world!r}, fault=fault,
                               extra=extra)
print(json.dumps({{"result": result, "notes": notes}}, default=str))
"""


def ranks_run(root, world, seed=2**31 + 4321, seconds=0.5, traced=False, fault=None, control=False, timeout=300):
    """A fit_ranks cell at a tiny size over ``world`` gloo processes, rank 0
    in a subprocess of its own (a dead worker ends it with ``os._exit``);
    -> (the finished process, its result and notes or None)."""
    code = RANKS_CODE.format(root=str(root), tests=str(Path(__file__).parent), name=RANKS_CELL, seed=seed,
                             seconds=seconds, traced=traced, world=world, fault=fault, control=control)
    env = dict(os.environ, OMP_NUM_THREADS="1")  # one thread a rank: the ranks share the test's cores
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=root)
    lines = proc.stdout.strip().splitlines()
    return proc, (json.loads(lines[-1]) if proc.returncode == 0 and lines else None)
