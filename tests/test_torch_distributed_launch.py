"""Two OS processes bring up a gloo group through the port's
``launch.maybe_initialize`` (the VOLYM_* env vars) and run
``fit_distributed`` on a ``(host, rays)`` mesh over both: the frame
gathered across them is the single-process frame, the losses are
equal on the two ranks, and equal within rtol 1e-5 / atol 1e-7 (the JAX
package's ``tests/test_distributed_launch.py`` setting) to one process's
fit on 4 virtual shards."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from volym_tpu_torch.parallel import launch
from volym_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_fit_matches_single(tmp_path):
    port = _free_port()
    procs, outs = [], []
    for rank in range(2):
        outs.append(tmp_path / f"rank{rank}.json")
        env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
        env.update({launch.ENV_COORDINATOR: f"127.0.0.1:{port}", launch.ENV_NUM_PROCESSES: "2",
                    launch.ENV_PROCESS_ID: str(rank), "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen([sys.executable, WORKER, str(outs[-1])], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    payloads = sorted((json.loads(out.read_text()) for out in outs), key=lambda d: d["rank"])
    assert [d["rank"] for d in payloads] == [0, 1]
    assert all(d["world"] == 2 and d["shards"] == 4 for d in payloads)
    assert [d["is_coordinator"] for d in payloads] == [True, False]
    # the loss is all-reduced: both ranks hold the same bits
    assert payloads[0]["losses"] == payloads[1]["losses"]
    # the image gathered across the ranks is the single-process frame
    assert all(d["gathered"] == dict(equal=True, diff_equal=True, grad_finite=True) for d in payloads)

    # one process, 4 virtual shards: the same fit up to the sums' order
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from _torch_dist_worker import fit_case

    init, m, target, params = fit_case()
    _, ref_losses = launch.fit_distributed(init, m, target, params, steps=4, lr=0.05, backend="slab",
                                           mesh=pmesh.make_mesh([torch.device("cpu")] * 4))
    np.testing.assert_allclose(payloads[0]["losses"], ref_losses, rtol=1e-5, atol=1e-7)
