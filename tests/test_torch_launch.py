"""The port's process-group bootstrap (``volym_tpu_torch.parallel.launch``):
the environment's parsing and ``wants_distributed`` against the JAX
package's functions on the same env dicts, the backend each device takes,
no fallback from CUDA, and a world of one on gloo."""

import socket
import time
from datetime import timedelta

import pytest
import torch
import torch.distributed as dist

from volym_tpu.parallel import launch as jlaunch
from volym_tpu_torch.parallel import launch

VOLYM = {launch.ENV_COORDINATOR: "host0:8476", launch.ENV_NUM_PROCESSES: "2", launch.ENV_PROCESS_ID: "1"}
TORCHRUN = {"MASTER_ADDR": "host0", "MASTER_PORT": "29500", "RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "0"}
#: the JAX kwarg each of the port's stands for
JAX_NAME = {"init_method": "coordinator_address", "world_size": "num_processes", "rank": "process_id"}


@pytest.mark.parametrize("env", [
    {}, VOLYM, {launch.ENV_COORDINATOR: "10.0.0.1:1234"}, {launch.ENV_NUM_PROCESSES: "4"},
    {launch.ENV_FORCE: "1"}, {**VOLYM, launch.ENV_FORCE: "0"},
])
def test_env_parsing_matches_jax(env):
    """Each VOLYM_* variable maps to its kwarg as in the JAX package:
    ``coordinator_address`` -> ``init_method="tcp://..."``, ``num_processes``
    -> ``world_size``, ``process_id`` -> ``rank``."""
    mine, theirs = launch.init_kwargs_from_env(env), jlaunch.init_kwargs_from_env(env)
    assert {JAX_NAME[k] for k in mine} == set(theirs)
    for k, v in mine.items():
        assert v == (f"tcp://{theirs[JAX_NAME[k]]}" if k == "init_method" else theirs[JAX_NAME[k]])
    for flag in (False, True):
        assert launch.wants_distributed(flag, env) == jlaunch.wants_distributed(flag, env)


def test_torchrun_env_is_the_auto_detection():
    """Without VOLYM_* variables torchrun's are read through ``env://`` (the
    JAX package auto-detects a TPU pod there); VOLYM_* take precedence."""
    assert jlaunch.init_kwargs_from_env(TORCHRUN) == {}
    assert launch.init_kwargs_from_env(TORCHRUN) == {"init_method": "env://"}
    assert launch.init_kwargs_from_env({**TORCHRUN, **VOLYM})["init_method"] == "tcp://host0:8476"
    assert not launch.wants_distributed(False, TORCHRUN)


def test_backend_follows_the_device(monkeypatch):
    assert launch.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        launch.backend_for("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.backend_for("cuda")
    # no fallback to gloo: the group is not brought up
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.maybe_initialize(True, device="cuda", env={})
    assert not dist.is_initialized()


def test_no_group_without_the_flag_or_env():
    assert not launch.maybe_initialize(False, device="cpu", env={})
    assert not dist.is_initialized() and launch.is_coordinator()


def test_world_of_one_on_gloo():
    """The flag with neither kind of variable: a world of one on 127.0.0.1;
    a second call leaves the group as it is."""
    try:
        assert launch.maybe_initialize(True, device="cpu", timeout=timedelta(seconds=60), env={})
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1 and dist.get_rank() == 0
        assert launch.is_coordinator() and launch.local_device() == torch.device("cpu")
        assert not launch.maybe_initialize(True, device="cpu", env={})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_missing_peer_times_out():
    """A world of two whose second rank never comes fails within the
    timeout instead of waiting for the default."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {launch.ENV_COORDINATOR: f"127.0.0.1:{port}", launch.ENV_NUM_PROCESSES: "2", launch.ENV_PROCESS_ID: "0"}
    t0 = time.perf_counter()
    try:
        with pytest.raises(dist.DistError):
            launch.maybe_initialize(device="cpu", timeout=timedelta(seconds=3), env=env)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert time.perf_counter() - t0 < 60
