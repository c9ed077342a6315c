"""Process-group bootstrap and the distributed training loop.

Counterpart of :mod:`volym_tpu.parallel.launch` on ``torch.distributed``.
Every process runs the same entry point; :func:`maybe_initialize` brings up
the process group before any other device use, from the same environment
variables as the JAX package:

    # host 0
    VOLYM_COORDINATOR=host0:8476 VOLYM_NUM_PROCESSES=2 VOLYM_PROCESS_ID=0 \\
        python -m volym_tpu_torch fit --distributed --renderer slab_cuda ...
    # host 1: the same command with VOLYM_PROCESS_ID=1

Without them it reads torchrun's (``MASTER_ADDR``, ``RANK``,
``WORLD_SIZE``: ``init_method="env://"``), the counterpart of the TPU
pod's auto-detection; with neither, ``--distributed`` brings up a world of
one on 127.0.0.1 at a free port.  The backend follows the device: NCCL for
``cuda`` (each process on ``cuda:{LOCAL_RANK}``, or its rank modulo the
cards it sees), gloo for ``cpu``; no device falls back to another.  Only
rank 0 (:func:`is_coordinator`) writes artifacts.
"""

from __future__ import annotations

import logging
import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

#: env names, in the order (coordinator, num_processes, process_id)
ENV_COORDINATOR = "VOLYM_COORDINATOR"
ENV_NUM_PROCESSES = "VOLYM_NUM_PROCESSES"
ENV_PROCESS_ID = "VOLYM_PROCESS_ID"
ENV_FORCE = "VOLYM_DISTRIBUTED"
#: torchrun's rendezvous variables (``init_method="env://"`` reads them)
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
#: how long the rendezvous and each collective may wait for a peer
DEFAULT_TIMEOUT = timedelta(minutes=5)
#: the process-group backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_kwargs_from_env(env=os.environ) -> dict:
    """``init_process_group`` kwargs from the VOLYM_* env vars:
    ``init_method="tcp://<coordinator>"``, ``world_size`` and ``rank``, each
    from its variable as ``jax.distributed.initialize``'s
    ``coordinator_address``, ``num_processes`` and ``process_id`` are.
    Without any, torchrun's variables give ``init_method="env://"``, and an
    environment with neither gives ``{}``: no layout, which
    :func:`maybe_initialize` takes as a world of one."""
    kwargs = {}
    if env.get(ENV_COORDINATOR):
        kwargs["init_method"] = f"tcp://{env[ENV_COORDINATOR]}"
    if env.get(ENV_NUM_PROCESSES):
        kwargs["world_size"] = int(env[ENV_NUM_PROCESSES])
    if env.get(ENV_PROCESS_ID):
        kwargs["rank"] = int(env[ENV_PROCESS_ID])
    if not kwargs and all(env.get(k) for k in TORCHRUN_ENV):
        kwargs["init_method"] = "env://"
    return kwargs


def wants_distributed(flag: bool = False, env=os.environ) -> bool:
    return bool(
        flag
        or env.get(ENV_COORDINATOR)
        or env.get(ENV_FORCE) == "1"
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device) -> str:
    """The process-group backend for ``device``: NCCL for a CUDA device,
    which needs CUDA (no fallback to gloo), gloo for the CPU."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}; choose from {tuple(BACKENDS)}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"a NCCL group on {device!r} needs CUDA, and torch.cuda.is_available() is False")
    return BACKENDS[kind]


def _local_card(rank: int, env) -> int:
    """This process's card: ``LOCAL_RANK`` (torchrun's), else the rank
    modulo the cards this process sees."""
    if env.get("LOCAL_RANK"):
        return int(env["LOCAL_RANK"])
    return rank % torch.cuda.device_count()


def _check_one_rank_a_card(card: int) -> None:
    """Raise before NCCL's own "duplicate GPU" error when two ranks of the
    group share a card: each rank posts its (host, card) to the group's
    store and reads every other rank's."""
    store = dist.distributed_c10d._get_default_store()
    rank, world = dist.get_rank(), dist.get_world_size()
    mine = f"{socket.gethostname()}:{torch.cuda.get_device_properties(card).uuid}"
    store.set(f"volym_card_{rank}", mine)
    for other in range(world):
        if other != rank and store.get(f"volym_card_{other}").decode() == mine:
            raise RuntimeError(
                f"ranks {min(rank, other)} and {max(rank, other)} of the NCCL group both run on card {card} of "
                f"{socket.gethostname()}: NCCL needs one rank a card (start one process a card, or use "
                "--device cpu for a gloo group)"
            )


def maybe_initialize(flag: bool = False, device="cuda", timeout: timedelta = DEFAULT_TIMEOUT, env=os.environ) -> bool:
    """Env/flag-driven process-group bootstrap; a no-op when no run is
    distributed (:func:`wants_distributed`) or the default group is already
    up (its backend must be ``device``'s).  Returns True when this call
    initialised the group, whose backend is :func:`backend_for` ``device``;
    a CUDA process then runs on its own card, set as the current device.
    ``timeout`` bounds the rendezvous and every collective, so a missing
    peer fails rather than hangs."""
    if not wants_distributed(flag, env):
        return False
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} group is already up; {device!r} needs {backend}")
        return False
    kwargs = init_kwargs_from_env(env)
    if not kwargs:
        kwargs = dict(init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    card = None
    if backend == "nccl":
        card = _local_card(kwargs.get("rank", int(env.get("RANK", 0))), env)
        torch.cuda.set_device(card)
    log.info("torch.distributed.init_process_group(%s, %s)", backend, kwargs)
    dist.init_process_group(backend, timeout=timeout, **kwargs)
    if card is not None:
        _check_one_rank_a_card(card)
    log.info("process group up: rank %d/%d, %s", dist.get_rank(), dist.get_world_size(), local_device())
    return True


def local_device() -> torch.device:
    """This process's device: its card under a NCCL group, the CPU under a
    gloo group, and the current CUDA device without a group (the port's
    entry points run on the card unless asked otherwise)."""
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no process group and no CUDA: pass the devices (e.g. [torch.device('cpu')]) explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def is_coordinator() -> bool:
    """Rank 0 of the default group; True when no group is up."""
    return not dist.is_initialized() or dist.get_rank() == 0


def fit_distributed(
    scene,
    camera_matrices,
    target,
    params,
    *,
    steps: int = 100,
    lr: float = 1e-2,
    mesh=None,
    backend: str = "ray",
    callback=None,
):
    """Inverse-rendering loop over a mesh: the sharded train step
    (:func:`volym_tpu_torch.parallel.mesh.make_train_step`) and Adam on the
    volume and the TF LUT (``torch.optim.Adam``'s defaults are optax's
    ``adam``: b1 0.9, b2 0.999, eps 1e-8 after the square root, the same
    bias correction; no projection, as in the JAX package's loop).  Works
    alike on one process (a ``rays`` mesh) and N (a ``(host, rays)`` mesh).
    ``callback(i, loss)`` follows each step.  Returns (fitted scene on the
    mesh's first local device, losses)."""
    from volym_tpu_torch.parallel import mesh as pmesh
    from volym_tpu_torch.scene import Scene

    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = pmesh.make_host_mesh() if world > 1 else pmesh.make_mesh()
    height, width = target.shape[:2]
    step_fn = pmesh.make_train_step(
        params, height, width, mesh, backend=backend, camera_matrices=camera_matrices,
    )
    device = mesh.local_devices[0]
    volume = scene.volume.detach().to(device).clone().requires_grad_()
    tf_lut = scene.tf_lut.detach().to(device).clone().requires_grad_()
    importance = scene.importance.detach().to(device)
    opt = torch.optim.Adam([volume, tf_lut], lr=lr)
    losses = []
    for i in range(steps):
        loss, grads = step_fn(Scene(volume.detach(), importance, tf_lut.detach()), camera_matrices, target)
        volume.grad, tf_lut.grad = grads.volume, grads.tf_lut
        opt.step()
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1])
    return Scene(volume=volume.detach(), importance=importance, tf_lut=tf_lut.detach()), losses
