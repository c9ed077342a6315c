"""Ray sharding and the distributed training step.

Counterpart of :mod:`volym_tpu.parallel.mesh` on ``torch.distributed``.
The pixel/ray axis is sharded, the scene (volume, importance, TF LUT) is
replicated on every device, and the parameter gradients are summed across
the shards: over a process's own shards on the host, then across processes
by ``all_reduce``.

Torch has no single-process SPMD program over devices, so a :class:`Mesh`
is an ordered list of ray shards: this process's ``local_devices`` times
the process group's ranks.  Shard ``k = rank * len(local_devices) + i`` of
``n`` takes rays ``[k R / n, (k + 1) R / n)`` of the flattened
``pixel_ndc``.  A device may be listed more than once: each entry is a
*virtual shard*, as the JAX package's tests run 8 virtual CPU devices.  A
shard builds only its own rays and marches them as a single-device frame
does (``slab_march.render_rays``, ``golden.march``, ``diff.march_fixed``):
its per-ray table is ``(N_FEATURES, H / n, W)`` when it lands on whole
pixel rows (the CUDA march's 16x16 tiles stay square) and ``(N_FEATURES,
1, R / n)`` otherwise.  The per-scene set-up (permute, plane resample,
gradient field, importance levels) runs once per device and call, not once
per shard.  The TPU's shard layout (``_pallas_shard_march``: window rows,
the 32x32 tile order, the empty pair grid) serves Mosaic and has no
counterpart here.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from volym_tpu_torch.config import RenderParams
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.optim import LEAVES
from volym_tpu_torch.render import diff, golden
from volym_tpu_torch.render import rays as rays_mod
from volym_tpu_torch.render import slab as slab_mod
from volym_tpu_torch.render.renderer import BACKENDS, slab_functions
from volym_tpu_torch.scene import Scene

RAY_AXIS = "rays"


@dataclass(frozen=True)
class Mesh:
    """An ordered list of ray shards (see the module docstring).

    ``local_devices``: this process's shards' devices (repeats are virtual
    shards); ``world`` / ``rank``: the process group's, or 1 / 0 without
    one; ``distributed``: a group was up when the mesh was made, so images
    gather and gradients all-reduce across its ranks."""

    local_devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    world: int = 1
    rank: int = 0
    distributed: bool = False

    @property
    def size(self) -> int:
        return self.world * len(self.local_devices)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.world, len(self.local_devices)) if len(self.axis_names) == 2 else (self.size,)

    def local_shards(self) -> list[tuple[int, torch.device]]:
        """(global shard index, device) of this process's shards, in order."""
        base = self.rank * len(self.local_devices)
        return [(base + i, d) for i, d in enumerate(self.local_devices)]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _mesh(devices, axis_names) -> Mesh:
    from volym_tpu_torch.parallel import launch

    devices = [launch.local_device()] if devices is None else list(devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    up = dist.is_initialized()
    return Mesh(
        local_devices=tuple(_device(d) for d in devices), axis_names=axis_names,
        world=dist.get_world_size() if up else 1, rank=dist.get_rank() if up else 0, distributed=up,
    )


def make_mesh(devices=None, axis_name: str = RAY_AXIS) -> Mesh:
    """1D mesh over the ray axis: ``devices`` (default this process's
    device, :func:`launch.local_device`) on every rank of the process group
    (every rank must list as many)."""
    return _mesh(devices, (axis_name,))


def make_host_mesh(devices=None) -> Mesh:
    """(host, rays) mesh for multi-process runs: outer axis = the process
    group's ranks, inner = this process's ``devices``.  Its shards are
    those of :func:`make_mesh` on the same devices."""
    return _mesh(devices, ("host", RAY_AXIS))


def _ray_count(height: int, width: int, mesh: Mesh) -> int:
    n = mesh.size
    if (height * width) % n:
        raise ValueError(
            f"{height}x{width} rays do not divide evenly over {n} shards; "
            "pad the image height to a multiple of the mesh size"
        )
    return n


def _shard_shape(height: int, width: int, n: int) -> tuple[int, int]:
    """A shard's (rows, columns) in its per-ray table: whole pixel rows
    where its R / n rays are whole rows, else one row."""
    per = height * width // n
    return (per // width, width) if per % width == 0 else (1, per)


def _check_backend(backend: str, mesh: Mesh):
    """The slab backend's functions (None for "ray") for ``mesh``'s devices."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown renderer backend {backend!r}; choose from {BACKENDS}")
    return None if backend == "ray" else slab_functions(backend, mesh.local_devices)


def _shards(mesh: Mesh, height: int, width: int, n: int, setup):
    """This process's shards in order, as ``(device, set-up, rows, ndc,
    shape)``: ``setup(device)`` (run once per device and shared by its
    virtual shards), the shard's slice ``rows`` of the frame's flattened
    rays, their NDC points (the device's :func:`rays.pixel_ndc` rows) and
    their per-ray table shape (:func:`_shard_shape`)."""
    per, shape = height * width // n, _shard_shape(height, width, n)
    done = {}
    for k, device in mesh.local_shards():
        if device not in done:
            done[device] = (setup(device), rays_mod.pixel_ndc(height, width, device))
        made, ndc = done[device]
        rows = slice(k * per, (k + 1) * per)
        yield device, made, rows, ndc[rows], shape


def _shard_image(backend, fns, scene, cm, g, ndc, shape, params, differentiable) -> torch.Tensor:
    """One shard's (R / n, 4) image: its rays through ``ndc`` on ``scene``
    and ``cm`` (on the shard's device) with the backend's march; ``g`` the
    device's slab grids (:func:`slab_march.grids`).  ``params`` is the
    fixed-step set when ``differentiable`` and ``backend == "ray"``."""
    if backend != "ray":
        # the slab march paints the rays that miss the box with the miss colour itself
        if differentiable:
            return slab_march.render_rays_diff(g, cm, params, ndc, shape, *fns).reshape(-1, 4)
        march_fn, _, _, _, gate_fn = fns
        return slab_march.render_rays(g, cm, params, ndc, shape, march_fn, gate_fn).reshape(-1, 4)
    origin, dirs = rays_mod.rays_from_ndc(cm, ndc)
    if differentiable:
        entry, exit_ = diff.ray_box_intersection(origin, dirs)
        img = diff.march_fixed(params, scene.volume, scene.importance, scene.tf_lut, origin, dirs, entry,
                               exit_.detach(), cm.position)
    else:
        entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
        img = golden.march(scene, origin, dirs, entry, exit_, cm.position, params)
    miss = exit_ <= entry
    return torch.where(miss[:, None], golden.miss_color(img.device)[None, :], img)


def _gather(local: torch.Tensor, differentiable: bool) -> torch.Tensor:
    """Every rank's rows of the image, in rank order; through
    ``torch.distributed.nn`` when ``differentiable``, whose backward sums
    the ranks' cotangents of each rank's rows (reduce-scatter)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # newer torch prefers the functional collectives
        if differentiable:
            from torch.distributed.nn import functional as dist_nn

            return torch.cat(dist_nn.all_gather(local))
        out = torch.empty((dist.get_world_size() * local.shape[0], *local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        dist.all_gather_into_tensor(out, local.contiguous())
        return out


def render_sharded(
    scene: Scene,
    camera_matrices,
    params: RenderParams,
    height: int,
    width: int,
    mesh: Mesh,
    differentiable: bool = False,
    backend: str = "ray",
) -> torch.Tensor:
    """Ray-sharded render -> (H, W, 4) on the mesh's first local device:
    rays split across every shard of ``mesh``, the scene replicated, no
    communication but the image's gather across ranks.

    ``backend``: "ray" marches ``golden.march`` (``diff.march_fixed``, the
    step fixed, when ``differentiable``); "slab" the plain slab march;
    "slab_cuda" the CUDA kernels, which need CUDA devices (the JAX
    package's "slab_pallas").  The slab backends take the mode guards of
    the single-device entries: first-hit is forward-only, and the plane
    count comes from ``slab.resolve_planes``.  Ray by ray each shard's
    values are the single-device frame's.  With ``differentiable`` the
    image carries gradients to the scene's tensors on the mesh's devices
    (``scene`` on another device: through its copies) and, across ranks,
    through ``torch.distributed.nn``'s gather."""
    n = _ray_count(height, width, mesh)
    fns = _check_backend(backend, mesh)
    if differentiable:
        (diff if backend == "ray" else slab_march).check_differentiable(params)
        if backend == "ray":
            params = params.replace(adaptive_stepping=False)

    def setup(device):
        sc, cm = scene.to(device), camera_matrices.to(device)
        return sc, cm, None if fns is None else slab_march.grids(sc, cm, params, differentiable)

    img = torch.cat([
        _shard_image(backend, fns, sc, cm, g, ndc, shape, params, differentiable).to(mesh.local_devices[0])
        for _, (sc, cm, g), _, ndc, shape in _shards(mesh, height, width, n, setup)
    ])
    if mesh.distributed:
        img = _gather(img, differentiable)
    return img.reshape(height, width, 4)


def make_train_step(
    params: RenderParams,
    height: int,
    width: int,
    mesh: Mesh,
    backend: str = "ray",
    camera_matrices=None,
    split_psum: bool = False,
):
    """Distributed inverse-rendering step.

    Returns ``step(scene, camera_matrices, target) -> (loss, grads)``: the
    mean squared error of the ray-sharded render (``backend`` as in
    :func:`render_sharded`, the step fixed) against ``target`` (H, W, 4),
    and its gradients for the scene's ``volume``, ``importance`` and
    ``tf_lut``, a :class:`Scene` of three tensors (zeros where no gradient
    flows), all on the mesh's first local device.  Each shard sums its
    squared errors against its target rows (the miss colour painted); a
    device's shards are summed and ``torch.autograd.grad`` runs once per
    device (its set-up is shared, so one backward covers its shards); the
    devices' sums are added, ``all_reduce``'d (SUM) across ranks and
    divided by ``H W 4``, the loss and each gradient alike.

    As in the JAX package, the step clears ``adaptive_stepping`` and
    ``u8_volume`` (a trained volume leaves the u8 grid on its first
    update), first-hit raises ``NotImplementedError``, and the slab
    backends need ``camera_matrices`` at factory time: they march along its
    dominant axis on every call (pose refinement around it stays on it).

    Across ranks the small gradients (importance, TF LUT) are all-reduced
    first, each in its own ``all_reduce`` issued with ``async_op=True``,
    then the loss and the volume's.  ``split_psum`` is accepted for the JAX
    package's signature and changes nothing: there it splits XLA's one
    combined all-reduce into this order, and torch has no all-reduce
    combiner, so this order is the only one."""
    fixed = params.replace(adaptive_stepping=False, u8_volume=False)
    if not (params.use_opacity or params.use_importance_coloring):
        raise NotImplementedError(
            "the first-hit (use_opacity=False) mode is piecewise constant; "
            "differentiable rendering needs use_opacity=True"
        )
    n = _ray_count(height, width, mesh)
    fns = _check_backend(backend, mesh)
    axis = None
    if fns is not None:
        if camera_matrices is None:
            raise ValueError("slab train-step backends need camera_matrices")
        axis = slab_mod.dominant_axis(camera_matrices)
    first = mesh.local_devices[0]

    def step(scene, camera_matrices, target):
        if not isinstance(target, torch.Tensor):
            target = torch.from_numpy(np.array(target, dtype=np.float32))
        target = target.detach().to(torch.float32).reshape(-1, 4)

        def setup(device):
            leaves = [getattr(scene, f).detach().to(device).requires_grad_() for f in LEAVES]
            sc, cm = Scene(*leaves), camera_matrices.to(device)
            g = None if fns is None else slab_march.grids(sc, cm, fixed, differentiable=True, axis=axis)
            return leaves, sc, cm, g

        sums = {}  # device -> (its leaves, its shards' sums of squares)
        for device, (leaves, sc, cm, g), rows, ndc, shape in _shards(mesh, height, width, n, setup):
            img = _shard_image(backend, fns, sc, cm, g, ndc, shape, fixed, True)
            sums.setdefault(device, (leaves, []))[1].append(torch.sum((img - target[rows].to(device)) ** 2))
        loss = grads = None
        for leaves, sq in sums.values():
            dev_sq = sum(sq[1:], sq[0])
            dev_grads = torch.autograd.grad(dev_sq, leaves, allow_unused=True)
            dev_grads = [torch.zeros_like(x) if d is None else d for d, x in zip(dev_grads, leaves)]
            dev_sq, dev_grads = dev_sq.detach().to(first), [d.to(first) for d in dev_grads]
            loss = dev_sq if loss is None else loss + dev_sq
            grads = dev_grads if grads is None else [a + b for a, b in zip(grads, dev_grads)]
        d_vol, d_imp, d_lut = grads
        if mesh.distributed:
            # the small gradients first, so they travel while the volume's
            # is issued; each tensor has its own all-reduce
            pending = [dist.all_reduce(t, op=dist.ReduceOp.SUM, async_op=True) for t in (d_imp, d_lut)]
            for t in (loss, d_vol):
                dist.all_reduce(t, op=dist.ReduceOp.SUM)
            for work in pending:
                work.wait()
        n_pixels = rays_mod.f32_const(float(height * width * 4), first)
        return loss / n_pixels, Scene(volume=d_vol / n_pixels, importance=d_imp / n_pixels, tf_lut=d_lut / n_pixels)

    return step
