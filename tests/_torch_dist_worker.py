"""Subprocess worker for the port's 2-process distributed-launch test.

Run as ``python tests/_torch_dist_worker.py <out.json>`` with the VOLYM_*
env vars set (``tests/test_torch_distributed_launch.py`` spawns two).  It
runs what a single process cannot: ``launch.maybe_initialize`` bringing up
a gloo group across two OS processes, the ``(host, rays)`` mesh over them
(2 virtual CPU shards a process, 4 in all) and ``fit_distributed`` on it.
It imports the port only.
"""

import json
import os
import sys
from datetime import timedelta


def fit_case():
    """(init scene, camera, target, params) of the fit both sides run: the
    16^3 sphere at 16x16 rays, as the JAX package's launch test."""
    import torch

    from volym_tpu_torch import Camera, RenderParams, Scene
    from volym_tpu_torch.render.renderer import make_renderer

    scene = Scene.synthetic("sphere", side=16)
    m = Camera(aspect=1.0, distance=1.1).orbit(25.0, 10.0, 0.0).matrices()
    params = RenderParams(use_gaussian_smoothing=False, raymarching_step_size=0.1, max_steps=40, use_shading=False,
                          adaptive_stepping=False)
    target = make_renderer(scene, params, 16, 16, backend="slab", device="cpu")(m)
    init = Scene(torch.full_like(scene.volume, 0.2), scene.importance, scene.tf_lut)
    return init, m, target, params


def main() -> None:
    out_path = sys.argv[1]
    # python puts the script's directory (tests/) on sys.path, not the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    from volym_tpu_torch import Scene
    from volym_tpu_torch.parallel import launch
    from volym_tpu_torch.parallel import mesh as pmesh
    from volym_tpu_torch.render.renderer import make_renderer

    assert launch.wants_distributed(), "the worker needs the VOLYM_* env vars"
    assert launch.maybe_initialize(device="cpu", timeout=timedelta(seconds=90)), "maybe_initialize must initialise"
    try:
        assert dist.get_world_size() == int(os.environ[launch.ENV_NUM_PROCESSES])
        mesh = pmesh.make_host_mesh([torch.device("cpu")] * 2)
        assert mesh.shape == (2, 2) and [k for k, _ in mesh.local_shards()] == [2 * dist.get_rank(),
                                                                               2 * dist.get_rank() + 1]
        init, m, target, params = fit_case()
        # the frame gathered over both ranks is the single-process frame;
        # differentiable, its gather carries a backward across the ranks
        frame = pmesh.render_sharded(init, m, params, 16, 16, mesh, backend="slab")
        leaf = init.volume.clone().requires_grad_()
        diff_frame = pmesh.render_sharded(Scene(leaf, init.importance, init.tf_lut), m, params, 16, 16, mesh,
                                          differentiable=True, backend="slab")
        diff_frame.sum().backward()
        single = make_renderer(init, params, 16, 16, backend="slab", device="cpu")(m)
        gathered = dict(equal=torch.equal(frame, single), diff_equal=torch.equal(diff_frame.detach(), single),
                        grad_finite=bool(torch.isfinite(leaf.grad).all()) and float(leaf.grad.abs().max()) > 0)
        _, losses = launch.fit_distributed(init, m, target, params, steps=4, lr=0.05, mesh=mesh, backend="slab")
        assert losses[-1] < losses[0], losses
        payload = dict(rank=dist.get_rank(), world=dist.get_world_size(), shards=mesh.size,
                       is_coordinator=launch.is_coordinator(), losses=losses, gathered=gathered)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(payload, f)


if __name__ == "__main__":
    main()
