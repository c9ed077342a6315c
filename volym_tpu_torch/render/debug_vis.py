"""Debug views of the t-step march.

Counterpart of :mod:`volym_tpu.render.debug_vis`:

- :func:`importance_debug`: the ``importance_test.wgsl`` smoke kernel
  (``shaders/importance_test.wgsl:42-104``): one sample at the ray-box
  midpoint, red where importance > 0.5, blue where dense but unimportant,
  black elsewhere;
- :func:`debug_matrix`: the legacy kernel's debug texture
  (``shaders/simple_compute.wgsl.bak:184-185``), ray directions as RGB,
  with the march's step count, normalised, in alpha;
- :func:`step_counts` and :func:`step_count_histogram`: how many steps
  each ray marches, the view of early termination's effect.
"""

from __future__ import annotations

import numpy as np
import torch

from volym_tpu_torch.config import RenderParams
from volym_tpu_torch.ops import interp
from volym_tpu_torch.render import golden
from volym_tpu_torch.render import rays as rays_mod

DENSITY_AIR_THRESHOLD = 0.1  # importance_test.wgsl:84
IMPORTANCE_SPLIT = 0.5  # importance_test.wgsl:95


def _rgba(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)[None, :]


def importance_debug(scene, camera_matrices, height: int, width: int) -> torch.Tensor:
    """Red / blue midpoint importance check (``importance_test.wgsl``) ->
    (H, W, 4)."""
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    miss = exit_ <= entry

    mid = origin[None, :] + dirs * ((entry + exit_) * 0.5)[:, None]
    density = interp.sample_nearest(scene.volume, mid)
    importance = interp.sample_nearest(scene.importance, mid)

    red, blue, black = (_rgba(c, dirs.device) for c in ([1.0, 0.0, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0],
                                                        [0.0, 0.0, 0.0, 1.0]))
    col = torch.where((importance > IMPORTANCE_SPLIT)[:, None], red, blue)
    col = torch.where((density > DENSITY_AIR_THRESHOLD)[:, None], col, black)
    col = torch.where(miss[:, None], black, col)
    return col.reshape(height, width, 4)


def debug_matrix(scene, camera_matrices, params: RenderParams, height: int, width: int) -> torch.Tensor:
    """Ray-direction RGB and the golden march's step count over
    ``resolved_max_steps()`` in alpha -> (H, W, 4)."""
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    step_fn, active_mask = golden.make_step_fn(scene, origin, dirs, exit_, camera_matrices.position, params)
    num_steps = params.resolved_max_steps()
    state = golden.init_state(entry, params)
    count = torch.zeros(dirs.shape[:1], dtype=torch.int32, device=dirs.device)
    for _ in range(num_steps):
        count = count + active_mask(state).int()
        state = step_fn(state)
    dir_rgb = dirs * 0.5 + 0.5  # as the ray direction written to the debug texture
    heat = count.float() / torch.tensor(float(num_steps), dtype=torch.float32, device=dirs.device)
    return torch.cat([dir_rgb, heat[:, None]], dim=-1).reshape(height, width, 4)


def step_counts(scene, camera_matrices, params: RenderParams, height: int, width: int) -> torch.Tensor:
    """Each ray's march steps (the data behind :func:`debug_matrix`'s alpha)
    as an (H, W) int32 tensor."""
    img = debug_matrix(scene, camera_matrices, params, height, width)
    return torch.round(img[..., 3] * params.resolved_max_steps()).int()


def step_count_histogram(scene, camera_matrices, params: RenderParams, height: int, width: int, bins: int = 16):
    """How many rays end after how many steps: (edges, counts) numpy arrays
    over [0, ``resolved_max_steps()``]."""
    counts = step_counts(scene, camera_matrices, params, height, width).cpu().numpy()
    hist, edges = np.histogram(counts, bins=bins, range=(0, params.resolved_max_steps()))
    return edges, hist
