"""The slab march on the GPU: the per-ray table, the CUDA kernel's wrapper,
the production render and the differentiable render.

Counterpart of :mod:`volym_tpu.ops.slab_kernel` (base and shading modes,
forward with or without the importance look-ahead gate of
:mod:`volym_tpu_torch.ops.lookahead`, and, through :class:`DiffMarch`, the
backward without camera gradients or look-ahead).  The TPU kernel
``_march_kernel`` samples with hat-matrix products
on the MXU over a grid of (ray chunk, slab block) pairs; the CUDA kernel
(``csrc/slab_march.cu``) marches one ray per thread with direct texel
loads and needs none of that machinery: no pair grid, tile order, window
ladders, grouped LUT or VMEM sizing.  What it keeps is the semantics: the
per-ray affine table computed once in torch (:func:`features_from_rays`),
the subtexel snap, the masks and the u8 scaled density domain.

:func:`march` dispatches on the device of its tensors: CPU tensors go to
the plain version :func:`volym_tpu_torch.render.slab.march_slabs`; CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from volym_tpu_torch.config import Interpolation, RenderParams
from volym_tpu_torch.ops import lookahead, slab_replay
from volym_tpu_torch.render import rays as rays_mod
from volym_tpu_torch.render import slab as slab_mod
from volym_tpu_torch.render.golden import CONE_SAMPLES, cone_directions
from volym_tpu_torch.render.slab import (
    CF_STRIDE, CONE_FEATURES, F_AEXP, F_C2, F_CB, F_CD, F_CS, F_ENTRY, F_EXIT, F_HX, F_HY, F_HZ, F_RB, F_RS,
    F_SIGNOK, F_TB, F_TS, N_FEATURES,
)

#: launches of the CUDA march kernel in this process (see :func:`march_cuda`)
LAUNCHES = 0

#: the largest LUT the kernel stages in shared memory (48 KB: the dynamic
#: shared memory a block gets without opting in to more)
MAX_LUT_ENTRIES = 48 * 1024 // 16


def features_from_rays(origin, dirs, entry, exit_, n_slabs: int, major: int, sign: int, n_plane=None) -> torch.Tensor:
    """The (N_FEATURES, R) per-ray table from a ray bundle.  The affine
    coefficients come from :func:`slab.ray_affine`, the one definition the
    plain march and the kernel both read."""
    d_m = dirs[:, major]
    rs, rb, cs, cb, ts, tb = slab_mod.ray_affine(origin, dirs, n_slabs, major, sign, n_plane=n_plane)
    aexp = torch.full_like(d_m, 1.0 / n_slabs) / torch.clamp(torch.abs(d_m), min=1e-12) * 100.0
    signok = ((d_m * sign) > 0.0).float()
    # Blinn-Phong half vector: eye = normalize(cam - pos) = -dirs exactly
    light = 1.0 / rays_mod.sqrt_rn(torch.tensor(3.0, dtype=torch.float32, device=dirs.device))
    half = -dirs + light
    half = half / rays_mod.norm3(half)
    # cam.dir: JAX's ``dirs @ origin`` on the CPU is a chain of fused
    # multiply-adds in component order, written out here
    cd = rays_mod.fma_rn(dirs[:, 2], origin[2], rays_mod.fma_rn(dirs[:, 1], origin[1], dirs[:, 0] * origin[0]))
    c2 = (origin[0] * origin[0] + origin[1] * origin[1]) + origin[2] * origin[2]
    feats = torch.empty((N_FEATURES, dirs.shape[0]), dtype=torch.float32, device=dirs.device)
    for i, v in (
        (F_RS, rs), (F_RB, rb), (F_CS, cs), (F_CB, cb), (F_TS, ts), (F_TB, tb),
        (F_ENTRY, entry), (F_EXIT, exit_), (F_AEXP, aexp), (F_SIGNOK, signok),
        (F_HX, half[:, 0]), (F_HY, half[:, 1]), (F_HZ, half[:, 2]), (F_CD, cd), (F_C2, c2),
    ):
        feats[i] = v
    return feats


def cone_features_from_rays(origin, dirs, n_slabs: int, major: int, sign: int, n_plane=None) -> torch.Tensor:
    """The (CONE_FEATURES, R) cone look-ahead table: for each of the
    :func:`cone_directions` of each ray, the affine coefficients of
    :func:`slab.ray_affine` along that direction (re-anchored at the camera)
    and its rate ``d_m * n_slabs * sign``, march steps per unit distance
    (the counterpart of ``slab_kernel.cone_features_from_rays``)."""
    r = dirs.shape[0]
    cdirs = cone_directions(dirs).reshape(r * CONE_SAMPLES, 3)
    coeffs = slab_mod.ray_affine(origin, cdirs, n_slabs, major, sign, n_plane=n_plane)
    rate = cdirs[:, major] * n_slabs * sign
    table = torch.stack([*coeffs, rate])  # (CF_STRIDE, R * CONE_SAMPLES)
    return table.reshape(CF_STRIDE, r, CONE_SAMPLES).permute(2, 0, 1).reshape(CONE_FEATURES, r)


def u8_active(params: RenderParams, planes: int, n: int) -> bool:
    """Whether the march runs the u8 scaled domain: asked for, on the
    native plane count (resampled planes are not u8-representable), and
    with snapped or nearest sampling (the TPU kernel's exactness
    condition, kept so both packages pick the same domain)."""
    return bool(
        params.u8_volume
        and planes == n
        and (params.subtexel_bits > 0 or params.interpolation != Interpolation.TRILINEAR)
    )


def check_supported(params: RenderParams) -> None:
    """Raise for the render modes this package does not implement yet."""
    missing = [
        name
        for name, on in (
            ("Gaussian smoothing (use_gaussian_smoothing; CLI --no-gaussian)", params.use_gaussian_smoothing),
            ("importance coloring (use_importance_coloring)", params.use_importance_coloring),
            ("first-hit (use_opacity=False)", not params.use_opacity),
        )
        if on
    ]
    if missing:
        raise NotImplementedError(
            "not ported to volym_tpu_torch yet: " + ", ".join(missing)
        )


def _library():
    from volym_tpu_torch.ops import _build

    lib = _build.library("slab_march")
    fn = lib.slab_march_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        f = ctypes.c_float
        fn.argtypes = [p] * 7 + [i] * 12 + [f, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def march_cuda(
    feats: torch.Tensor,
    vol_perm: torch.Tensor,
    lut: torch.Tensor,
    sign: int,
    params: RenderParams,
    grad_perm: torch.Tensor | None = None,
    u8: bool = False,
    emit_density: bool = False,
    gate: torch.Tensor | None = None,
):
    """Launch the CUDA march kernel; same arguments and result as
    :func:`slab.march_slabs`, except that ``gate`` is the packed gate of
    :func:`lookahead.gate_cuda` (int32 (ceil(N/32), H, W), bit j % 32 of
    word j // 32 for march step j).  With ``emit_density`` the residual is
    zero-filled here (``torch.zeros``) and the kernel writes the steps it
    samples."""
    global LAUNCHES
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"march_cuda needs CUDA tensors, got {dev}")
    if gate is not None and emit_density:
        raise NotImplementedError("the stored-density residual with a look-ahead gate is not ported yet")
    shading = params.use_shading
    tensors = [("feats", feats), ("vol_perm", vol_perm), ("lut", lut)]
    if shading:
        if grad_perm is None:
            raise ValueError("shading needs the permuted gradient field")
        tensors.append(("grad_perm", grad_perm))
    if gate is not None:
        tensors.append(("gate", gate))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_f, height, width = feats.shape
    n, nr, nc = vol_perm.shape
    ln = lut.shape[0]
    if n_f != N_FEATURES or feats.dtype != torch.float32:
        raise ValueError(f"feats must be float32 ({N_FEATURES}, H, W), got {feats.dtype} {tuple(feats.shape)}")
    if vol_perm.dtype != (torch.uint8 if u8 else torch.float32):
        raise ValueError(f"vol_perm dtype {vol_perm.dtype} does not match u8={u8}")
    if lut.dtype != torch.float32 or lut.shape != (ln, 4) or not 1 <= ln <= MAX_LUT_ENTRIES:
        raise ValueError(f"lut must be float32 (N<={MAX_LUT_ENTRIES}, 4), got {lut.dtype} {tuple(lut.shape)}")
    if shading and (grad_perm.dtype != torch.float32 or grad_perm.shape != (3, n, nr, nc)):
        raise ValueError(f"grad_perm must be float32 (3, {n}, {nr}, {nc})")
    if gate is not None and (gate.dtype != torch.int32 or gate.shape != (lookahead.gate_words(n), height, width)):
        raise ValueError(f"gate must be int32 ({lookahead.gate_words(n)}, {height}, {width}), got {gate.dtype} "
                         f"{tuple(gate.shape)}")
    threshold, early_alpha, dscale = slab_mod.march_knobs(params, u8)
    tf_scale = float(ln) * (dscale if dscale else 1.0)
    out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    dens = None
    if emit_density:
        dens = torch.zeros(
            (n, 4, height, width) if shading else (n, height, width), dtype=torch.float32, device=dev
        )
    fn = _library()
    with torch.cuda.device(dev):
        rc = fn(
            feats.data_ptr(), vol_perm.data_ptr(), grad_perm.data_ptr() if shading else None,
            lut.data_ptr(), out.data_ptr(), dens.data_ptr() if emit_density else None,
            gate.data_ptr() if gate is not None else None,
            height, width, n, nr, nc, ln, int(sign), int(params.subtexel_bits),
            int(params.interpolation == Interpolation.TRILINEAR), int(u8), int(shading), int(emit_density),
            threshold, early_alpha, tf_scale,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"slab_march kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return (out, dens) if emit_density else out


def march(feats, vol_perm, lut, sign, params, grad_perm=None, u8=False, emit_density=False, gate=None):
    """The slab march on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (no fallback between them).
    ``gate`` is what :func:`lookahead.gate` returns on the same device."""
    if feats.device.type == "cpu":
        return slab_mod.march_slabs(feats, vol_perm, lut, sign, params, grad_perm, u8, emit_density, gate)
    return march_cuda(feats, vol_perm, lut, sign, params, grad_perm, u8, emit_density, gate)


def _layout(scene, camera_matrices, params: RenderParams):
    """(major axis, march sign, sample-plane count, u8 domain) of a frame."""
    major, sign = slab_mod.dominant_axis(camera_matrices)
    n = scene.volume.shape[0]
    planes = slab_mod.resolve_planes(params, n)
    return major, sign, planes, u8_active(params, planes, n)


def _gradient_perm(volume: torch.Tensor, major: int, planes: int) -> torch.Tensor:
    """The permuted, plane-resampled gradient field of ``volume``."""
    return slab_mod.slab_resample_grad(
        slab_mod.permute_gradient(slab_mod.gradient_volume(volume), major), planes
    ).contiguous()


def _features(camera_matrices, device, height, width, planes, major, sign, n_plane) -> torch.Tensor:
    """The (N_FEATURES, H, W) per-ray table of a frame."""
    origin, dirs = rays_mod.generate_rays(camera_matrices.to(device), height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    feats = features_from_rays(origin, dirs, entry, exit_, planes, major, sign, n_plane=n_plane)
    return feats.reshape(N_FEATURES, height, width)


def lookahead_active(params: RenderParams) -> bool:
    """Whether a render gates its march on importance look-ahead."""
    return bool(params.use_importance_rendering and not params.use_importance_coloring)


def lookahead_inputs(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """The gate's inputs besides the per-ray table: ``(cone_feats, levels)``,
    the (CONE_FEATURES, H, W) cone table (None for the straight variant)
    and the uint8 importance levels of the permuted grid, resampled nearest
    to the march's plane count (``slab_kernel.py:2329-2364``)."""
    major, sign, planes, _ = _layout(scene, camera_matrices, params)
    imp_perm = slab_mod.slab_resample_nearest(slab_mod.permute_volume(scene.importance, major), planes)
    cone_feats = None
    if params.use_cone_importance_check:
        origin, dirs = rays_mod.generate_rays(camera_matrices.to(scene.device), height, width)
        cone_feats = cone_features_from_rays(origin, dirs, planes, major, sign, n_plane=imp_perm.shape[1])
        cone_feats = cone_feats.reshape(CONE_FEATURES, height, width)
    return cone_feats, slab_mod.importance_levels(imp_perm)


def prepare(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """The march's inputs for one frame: ``(feats, vol_perm, lut, sign,
    grad_perm, u8)`` on the scene's device."""
    check_supported(params)
    major, sign, planes, u8 = _layout(scene, camera_matrices, params)
    if u8:
        if scene.volume_u8 is None:
            raise ValueError("u8_volume needs a scene with a uint8 volume (Scene.from_uint8)")
        vol_perm = slab_mod.permute_volume(scene.volume_u8, major)
    else:
        vol_perm = slab_mod.slab_resample(slab_mod.permute_volume(scene.volume, major), planes)
    grad_perm = _gradient_perm(scene.volume, major, planes) if params.use_shading else None
    feats = _features(camera_matrices, scene.device, height, width, planes, major, sign, vol_perm.shape[1])
    return feats, vol_perm.contiguous(), scene.tf_lut.contiguous(), sign, grad_perm, u8


def render(
    scene, camera_matrices, params: RenderParams, height: int, width: int, march_fn=march, gate_fn=lookahead.gate
) -> torch.Tensor:
    """Slab-marching render -> (H, W, 4) on the scene's device, through
    ``march_fn`` (default :func:`march`: the CUDA kernel on a GPU).  With
    importance look-ahead (:func:`lookahead_active`) the march is gated by
    ``gate_fn`` (default :func:`lookahead.gate`: the CUDA gate kernels on a
    GPU), whose gate ``march_fn`` takes; ``importance_check_ahead_steps``
    has no effect here, as on the JAX package's slab paths."""
    feats, vol_perm, lut, sign, grad_perm, u8 = prepare(scene, camera_matrices, params, height, width)
    gate = None
    if lookahead_active(params):
        cone_feats, levels = lookahead_inputs(scene, camera_matrices, params, height, width)
        gate = gate_fn(feats, cone_feats, levels, sign, params.subtexel_bits)
    return march_fn(feats, vol_perm, lut, sign, params, grad_perm, u8=u8, gate=gate)


def check_differentiable(params: RenderParams) -> None:
    """Raise for the modes the differentiable render does not implement
    yet: those of :func:`check_supported`, camera gradients and
    importance look-ahead."""
    if params.camera_grads:
        raise NotImplementedError(
            "not ported to volym_tpu_torch yet: camera gradients (camera_grads=True; "
            "pass camera_grads=False for scene-only gradients)"
        )
    check_supported(params)
    if lookahead_active(params):
        raise NotImplementedError(
            "not ported to volym_tpu_torch yet: importance look-ahead in the differentiable render "
            "(its backward, the replay gated by the same look-ahead gate, is the next slice of the port)"
        )


class DiffMarch(torch.autograd.Function):
    """The differentiable slab march: the counterpart of the TPU package's
    custom VJPs ``march_pallas`` and ``march_pallas_shaded``.

    Forward: the march (B1), which also stores the density residual when
    :func:`slab_replay.use_stored_density` holds.  Backward: the replay
    with its fused voxel scatter (B2), into d ``vol_perm``, d ``lut`` and,
    shaded, d ``grad_perm``; ``feats`` gets none (no camera gradients).
    In the u8 domain the march reads ``round(vol_perm * 255)`` as uint8
    and the replay's d/d(scaled density) is multiplied by 255.  The march
    and the replay are ``march_fn`` and ``replay_fn`` (:func:`march` and
    :func:`slab_replay.replay` dispatch on the tensors' device).
    """

    @staticmethod
    def forward(ctx, vol_perm, lut, grad_perm, feats, sign, params, u8, march_fn, replay_fn):
        if u8:
            vol = torch.round(vol_perm * 255.0).clamp_(0.0, 255.0).to(torch.uint8).contiguous()
        else:
            vol = vol_perm.contiguous()
        lut = lut.contiguous()
        stored = slab_replay.use_stored_density(params, vol.shape[0], feats.shape[1] * feats.shape[2])
        res = march_fn(feats, vol, lut, sign, params, grad_perm, u8, emit_density=stored)
        out, dens = res if stored else (res, None)
        ctx.save_for_backward(feats, vol, lut, grad_perm, out, dens)
        ctx.sign, ctx.params, ctx.u8, ctx.replay_fn = sign, params, u8, replay_fn
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_img):
        feats, vol, lut, grad_perm, out, dens = ctx.saved_tensors
        d_vol, d_grad, d_lut = ctx.replay_fn(
            feats, vol, lut, ctx.sign, ctx.params, out, g_img.contiguous(), grad_perm, ctx.u8, dens
        )
        if ctx.u8:
            d_vol = d_vol * 255.0  # d/d(scaled density) -> d/d(v/255 volume)
        return d_vol, d_lut, d_grad, None, None, None, None, None, None


def render_diff(
    scene, camera_matrices, params: RenderParams, height: int, width: int, march_fn=march, replay_fn=slab_replay.replay
):
    """Differentiable slab render -> (H, W, 4) on the scene's device, the
    counterpart of ``slab_kernel.render_diff``.  Gradients reach
    ``scene.volume`` and ``scene.tf_lut`` through ``torch.autograd``: the
    permute, the plane resample and the gradient field stay in the graph,
    and :class:`DiffMarch` is the march and its replay, through
    ``march_fn`` and ``replay_fn`` (default: the CUDA kernels on a GPU).

    In the u8 domain (:func:`u8_active`) the uint8 grid is derived from the
    differentiable volume on every call, ``round(volume * 255)``, so a
    volume that is not u8-representable is quantised silently, as in the
    TPU package (and values outside [0, 1] are clamped to it);
    ``scene.volume_u8`` is not read.  Camera gradients, smoothing,
    coloring, look-ahead and first-hit raise ``NotImplementedError``.
    """
    check_differentiable(params)
    major, sign, planes, u8 = _layout(scene, camera_matrices, params)
    vol_perm = slab_mod.slab_resample(slab_mod.permute_volume(scene.volume, major), planes)
    grad_perm = _gradient_perm(scene.volume, major, planes) if params.use_shading else None
    with torch.no_grad():
        feats = _features(camera_matrices, scene.device, height, width, planes, major, sign, vol_perm.shape[1])
    return DiffMarch.apply(vol_perm, scene.tf_lut, grad_perm, feats, sign, params, u8, march_fn, replay_fn)
