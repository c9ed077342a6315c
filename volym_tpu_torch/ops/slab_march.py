"""The slab march on the GPU: the per-ray table, the CUDA kernel's wrapper,
the production render and the differentiable render.

Counterpart of :mod:`volym_tpu.ops.slab_kernel` in every mode: base,
shading, Gaussian smoothing, importance coloring and first-hit, forward
with or without the importance look-ahead gate of
:mod:`volym_tpu_torch.ops.lookahead`, and, through :class:`DiffMarch`, the
backward with camera gradients, the look-ahead gate and importance
coloring's d_importance (first-hit is forward-only, as in the JAX
package).
The TPU kernel ``_march_kernel`` samples with hat-matrix products
on the MXU over a grid of (ray chunk, slab block) pairs; the CUDA kernel
(``csrc/slab_march.cu``) marches a tile of rays a block, one ray a thread,
in batches of steps whose slab windows it stages in shared memory
(:func:`stage_plan` transcribes how it picks them), and needs none of the
TPU's machinery: no pair grid, tile order, window ladders, grouped LUT or
VMEM sizing.  What it keeps is the semantics: the per-ray affine table
computed once a frame (:func:`features_from_rays`; on a GPU one launch of
:mod:`volym_tpu_torch.ops.ray_table`'s kernel), the subtexel snap, the
masks, the smoothing stencil and the u8 scaled density domain.

:func:`march` dispatches on the device of its tensors: CPU tensors go to
the plain version :func:`volym_tpu_torch.render.slab.march_slabs`; CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from volym_tpu_torch.config import Interpolation, RenderParams
from volym_tpu_torch.ops import feats_grad, lookahead, ray_table, slab_replay, voxel_grad
from volym_tpu_torch.render import rays as rays_mod
from volym_tpu_torch.render import slab as slab_mod
from volym_tpu_torch.render.golden import CONE_SAMPLES, cone_directions
from volym_tpu_torch.render.slab import (
    CF_STRIDE, CONE_FEATURES, F_AEXP, F_C2, F_CB, F_CD, F_CS, F_ENTRY, F_EXIT, F_HX, F_HY, F_HZ, F_RB, F_RS,
    F_SIGNOK, F_TB, F_TS, N_FEATURES,
)
from volym_tpu_torch.tracing import span

#: launches of the CUDA march kernel in this process (see :func:`march_cuda`)
LAUNCHES = 0

#: the largest LUT the kernel stages in shared memory (48 KB)
MAX_LUT_ENTRIES = 48 * 1024 // 16

#: the CUDA march's tile of rays a block (width, height), steps a batch on
#: the f32 and the u8 stream, and bytes of each of its two stage buffers
#: (csrc/slab_march.cu's defaults)
MARCH_TILE_W, MARCH_TILE_H, MARCH_BATCH, MARCH_BATCH_U8, STAGE_BYTES = 16, 16, 8, 16, 16384


def features_from_rays(origin, dirs, entry, exit_, n_slabs: int, major: int, sign: int, n_plane=None) -> torch.Tensor:
    """The (N_FEATURES, R) per-ray table from a ray bundle.  The affine
    coefficients come from :func:`slab.ray_affine`, the one definition the
    plain march and the kernel both read.  Differentiable in ``origin`` and
    ``dirs`` (the camera gradients' last leg), except the rows that enter
    only masks and the look-ahead gate, whose derivative is zero almost
    everywhere: ``F_ENTRY``/``F_EXIT`` (the ray-box division's backward
    would turn their zero cotangent into 0 * inf, a NaN, on a ray with an
    exactly zero direction component) and ``F_CD``/``F_C2`` (whose
    correctly rounded dot has no derivative)."""
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
    o, dr = origin.detach(), dirs.detach()
    cd = rays_mod.fma_rn(dr[:, 2], o[2], rays_mod.fma_rn(dr[:, 1], o[1], dr[:, 0] * o[0]))
    c2 = (o[0] * o[0] + o[1] * o[1]) + o[2] * o[2]
    feats = torch.empty((N_FEATURES, dirs.shape[0]), dtype=torch.float32, device=dirs.device)
    for i, v in (
        (F_RS, rs), (F_RB, rb), (F_CS, cs), (F_CB, cb), (F_TS, ts), (F_TB, tb),
        (F_ENTRY, entry.detach()), (F_EXIT, exit_.detach()), (F_AEXP, aexp), (F_SIGNOK, signok),
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
    """Whether the march runs the u8 scaled domain: asked for, without
    camera cotangents (their coordinate chain reads the f32 slices), on the
    native plane count (resampled planes are not u8-representable), and
    with snapped or nearest sampling (the TPU kernel's exactness
    condition, kept so both packages pick the same domain,
    ``slab_kernel._u8_active``).  The forward render clears
    ``camera_grads`` first (:func:`prepare`), as the JAX package's
    ``render`` does, so a frame's stream never depends on it."""
    return bool(
        params.u8_volume
        and not params.camera_grads
        and planes == n
        and (params.subtexel_bits > 0 or params.interpolation != Interpolation.TRILINEAR)
    )


@dataclass(frozen=True)
class StagePlan:
    """The CUDA march's plan of a launch, (batch, block) tensors: whether
    the block composites the batch (``visited``), its density and aux
    windows (``dens_box``/``grad_box``: (..., 4) int64 rows r0..r1, columns
    c0..c1, inclusive; ``r0 > r1`` when nothing is read; the aux window
    holds the gradient field's channels when shaded and the importance
    under coloring, both sampled at the step's own coordinates) and whether
    each is staged in shared memory or read from global memory.  Blocks are
    numbered row-major over the image's tiles."""

    visited: torch.Tensor
    dens_box: torch.Tensor
    grad_box: torch.Tensor
    dens_staged: torch.Tensor
    grad_staged: torch.Tensor

    def counts(self) -> tuple[int, int]:
        """(staged, direct): the visited (block, batch) pairs that read
        densities, by the route their density window takes."""
        reads = self.visited & (self.dens_box[..., 0] <= self.dens_box[..., 1])
        return int((reads & self.dens_staged).sum()), int((reads & ~self.dens_staged).sum())


def _tiles(v: torch.Tensor, tile: tuple[int, int], fill) -> torch.Tensor:
    """(..., H, W) -> (..., blocks, tile rays), the image padded with
    ``fill`` to whole tiles, blocks row-major and rays row-major in a tile."""
    tw, th = tile
    height, width = v.shape[-2:]
    ph, pw = -height % th, -width % tw
    v = torch.nn.functional.pad(v, (0, pw, 0, ph), value=fill) if ph or pw else v
    by, bx = v.shape[-2] // th, v.shape[-1] // tw
    v = v.reshape(*v.shape[:-2], by, th, bx, tw).movedim(-3, -2)
    return v.reshape(*v.shape[:-4], by * bx, th * tw)


def _spans(s: torch.Tensor, b: torch.Tensor, steps: torch.Tensor, n_tex: int, bits: int, bilinear: bool):
    """The texel span [lo, hi] a sample at march step ``steps`` reads
    along one axis: the kernel's tap_span of its snapped coordinate."""
    c = slab_mod.snap(torch.clamp(s * steps.float() + b, 0.0, n_tex - 1.0), bits)
    if bilinear:
        f = torch.floor(c)
        return torch.clamp(f, 0, n_tex - 1).long(), torch.clamp(f + 1, 0, n_tex - 1).long()
    r = torch.clamp(torch.floor(c + 0.5), 0, n_tex - 1).long()
    return r, r


def _block_box(rs, rb, cs, cb, lo, hi, reads, n_tex, bits, bilinear):
    """The block's box of the samples at steps lo..hi of the rays where
    ``reads``: (blocks, 4) int64, empty (r0 > r1) where no ray reads."""
    big = torch.iinfo(torch.int64).max
    ra, rz = _spans(rs, rb, lo, n_tex[0], bits, bilinear), _spans(rs, rb, hi, n_tex[0], bits, bilinear)
    ca, cz = _spans(cs, cb, lo, n_tex[1], bits, bilinear), _spans(cs, cb, hi, n_tex[1], bits, bilinear)
    parts = [(torch.minimum(ra[0], rz[0]), big, torch.amin), (torch.maximum(ra[1], rz[1]), -1, torch.amax),
             (torch.minimum(ca[0], cz[0]), big, torch.amin), (torch.maximum(ca[1], cz[1]), -1, torch.amax)]
    return torch.stack([red(torch.where(reads, v, fill), dim=-1) for v, fill, red in parts], dim=-1)


def _staged(box, slices: int, elem: int, offset, cap: int, can_stage: bool):
    """(fits, bytes): whether ``slices`` slices of a box's window, its rows
    in 16-byte chunks from ``offset``, fit a stage buffer of ``cap`` bytes."""
    b0 = (box[..., 2] * elem) & ~15
    b1 = ((box[..., 3] + 1) * elem + 15) & ~15
    nbytes = slices * (box[..., 1] - box[..., 0] + 1) * (b1 - b0)
    fits = (box[..., 0] <= box[..., 1]) & (offset + nbytes <= cap) & can_stage
    return fits, torch.where(fits, nbytes, 0)


def stage_plan(feats: torch.Tensor, vol_shape, u8: bool, params: RenderParams, stop: torch.Tensor | None = None,
               tile: tuple[int, int] = (MARCH_TILE_W, MARCH_TILE_H), batch: int | None = None,
               stage_bytes: int = STAGE_BYTES, can_stage: bool = True) -> StagePlan:
    """A transcription of how the CUDA march (csrc/slab_march.cu) plans
    its batches, in torch: which (block, batch) pairs it composites, the
    window of texels each batch's samples can read (the steps of each ray's
    t-window bounds, ``floor((entry - tb) / ts) - 1`` to ``floor((exit -
    tb) / ts) + 1``), and whether the window is staged in shared memory or
    read from global memory.

    ``stop``: (H, W) the march step at whose start each ray's alpha has
    reached the early-termination alpha (None: never).  The kernel learns
    it only by compositing, so a plan made without it has every window at
    least as large as the kernel's, and at least as many pairs.
    ``can_stage``: the volume's rows start on 16 bytes (the kernel's
    launch tests the pointers too).  ``batch``: steps a batch (default the
    kernel's for the stream)."""
    f = feats.reshape(N_FEATURES, *feats.shape[-2:])
    batch = batch or (MARCH_BATCH_U8 if u8 else MARCH_BATCH)
    n, nr, nc = vol_shape
    bilinear = params.interpolation == Interpolation.TRILINEAR
    halo = slab_mod.SMOOTH_HALO if params.use_gaussian_smoothing else 0
    bits = params.subtexel_bits
    elem = 1 if u8 else 4
    in_image = _tiles(torch.ones(f.shape[1:], dtype=torch.bool, device=f.device), tile, False)
    rows = {i: _tiles(f[i], tile, 0.0) for i in (F_RS, F_RB, F_CS, F_CB, F_TS, F_TB, F_ENTRY, F_EXIT, F_SIGNOK)}
    entry, exit_, ts, tb = rows[F_ENTRY], rows[F_EXIT], rows[F_TS], rows[F_TB]
    coef = (rows[F_RS], rows[F_RB], rows[F_CS], rows[F_CB])
    live = in_image & ~(exit_ <= entry) & (rows[F_SIGNOK] > 0.5)
    stop = (torch.full_like(ts, n, dtype=torch.int64) if stop is None
            else _tiles(stop.reshape(f.shape[1:]).long(), tile, n))
    # bounds of each ray's t-window in steps, (entry - tb) / ts and
    # (exit - tb) / ts floored, less and plus one; the first batch is the
    # block's least first step's
    e = torch.floor((entry - tb) / ts) - 1.0
    first = torch.where(e > 0.0, torch.where(e < float(n), e, float(n)), 0.0).long()
    e = torch.floor((exit_ - tb) / ts) + 1.0
    last = torch.where(e < float(n - 1), torch.where(e > -1.0, e, -1.0), float(n - 1)).long()
    big = torch.iinfo(torch.int64).max
    b_first = torch.where(live, first, big).amin(-1) // batch
    n_batches = -(-n // batch)
    q = torch.arange(batch, device=f.device)
    done = ~live  # at the start of batch b
    done_prev = done  # at the start of batch b - 1, what the plan of batch b takes
    out = {k: [] for k in ("visited", "dens_box", "grad_box", "dens_staged", "grad_staged")}
    for b in range(n_batches):
        steps = b * batch + q  # (K,)
        started = b >= b_first
        visited = started & (~done).any(-1)
        # the plan of batch b, over the rays alive at the start of batch b - 1:
        # the steps of their t-window bounds in the batch
        jlo = torch.clamp(first, min=b * batch)
        jhi = torch.clamp(last, max=min(b * batch + batch, n) - 1)
        any_q = ~done_prev & (jlo <= jhi)
        dens_reads = any_q & (jlo + halo <= n - 1)
        dens_box = _block_box(*coef, torch.where(dens_reads, jlo + halo, 0),
                              torch.where(dens_reads, torch.clamp(jhi + halo, max=n - 1), 0), dens_reads, (nr, nc),
                              bits, bilinear)
        grad_box = dens_box
        if halo:
            grad_box = _block_box(*coef, torch.where(any_q, jlo, 0), torch.where(any_q, jhi, 0), any_q, (nr, nc), bits,
                                  bilinear)
        dens_staged, dens_bytes = _staged(dens_box, batch, elem, 0, stage_bytes, can_stage)
        grad_staged = torch.zeros_like(dens_staged)
        aux_channels = 3 * params.use_shading + params.use_importance_coloring
        if aux_channels:
            dens_any = dens_box[..., 0] <= dens_box[..., 1]
            grad_staged, _ = _staged(grad_box, aux_channels * batch, 4, dens_bytes, stage_bytes, can_stage)
            grad_staged &= dens_staged | ~dens_any
        for k, v in (("visited", visited), ("dens_box", dens_box), ("grad_box", grad_box),
                     ("dens_staged", dens_staged), ("grad_staged", grad_staged)):
            out[k].append(v)
        # composite batch b: a ray is done at its first step past its exit or its stop
        t = ts[None] * steps[:, None, None].float() + tb[None]
        ends = ((steps[:, None, None] < n) & ((t >= exit_[None]) | (steps[:, None, None] >= stop[None]))).any(0)
        done_prev, done = done, done | (visited[:, None] & ends)
    return StagePlan(**{k: torch.stack(v) for k, v in out.items()})


def _bind(lib: ctypes.CDLL):
    """The march's C entry of a loaded kernel library, its types set."""
    fn = lib.slab_march_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        f = ctypes.c_float
        fn.argtypes = [p] * 7 + [i] * 13 + [f, f, f, p] + [p, i]
        fn.restype = ctypes.c_int
    return fn


def _library():
    from volym_tpu_torch.ops import _build

    return _bind(_build.library("slab_march"))


#: the march kernel's colour modes (csrc/slab_march.cu MODE_*): the TF
#: lookup composited, the importance heat map composited, the TF lookup's
#: first hit
MODE_LUT, MODE_COLOR, MODE_FIRST_HIT = 0, 1, 2


def march_mode(params: RenderParams) -> int:
    """The march's colour mode: first-hit is on only without coloring
    (``slab_kernel.py:1451``), so coloring with ``use_opacity=False`` still
    composites."""
    if params.use_importance_coloring:
        return MODE_COLOR
    return MODE_LUT if params.use_opacity else MODE_FIRST_HIT


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
    imp_perm: torch.Tensor | None = None,
):
    """Launch the CUDA march kernel; same arguments and result as
    :func:`slab.march_slabs`, except that ``gate`` is the packed gate of
    :func:`lookahead.gate_cuda` (int32 (ceil(N/32), H, W), bit j % 32 of
    word j // 32 for march step j).  With ``emit_density`` the residual is
    zero-filled here (``torch.zeros``) and the kernel writes the steps it
    samples; coloring and first-hit take no residual (the training step
    stores none under coloring, :func:`slab_replay.use_stored_density`, and
    first-hit is forward-only)."""
    global LAUNCHES
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"march_cuda needs CUDA tensors, got {dev}")
    mode = march_mode(params)
    if emit_density and mode != MODE_LUT:
        raise ValueError("the stored-density residual is marched only with the TF lookup composited")
    shading = params.use_shading
    tensors = [("feats", feats), ("vol_perm", vol_perm), ("lut", lut)]
    if shading:
        if grad_perm is None:
            raise ValueError("shading needs the permuted gradient field")
        tensors.append(("grad_perm", grad_perm))
    if gate is not None:
        tensors.append(("gate", gate))
    if mode == MODE_COLOR:
        if imp_perm is None:
            raise ValueError("importance coloring needs the permuted importance grid")
        tensors.append(("imp_perm", imp_perm))
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
    if mode == MODE_COLOR and (imp_perm.dtype != torch.float32 or imp_perm.shape != (n, nr, nc)):
        raise ValueError(f"imp_perm must be float32 ({n}, {nr}, {nc}), got {imp_perm.dtype} {tuple(imp_perm.shape)}")
    smooth = params.use_gaussian_smoothing
    if smooth:
        slab_mod.check_smooth_planes(n)
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
            int(smooth), threshold, early_alpha, tf_scale,
            torch.cuda.current_stream(dev).cuda_stream,
            imp_perm.data_ptr() if mode == MODE_COLOR else None, mode,
        )
    if rc != 0:
        raise RuntimeError(f"slab_march kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return (out, dens) if emit_density else out


def march(feats, vol_perm, lut, sign, params, grad_perm=None, u8=False, emit_density=False, gate=None,
          imp_perm=None):
    """The slab march on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (no fallback between them).
    ``gate`` is what :func:`lookahead.gate` returns on the same device."""
    with span("volym.march"):
        if feats.device.type == "cpu":
            return slab_mod.march_slabs(feats, vol_perm, lut, sign, params, grad_perm, u8, emit_density, gate,
                                        imp_perm)
        return march_cuda(feats, vol_perm, lut, sign, params, grad_perm, u8, emit_density, gate, imp_perm)


def _layout(scene, camera_matrices, params: RenderParams, axis=None):
    """(major axis, march sign, sample-plane count, u8 domain) of a frame;
    ``axis``: the (major axis, march sign) to march along in place of the
    camera's own (:func:`slab.dominant_axis`)."""
    with span("volym.layout"):
        major, sign = slab_mod.dominant_axis(camera_matrices) if axis is None else axis
        n = scene.volume.shape[0]
        planes = slab_mod.resolve_planes(params, n)
        return major, sign, planes, u8_active(params, planes, n)


def _gradient_perm(volume: torch.Tensor, major: int, planes: int) -> torch.Tensor:
    """The permuted, plane-resampled gradient field of ``volume``."""
    with span("volym.gradient_field"):
        return slab_mod.slab_resample_grad(
            slab_mod.permute_gradient(slab_mod.gradient_volume(volume), major), planes
        ).contiguous()


def table_chain(camera_matrices, ndc, planes, major, sign, n_plane, cone: bool = False) -> torch.Tensor:
    """The (N_FEATURES, R) per-ray table, or with ``cone`` the
    (CONE_FEATURES, R) cone table, of the rays through ``ndc`` (R, 2), by
    the chain of PyTorch ops: :func:`rays.rays_from_ndc`, then
    :func:`rays.ray_box_intersection` and :func:`features_from_rays`, or
    :func:`cone_features_from_rays`.  The plain version of
    :mod:`ray_table`'s kernels, and what :class:`KernelTable`'s backward
    differentiates."""
    origin, dirs = rays_mod.rays_from_ndc(camera_matrices, ndc)
    if cone:
        return cone_features_from_rays(origin, dirs, planes, major, sign, n_plane=n_plane)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    return features_from_rays(origin, dirs, entry, exit_, planes, major, sign, n_plane=n_plane)


class KernelTable(torch.autograd.Function):
    """The kernel's table with the chain's gradients.  Forward: one launch of
    :func:`ray_table.table_cuda`.  Backward: :func:`table_chain` re-run under
    autograd on the saved camera and NDC points, and its vector-Jacobian
    product with the table's cotangent, so the camera's gradients are the
    chain's and the forward keeps no graph of it."""

    @staticmethod
    def forward(ctx, inverse_view_proj, position, ndc, camera_matrices, planes, major, sign, n_plane, cone):
        ctx.save_for_backward(inverse_view_proj, position, ndc)
        ctx.args = (camera_matrices, planes, major, sign, n_plane, cone)
        return ray_table.table_cuda(inverse_view_proj.contiguous(), position.contiguous(), ndc.contiguous(), planes,
                                    major, sign, n_plane, cone=cone)

    @staticmethod
    def backward(ctx, d_table):
        camera_matrices, planes, major, sign, n_plane, cone = ctx.args
        ivp, pos, ndc = (t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad))
        cm = dataclasses.replace(camera_matrices, inverse_view_proj=ivp, position=pos)
        with torch.enable_grad():
            table = table_chain(cm, ndc, planes, major, sign, n_plane, cone)
        wanted = [t for t in (ivp, pos, ndc) if t.requires_grad]
        grads = iter(torch.autograd.grad(table, wanted, d_table, allow_unused=True))
        return (*(next(grads) if t.requires_grad else None for t in (ivp, pos, ndc)), *(None,) * 6)


def _table(camera_matrices, ndc, planes, major, sign, n_plane, cone: bool) -> torch.Tensor:
    """:func:`table_chain`'s table, built as :func:`ray_table.route` says:
    by the chain on CPU tensors, by one launch of :mod:`ray_table`'s kernel
    on CUDA tensors (through :class:`KernelTable` where the table carries
    camera gradients)."""
    ivp, pos = camera_matrices.inverse_view_proj, camera_matrices.position
    how = ray_table.route(ndc.device, torch.is_grad_enabled(), any(t.requires_grad for t in (ivp, pos, ndc)))
    if how == "chain":
        return table_chain(camera_matrices, ndc, planes, major, sign, n_plane, cone)
    if how == "kernel_vjp":
        return KernelTable.apply(ivp, pos, ndc, camera_matrices, planes, major, sign, n_plane, cone)
    return ray_table.table_cuda(ivp.contiguous(), pos.contiguous(), ndc.contiguous(), planes, major, sign, n_plane,
                                cone=cone)


def _features(camera_matrices, ndc, shape, planes, major, sign, n_plane) -> torch.Tensor:
    """The (N_FEATURES, *shape) per-ray table of the rays through the NDC
    points ``ndc`` (R, 2): a frame's :func:`rays.pixel_ndc` with ``shape``
    (H, W), or a shard's rows of it, laid out as (rows, R / rows)
    (:func:`_table`)."""
    with span("volym.ray_table"):
        return _table(camera_matrices, ndc, planes, major, sign, n_plane, cone=False).reshape(N_FEATURES, *shape)


def _cone_features(camera_matrices, ndc, shape, planes, major, sign, n_plane) -> torch.Tensor:
    """The (CONE_FEATURES, *shape) cone table of the rays through ``ndc``
    (as :func:`_features`)."""
    with span("volym.cone_table"):
        return _table(camera_matrices, ndc, planes, major, sign, n_plane, cone=True).reshape(CONE_FEATURES, *shape)


def lookahead_active(params: RenderParams) -> bool:
    """Whether a render gates its march on importance look-ahead (coloring
    replaces it)."""
    return bool(params.use_importance_rendering and not params.use_importance_coloring)


def importance_perm(importance: torch.Tensor, major: int, planes: int) -> torch.Tensor:
    """The (N, rows, cols) permuted importance grid, resampled nearest to
    ``planes`` planes (``slab_kernel.py:2329-2338``): what coloring samples
    and the look-ahead's levels are made of.  Differentiable in
    ``importance`` (coloring's d_importance goes back through the gather
    and the permute)."""
    return slab_mod.slab_resample_nearest(slab_mod.permute_volume(importance, major), planes)


def lookahead_inputs(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """The gate's inputs besides the per-ray table, as :func:`render` builds
    them for a frame under look-ahead: ``(cone_feats, levels)``, the
    (CONE_FEATURES, H, W) cone table (None for the straight variant) and
    the uint8 importance levels of :func:`grids` (``slab_kernel.py:2329-2364``)."""
    cm = camera_matrices.to(scene.device)
    g = grids(scene, cm, params)
    cone_feats = None
    if params.use_cone_importance_check:
        cone_feats = _cone_features(cm, rays_mod.pixel_ndc(height, width, scene.device), (height, width), g.planes,
                                    g.major, g.sign, g.n_plane)
    return cone_feats, g.levels


def quantize_u8(volume: torch.Tensor) -> torch.Tensor:
    """The uint8 grid of a [0, 1] volume, ``round(volume * 255)`` (half to
    even, as ``jnp.round``), clamped to [0, 255]."""
    return torch.round(volume * 255.0).clamp_(0.0, 255.0).to(torch.uint8)


def u8_grid(scene) -> torch.Tensor:
    """The uint8 grid the u8 march streams: the scene's own copy while it is
    current (:meth:`Scene.current_volume_u8`: one byte a voxel, no rounding
    a frame), else :func:`quantize_u8` of ``scene.volume`` as it stands, as
    the JAX package derives it on every frame (``slab_kernel.py:1378-1386``)."""
    grid = scene.current_volume_u8()
    return grid if grid is not None else quantize_u8(scene.volume.detach())


@dataclass(frozen=True)
class Grids:
    """The per-scene half of a slab frame, which every ray of it marches
    (every shard of a sharded frame, :mod:`volym_tpu_torch.parallel.mesh`):
    the layout (:func:`_layout`), the permuted grid as marched, the LUT, the
    permuted gradient field when shaded, the permuted importance under
    coloring and the uint8 importance levels under look-ahead."""

    major: int
    sign: int
    planes: int
    u8: bool
    vol_perm: torch.Tensor
    lut: torch.Tensor
    grad_perm: torch.Tensor | None
    imp_perm: torch.Tensor | None
    levels: torch.Tensor | None

    @property
    def n_plane(self) -> int:
        """The rows of a permuted slice (``ray_affine``'s ``n_plane``)."""
        return self.vol_perm.shape[1]


def grids(scene, camera_matrices, params: RenderParams, differentiable: bool = False, axis=None) -> Grids:
    """The :class:`Grids` of a frame of ``scene`` on its device.  Forward
    (``differentiable`` False): camera cotangents are moot, so
    ``camera_grads`` does not veto the u8 stream (``slab_kernel.render``
    clears it the same way), which reads :func:`u8_grid`.  Differentiable:
    the f32 volume's permute and plane resample, the gradient field and,
    under coloring, the importance stay in the autograd graph
    (:class:`DiffMarch` quantises the u8 stream itself); the look-ahead's
    levels are built without autograd.  ``axis``: as in :func:`_layout`."""
    with span("volym.grids"):
        if differentiable:
            major, sign, planes, u8 = _layout(scene, camera_matrices, params, axis)
            vol_perm = slab_mod.slab_resample(slab_mod.permute_volume(scene.volume, major), planes)
            lut = scene.tf_lut
        else:
            major, sign, planes, u8 = _layout(scene, camera_matrices, params.replace(camera_grads=False), axis)
            if u8:
                vol_perm = slab_mod.permute_volume(u8_grid(scene), major)
            else:
                vol_perm = slab_mod.slab_resample(slab_mod.permute_volume(scene.volume, major), planes)
            vol_perm, lut = vol_perm.contiguous(), scene.tf_lut.contiguous()
        grad_perm = _gradient_perm(scene.volume, major, planes) if params.use_shading else None
        imp_perm = levels = None
        if params.use_importance_coloring:
            imp_perm = importance_perm(scene.importance, major, planes).contiguous()
        if lookahead_active(params):
            with span("volym.importance_levels"), torch.no_grad():
                levels = slab_mod.importance_levels(importance_perm(scene.importance, major, planes))
        return Grids(major, sign, planes, u8, vol_perm, lut, grad_perm, imp_perm, levels)


def prepare(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """The forward march's inputs for one frame: ``(feats, vol_perm, lut,
    sign, grad_perm, u8)`` on the scene's device (:func:`grids`)."""
    cm = camera_matrices.to(scene.device)
    g = grids(scene, cm, params)
    feats = _features(cm, rays_mod.pixel_ndc(height, width, scene.device), (height, width), g.planes, g.major,
                      g.sign, g.n_plane)
    return feats, g.vol_perm, g.lut, g.sign, g.grad_perm, g.u8


def render_rays(g: Grids, camera_matrices, params: RenderParams, ndc, shape, march_fn=march,
                gate_fn=lookahead.gate) -> torch.Tensor:
    """The slab march of the rays through the NDC points ``ndc`` (R, 2) on
    the grids ``g`` -> (*shape, 4), ``shape`` the rays' (rows, columns) in
    the per-ray table (:func:`_features`); ``camera_matrices`` on the grids'
    device.  As :func:`render` does for a whole frame."""
    feats = _features(camera_matrices, ndc, shape, g.planes, g.major, g.sign, g.n_plane)
    gate = None
    if lookahead_active(params):
        cone_feats = (_cone_features(camera_matrices, ndc, shape, g.planes, g.major, g.sign, g.n_plane)
                      if params.use_cone_importance_check else None)
        gate = gate_fn(feats, cone_feats, g.levels, g.sign, params.subtexel_bits)
    return march_fn(feats, g.vol_perm, g.lut, g.sign, params, g.grad_perm, u8=g.u8, gate=gate, imp_perm=g.imp_perm)


def render(
    scene, camera_matrices, params: RenderParams, height: int, width: int, march_fn=march, gate_fn=lookahead.gate
) -> torch.Tensor:
    """Slab-marching render -> (H, W, 4) on the scene's device, through
    ``march_fn`` (default :func:`march`: the CUDA kernel on a GPU).  With
    importance look-ahead (:func:`lookahead_active`) the march is gated by
    ``gate_fn`` (default :func:`lookahead.gate`: the CUDA gate kernels on a
    GPU), whose gate ``march_fn`` takes; ``importance_check_ahead_steps``
    has no effect here, as on the JAX package's slab paths.  Importance
    coloring samples :func:`importance_perm`; first-hit is
    ``use_opacity=False`` without coloring."""
    cm = camera_matrices.to(scene.device)
    return render_rays(grids(scene, cm, params), cm, params, rays_mod.pixel_ndc(height, width, scene.device),
                       (height, width), march_fn, gate_fn)


def check_differentiable(params: RenderParams) -> None:
    """Raise for first-hit, which the differentiable render refuses as the
    JAX package's does (``slab_kernel.py:2476-2480``)."""
    if march_mode(params) == MODE_FIRST_HIT:
        raise NotImplementedError(
            "the slab render always alpha-composites when differentiated; first-hit (use_opacity=False) is "
            "forward-only"
        )


def smooth_backward(
    feats, dd, steps, vol, sign, params: RenderParams, scatter_fn=voxel_grad.smooth_scatter,
    feats_grad_fn=feats_grad.feats_grad,
):
    """The backward after the replay under Gaussian smoothing: ``dd`` and
    its per-ray step range ``steps`` -> ``(d_vol, d_grad, d_feats)``.
    ``scatter_fn`` (default :func:`voxel_grad.smooth_scatter`: the fused
    fold-and-scatter kernel on a GPU, the plain
    :func:`slab.smooth_voxel_grad` on the CPU) moves the density channel
    through the stencil's transpose onto the plain rows and scatters every
    channel.  With camera gradients and trilinear sampling it also returns
    the folded density rows, from which ``feats_grad_fn`` adds the plain
    rows' camera chain with ``vol``, the f32 volume as marched; otherwise
    ``d_feats`` is None (box hats have no coordinate derivative,
    ``slab_bwd_kernel.py:1789``).  With the two defaults on CUDA tensors
    the two run as one launch of the fused kernel's ``CHAIN`` variant
    (:func:`voxel_grad.fold_scatter_cuda` with ``vol``), which makes no
    folded rows; on CPU tensors they are the plain versions.  ``dd`` from
    the CUDA replay is unspecified outside each ray's step range
    (``slab_replay.replay_cuda``), so ``scatter_fn`` must read it only
    inside ``steps``, as the fused kernel does; the plain version's ``dd``
    is 0.0 there."""
    with span("volym.fold"):
        chain = params.camera_grads and params.interpolation == Interpolation.TRILINEAR
        fused = scatter_fn is voxel_grad.smooth_scatter and feats_grad_fn is feats_grad.feats_grad
        if chain and fused and feats.device.type == "cuda":
            return voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, params, vol=vol)
        d_vol, d_grad, folded = scatter_fn(feats, dd, steps, vol.shape, sign, params, chain)
        d_feats = feats_grad_fn(feats, vol, folded, sign, params) if chain else None
        return d_vol, d_grad, d_feats


class DiffMarch(torch.autograd.Function):
    """The differentiable slab march: the counterpart of the TPU package's
    custom VJPs ``march_pallas``, ``march_pallas_shaded``,
    ``march_pallas_lookahead`` and ``march_pallas_coloring``.

    Forward: the march (B1), which also stores the density residual when
    :func:`slab_replay.use_stored_density` holds.  Backward: the replay
    with its fused voxel scatter (B2), into d ``vol_perm``, d ``lut`` and,
    shaded, d ``grad_perm``, and with ``camera_grads`` into d ``feats``
    (B2's camera chain).  Under Gaussian smoothing the replay writes its
    per-step cotangents and their per-ray step range instead, and
    :func:`smooth_backward` folds and scatters them (the stencil's
    transpose fused into B3 or B4 on a GPU) and, for camera gradients with
    trilinear sampling, adds the plain rows' chain (B5, fused into the same
    kernel on a GPU).  In the u8 domain
    the march reads ``round(vol_perm * 255)`` as uint8 and the d/d(scaled
    density) is multiplied by 255.  The march, the replay, the smoothed
    scatter and the plain rows' chain are ``march_fn``, ``replay_fn``,
    ``scatter_fn`` and ``feats_grad_fn`` (:func:`march`,
    :func:`slab_replay.replay`, :func:`voxel_grad.smooth_scatter` and
    :func:`feats_grad.feats_grad` dispatch on the tensors' device; the last
    two as one, see :func:`smooth_backward`).

    ``gate``: the look-ahead gate, which both directions read and which
    gets no cotangent (``_mpl_bwd``, ``slab_kernel.py:1798-1822``).
    ``imp_perm``: importance coloring's permuted importance grid; the
    replay scatters d ``imp_perm`` in every case, smoothed too, and d
    ``vol_perm`` and d ``lut`` are zero (the density only gates the
    threshold mask, ``_mpc_bwd``, ``:1893-1910``), so the volume's gradient
    comes only through the gradient field when shaded.
    """

    @staticmethod
    def forward(ctx, vol_perm, lut, grad_perm, feats, imp_perm, gate, sign, params, u8, march_fn, replay_fn,
                scatter_fn, feats_grad_fn):
        if u8:
            vol = quantize_u8(vol_perm).contiguous()
        else:
            vol = vol_perm.contiguous()
        lut = lut.contiguous()
        stored = slab_replay.use_stored_density(params, vol.shape[0], feats.shape[1] * feats.shape[2])
        res = march_fn(feats, vol, lut, sign, params, grad_perm, u8, emit_density=stored, gate=gate,
                       imp_perm=imp_perm)
        out, dens = res if stored else (res, None)
        ctx.save_for_backward(feats, vol, lut, grad_perm, out, dens, gate, imp_perm)
        ctx.sign, ctx.params, ctx.u8 = sign, params, u8
        ctx.replay_fn, ctx.scatter_fn, ctx.feats_grad_fn = replay_fn, scatter_fn, feats_grad_fn
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_img):
        with span("volym.backward"):
            feats, vol, lut, grad_perm, out, dens, gate, imp_perm = ctx.saved_tensors
            params = ctx.params
            res = ctx.replay_fn(feats, vol, lut, ctx.sign, params, out, g_img.contiguous(), grad_perm, ctx.u8, dens,
                                gate, imp_perm)
            d_feats = d_imp = None
            if params.camera_grads:
                *res, d_feats = res
            if params.use_importance_coloring:
                d_imp, d_grad, d_lut = res
                d_vol = torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)
            elif params.use_gaussian_smoothing:
                dd, steps, d_lut = res
                d_vol, d_grad, d_plain = smooth_backward(feats, dd, steps, vol, ctx.sign, params, ctx.scatter_fn,
                                                         ctx.feats_grad_fn)
                if d_plain is not None:
                    d_feats = d_feats + d_plain
            else:
                d_vol, d_grad, d_lut = res
            if ctx.u8:
                d_vol = d_vol * 255.0  # d/d(scaled density) -> d/d(v/255 volume)
        return d_vol, d_lut, d_grad, d_feats, d_imp, None, None, None, None, None, None, None, None


def render_diff(
    scene, camera_matrices, params: RenderParams, height: int, width: int, march_fn=march,
    replay_fn=slab_replay.replay, scatter_fn=voxel_grad.smooth_scatter, feats_grad_fn=feats_grad.feats_grad,
    gate_fn=lookahead.gate,
):
    """Differentiable slab render -> (H, W, 4) on the scene's device, the
    counterpart of ``slab_kernel.render_diff``.  Gradients reach
    ``scene.volume`` and ``scene.tf_lut`` through ``torch.autograd``: the
    permute, the plane resample and the gradient field stay in the graph,
    and :class:`DiffMarch` is the march and its replay, through
    ``march_fn``, ``replay_fn`` and, under Gaussian smoothing,
    ``scatter_fn`` and ``feats_grad_fn`` (default: the CUDA kernels on a
    GPU).

    With ``params.camera_grads`` (the default) the per-ray table is built
    with autograd on, so the replay's d ``feats`` reaches
    ``camera_matrices.inverse_view_proj`` and ``camera_matrices.position``
    (set ``requires_grad`` on them), as ``jax.grad`` does through
    ``_pack_features``; ``view`` and ``proj`` get none (the march axis is
    chosen on the host).  Camera cotangents march the f32 volume and
    re-sample it in the replay (no u8 stream, no stored residual).

    Importance look-ahead gates both directions with ``gate_fn`` (default
    :func:`lookahead.gate`), built without autograd on detached inputs: a
    zero-gradient mask, as the JAX package's ``stop_gradient`` calls make it
    (``slab_kernel.py:2425-2447``).  Importance coloring keeps the permuted
    importance grid in the graph, so d_importance reaches
    ``scene.importance`` through the nearest gather and the permute
    (``:2413-2422``); the direct volume and LUT gradients are zero.
    First-hit raises ``NotImplementedError``, as in the JAX package.

    In the u8 domain (:func:`u8_active`) the uint8 grid is derived from the
    differentiable volume on every call, ``round(volume * 255)``, so a
    volume that is not u8-representable is quantised silently, as in the
    TPU package (and values outside [0, 1] are clamped to it);
    ``scene.volume_u8`` is not read.
    """
    check_differentiable(params)
    cm = camera_matrices.to(scene.device)
    return render_rays_diff(
        grids(scene, cm, params, differentiable=True), cm, params, rays_mod.pixel_ndc(height, width, scene.device),
        (height, width), march_fn, replay_fn, scatter_fn, feats_grad_fn, gate_fn,
    )


def render_rays_diff(
    g: Grids, camera_matrices, params: RenderParams, ndc, shape, march_fn=march, replay_fn=slab_replay.replay,
    scatter_fn=voxel_grad.smooth_scatter, feats_grad_fn=feats_grad.feats_grad, gate_fn=lookahead.gate,
) -> torch.Tensor:
    """The differentiable slab march of the rays through ``ndc`` on the
    differentiable grids ``g`` (:func:`grids`) -> (*shape, 4), as
    :func:`render_diff` does for a whole frame: with ``camera_grads`` the
    per-ray table is built with autograd on, the gate without."""
    with torch.set_grad_enabled(params.camera_grads and torch.is_grad_enabled()):
        feats = _features(camera_matrices, ndc, shape, g.planes, g.major, g.sign, g.n_plane)
    gate = None
    if lookahead_active(params):
        with torch.no_grad():
            cone_feats = (_cone_features(camera_matrices, ndc, shape, g.planes, g.major, g.sign, g.n_plane)
                          if params.use_cone_importance_check else None)
            gate = gate_fn(feats.detach(), cone_feats, g.levels, g.sign, params.subtexel_bits)
    return DiffMarch.apply(
        g.vol_perm, g.lut, g.grad_perm, feats, g.imp_perm, gate, g.sign, params, g.u8, march_fn, replay_fn,
        scatter_fn, feats_grad_fn,
    )
