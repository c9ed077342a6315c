"""Slab-marching renderer: plain PyTorch version.

Counterpart of :mod:`volym_tpu.render.slab` in every slab mode: base,
shading, Gaussian smoothing, importance coloring and first-hit, forward
with importance look-ahead, and backward (with camera gradients, the
look-ahead gate and coloring's d_importance; first-hit is forward-only).
The march steps
along the camera's dominant axis one voxel plane at a time, so every
sample lies on a plane and trilinear filtering is bilinear inside one
slice (see the JAX module for the derivation).

:func:`march_slabs` is the plain version of the CUDA march kernel
(:mod:`volym_tpu_torch.ops.slab_march`): it reads the same per-ray table and
evaluates every per-sample expression in the order the kernel does, so on
one device the two agree to the rounding of ``exp``/``log``/``pow``.  It
also runs the u8 scaled density domain of the TPU kernel, the slab-axis
smoothing stencil (:func:`smoothed_densities`), and emits the
stored-density residual.  :func:`replay_slabs` is the plain version of the
CUDA replay backward (:mod:`volym_tpu_torch.ops.slab_replay`),
:func:`voxel_grad` that of the CUDA voxel-gradient scatters
(:mod:`volym_tpu_torch.ops.voxel_grad`), and :func:`lookahead_gate` that
of the CUDA look-ahead gate (:mod:`volym_tpu_torch.ops.lookahead`).
:func:`smooth_voxel_grad` (the stencil's transpose
:func:`smooth_dd_transpose`, then :func:`voxel_grad`) is that of the fused
fold-and-scatter kernel the smoothed backward runs on the GPU, and with
:func:`feats_grad` on its folded rows that of the kernel's variant with
the plain rows' camera chain.

Rays whose dominant-axis direction component opposes the camera forward
axis (possible at extreme fov) render as (0, 0, 0, 0), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from volym_tpu_torch.config import Interpolation, RenderParams
from volym_tpu_torch.render.golden import (
    CONE_SAMPLES, GAUSSIAN_KERNEL_SIZE, GAUSSIAN_SIGMA, GAUSSIAN_STEP, importance_to_color,
)
from volym_tpu_torch.render.rays import sqrt_rn
from volym_tpu_torch.render.shading import AMBIENT, DIFFUSE, GRADIENT_OFFSET, SHININESS, SPECULAR, safe_normalize
from volym_tpu_torch.transfer_function import lut_sample

#: per major-axis component m: (transpose order for (D,H,W)=[z,y,x] arrays,
#: in-slice row component, in-slice column component); components are
#: shader-space (x=0, y=1, z=2).
_AXIS_LAYOUT = {
    2: ((0, 1, 2), 1, 0),  # z major: slices [y, x]
    1: ((1, 0, 2), 2, 0),  # y major: slices [z, x]
    0: ((2, 1, 0), 1, 2),  # x major: slices [y, z]
}

#: rows of the per-ray table (the TPU kernel's F_* feature rows): sample
#: coordinates ``rows = rs*j + rb``, ``cols = cs*j + cb`` and ``t = ts*j + tb``
#: as affine functions of the march index j, the ray's [entry, exit)
#: t-window, the opacity-correction exponent, the sign flag, the
#: Blinn-Phong half vector, and cam.dir and |cam|^2 for the look-ahead's
#: probe range.  The CUDA kernels read the same rows (csrc/slab_common.cuh).
F_RS, F_RB, F_CS, F_CB, F_TS, F_TB, F_ENTRY, F_EXIT, F_AEXP, F_SIGNOK = range(10)
F_HX, F_HY, F_HZ = 10, 11, 12
F_CD, F_C2 = 13, 14
N_FEATURES = 15
#: rows of the cone look-ahead table, per cone direction: that direction's
#: rows/cols/t slopes and intercepts (as in the per-ray table) and its rate,
#: march steps per unit distance along it.  The TPU pads each direction to
#: 8 rows for its sublane layout; here the stride is 7.
CF_RS, CF_RB, CF_CS, CF_CB, CF_TS, CF_TB, CF_RATE = range(7)
CF_STRIDE = 7
CONE_FEATURES = CONE_SAMPLES * CF_STRIDE

#: importance at or above which material counts as important ahead, and at
#: or above which the current sample counts as opaque (``wgsl:133, 291``)
IMPORTANT_AHEAD_THRESHOLD = 0.5
IMPORTANCE_OPAQUE = 1.0
#: "no important crossing ahead": the look-ahead's next-important march
#: index before any is found (float32, as on the TPU)
FAR = 1e9

#: 1/sqrt(3), the normalised light direction's components (LIGHT_DIR = 1,1,1)
INV_SQRT3 = 0.57735026
#: colour of rays that miss the unit box
MISS_COLOR = (0.0, 0.0, 0.0, 1.0)

#: step-size factor ladder (see :func:`step_planes`)
STEP_LADDER = (4.0, 2.0, 1.0, 0.5, 0.25)

#: slab-axis half-width of the smoothing stencil: a Gaussian tap lies
#: u = delta / ts march steps from its step, |u| <= 0.01 * N (2.56 at 256
#: planes), and its hat reaches one step further
SMOOTH_HALO = 3
#: the most planes the stencil covers, int(SMOOTH_HALO / (K * STEP)) = 300
SMOOTH_MAX_PLANES = int(SMOOTH_HALO / (GAUSSIAN_KERNEL_SIZE * GAUSSIAN_STEP))
#: the Gaussian taps as float32 values: (t-offset i * STEP, weight
#: exp(-offset^2 / (2 sigma^2))) for i in [-K, K], the values JAX's weak
#: Python floats take against float32 arrays (csrc/slab_common.cuh holds
#: the same constants)
GAUSS_TAPS = tuple(
    (float(np.float32(i * GAUSSIAN_STEP)),
     float(np.float32(math.exp(-((i * GAUSSIAN_STEP) * (i * GAUSSIAN_STEP)) / (2.0 * GAUSSIAN_SIGMA * GAUSSIAN_SIGMA)))))
    for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1)
)


def dominant_axis(camera_matrices) -> tuple[int, int]:
    """(major component in (x,y,z), march sign) from the camera forward
    vector (host side)."""
    view = camera_matrices.view.detach().cpu().numpy()
    fwd = -view[2, :3]  # view matrix row 2 = -forward
    m = int(np.argmax(np.abs(fwd)))
    return m, (1 if fwd[m] > 0 else -1)


def snap(c: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize a texel coordinate to ``bits`` fractional fixed-point bits
    (every operation is exact in float32; ``bits == 0`` is the identity)."""
    if not bits:
        return c
    s = float(1 << bits)
    return torch.floor(c * s + 0.5) * (1.0 / s)


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, value)


def ray_affine(origin, dirs, n_slabs: int, major: int, sign: int, n_plane: int | None = None):
    """Per-ray affine coefficients of the slab march, ``t(j) = ts*j + tb``,
    ``rows(j) = rs*j + rb``, ``cols(j) = cs*j + cb``, in the JAX package's
    float32 operation order (the snap decisions depend on every bit)."""
    _, row_comp, col_comp = _AXIS_LAYOUT[major]
    o_m, d_m = origin[major], dirs[:, major]
    sz = (1.0 / n_slabs) * sign
    z0 = (0.5 / n_slabs) if sign > 0 else ((n_slabs - 0.5) / n_slabs)
    safe_dm = torch.where(torch.abs(d_m) > 1e-12, d_m, _full(d_m, 1e-12))
    ts = _full(d_m, sz) / safe_dm
    tb = (z0 - o_m) / safe_dm
    n = n_slabs if n_plane is None else n_plane
    rs = ts * dirs[:, row_comp] * n
    rb = (origin[row_comp] + tb * dirs[:, row_comp]) * n - 0.5
    cs = ts * dirs[:, col_comp] * n
    cb = (origin[col_comp] + tb * dirs[:, col_comp]) * n - 0.5
    return rs, rb, cs, cb, ts, tb


def slab_resample(vol_perm: torch.Tensor, planes: int) -> torch.Tensor:
    """Linearly resample a permuted grid along the slab axis to ``planes``
    planes (clamp-to-edge): the step-size mapping.  Identity when
    ``planes`` equals the current count."""
    n = vol_perm.shape[0]
    if planes == n:
        return vol_perm
    ar = torch.arange(planes, dtype=torch.float32, device=vol_perm.device)
    s = torch.clamp((ar + 0.5) * (n / planes) - 0.5, 0.0, n - 1.0)
    lo_f = torch.floor(s)
    lo = lo_f.long()
    hi = torch.clamp(lo + 1, max=n - 1)
    w = (s - lo_f).reshape((planes,) + (1,) * (vol_perm.ndim - 1))
    return vol_perm[lo] * (1.0 - w) + vol_perm[hi] * w


def slab_resample_nearest(grid_perm: torch.Tensor, planes: int) -> torch.Tensor:
    """Nearest-neighbour resample of a permuted grid along the slab axis to
    ``planes`` planes: the importance grid's step-size mapping (the
    reference samples importance with a nearest sampler).  Identity when
    ``planes`` equals the current count."""
    n = grid_perm.shape[0]
    if planes == n:
        return grid_perm
    s = (torch.arange(planes, dtype=torch.float32, device=grid_perm.device) + 0.5) * (n / planes) - 0.5
    return grid_perm[torch.clamp(torch.floor(s + 0.5), 0, n - 1).long()]


def importance_levels(imp_perm: torch.Tensor) -> torch.Tensor:
    """The look-ahead's view of a permuted importance grid: one uint8 a
    voxel, ``(imp >= IMPORTANT_AHEAD_THRESHOLD) + (imp >= IMPORTANCE_OPAQUE)``.
    Level 1 and up is important material ahead, level 2 an opaque current
    sample; the gate compares nothing else."""
    return ((imp_perm >= IMPORTANT_AHEAD_THRESHOLD).to(torch.uint8)
            + (imp_perm >= IMPORTANCE_OPAQUE).to(torch.uint8)).contiguous()


def slab_resample_grad(grad_perm: torch.Tensor, planes: int) -> torch.Tensor:
    """:func:`slab_resample` for a (3, N, rows, cols) gradient field."""
    if planes == grad_perm.shape[1]:
        return grad_perm
    return slab_resample(grad_perm.transpose(0, 1), planes).transpose(0, 1)


def step_planes(step_size: float, n_slabs: int) -> int:
    """Sample-plane count for a requested t-step size, bucketed to
    :data:`STEP_LADDER` in log space: {.003,.005,.01,.02} at 256^3 map to
    {256, 256, 128, 64} planes."""
    if step_size <= 0.0:
        return n_slabs
    f = (1.0 / n_slabs) / step_size
    best = min(STEP_LADDER, key=lambda x: abs(math.log(f / x)))
    return max(1, int(round(n_slabs * best)))


def resolve_planes(params: RenderParams, n_slabs: int) -> int:
    """Effective sample-plane count of a render (:func:`step_planes`).
    Under Gaussian smoothing, as in the JAX package, supersampling is
    clamped off, the count is capped at :data:`SMOOTH_MAX_PLANES` and
    rounded down to a multiple of 8, but not below 8 (the TPU stencil's
    slab batch; kept so both packages march the same planes)."""
    planes = step_planes(params.raymarching_step_size, n_slabs)
    if params.use_gaussian_smoothing:
        planes = min(planes, n_slabs, SMOOTH_MAX_PLANES)
        if planes % 8:
            planes = max(8, planes // 8 * 8)
    return planes


def permute_volume(volume: torch.Tensor, major: int) -> torch.Tensor:
    """(D, H, W) grid -> (N_slabs, rows, cols) with the major axis leading."""
    order, _, _ = _AXIS_LAYOUT[major]
    return volume.permute(order)


def permute_gradient(grad: torch.Tensor, major: int) -> torch.Tensor:
    """(3, D, H, W) gradient field -> (3, N, rows, cols)."""
    order, _, _ = _AXIS_LAYOUT[major]
    return grad.permute((0,) + tuple(o + 1 for o in order))


def gradient_volume(volume: torch.Tensor) -> torch.Tensor:
    """Density gradient field at voxel centres: the trilinear field sampled
    at +-GRADIENT_OFFSET (a blend of the +-2/+-3 neighbours at 256^3),
    clamp-to-edge.  Returns (3, D, H, W), channels in shader order."""
    d = volume.shape[0]
    off = GRADIENT_OFFSET * d
    lo, hi = int(math.floor(off)), int(math.floor(off)) + 1
    frac = off - math.floor(off)
    ar = torch.arange(d, device=volume.device)
    two_off = torch.tensor(2.0 * GRADIENT_OFFSET, dtype=torch.float32, device=volume.device)

    def shift(axis, by):
        return torch.index_select(volume, axis, torch.clamp(ar + by, 0, d - 1))

    grads = []
    for comp in (0, 1, 2):  # shader components x, y, z
        axis = 2 - comp
        plus = shift(axis, lo) * (1 - frac) + shift(axis, hi) * frac
        minus = shift(axis, -lo) * (1 - frac) + shift(axis, -hi) * frac
        grads.append((plus - minus) / two_off)
    return torch.stack(grads)


def _bilinear_taps(rows_c: torch.Tensor, cols_c: torch.Tensor, nr: int, nc: int):
    """The four clamp-to-edge taps of a bilinear sample: row indices
    (r0, r1), column indices (c0, c1) and the fractions (tr, tc)."""
    r0f = torch.floor(rows_c)
    c0f = torch.floor(cols_c)
    tr = rows_c - r0f
    tc = cols_c - c0f
    r0 = torch.clamp(r0f, 0, nr - 1).long()
    r1 = torch.clamp(r0f + 1, 0, nr - 1).long()
    c0 = torch.clamp(c0f, 0, nc - 1).long()
    c1 = torch.clamp(c0f + 1, 0, nc - 1).long()
    return r0, r1, c0, c1, tr, tc


def _nearest_tap(rows_c: torch.Tensor, cols_c: torch.Tensor, nr: int, nc: int) -> torch.Tensor:
    # wgpu nearest: texel floor(p*N) = floor(coords + 0.5) in texel space
    r = torch.clamp(torch.floor(rows_c + 0.5), 0, nr - 1).long()
    c = torch.clamp(torch.floor(cols_c + 0.5), 0, nc - 1).long()
    return r * nc + c


def _bilinear_slice(sl: torch.Tensor, rows_c: torch.Tensor, cols_c: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of one (nr, nc) slice at texel coords already in
    ``p*N - 0.5`` space, clamp-to-edge; a uint8 slice is read as float."""
    nr, nc = sl.shape
    flat = sl.reshape(-1)
    r0, r1, c0, c1, tr, tc = _bilinear_taps(rows_c, cols_c, nr, nc)
    v00 = flat[r0 * nc + c0].float()
    v01 = flat[r0 * nc + c1].float()
    v10 = flat[r1 * nc + c0].float()
    v11 = flat[r1 * nc + c1].float()
    return (
        v00 * (1 - tr) * (1 - tc)
        + v01 * (1 - tr) * tc
        + v10 * tr * (1 - tc)
        + v11 * tr * tc
    )


def _nearest_slice(sl: torch.Tensor, rows_c: torch.Tensor, cols_c: torch.Tensor) -> torch.Tensor:
    nr, nc = sl.shape
    return sl.reshape(-1)[_nearest_tap(rows_c, cols_c, nr, nc)].float()


def _dsample(sl: torch.Tensor, rows_c: torch.Tensor, cols_c: torch.Tensor):
    """(d sample / d rows, d sample / d cols) of a bilinear sample of the
    float32 (nr, nc) slice ``sl`` at snapped texel coordinates: the hats'
    derivative contracted with the other axis' hats (``_dhat`` and
    ``slab_bwd_kernel.py:826-842``; ``dsample`` in csrc/slab_common.cuh).

    The derivative is half-open: at a coordinate exactly on texel i it is
    the right-sided difference ``v[i+1] - v[i]``.  Texel ``nr`` (``nc``) is
    absent from the TPU's hats, so it counts as 0 and not as a clamped copy
    of texel ``nr - 1``: a coordinate snapped onto ``nr - 1`` has
    derivative ``-v[nr-1]``.  The caller masks the chain where the raw
    coordinate is clipped."""
    nr, nc = sl.shape
    flat = torch.nn.functional.pad(sl, (0, 1, 0, 1)).reshape(-1)  # the absent texels, 0
    r0f = torch.floor(rows_c)
    c0f = torch.floor(cols_c)
    tr = rows_c - r0f
    tc = cols_c - c0f
    i00 = r0f.long() * (nc + 1) + c0f.long()
    v00, v01 = flat[i00], flat[i00 + 1]
    v10, v11 = flat[i00 + (nc + 1)], flat[i00 + (nc + 2)]
    ur, uc = 1.0 - tr, 1.0 - tc
    return (v10 - v00) * uc + (v11 - v01) * tc, (v01 * ur + v11 * tr) - (v00 * ur + v10 * tr)


def _coord_masks(f: torch.Tensor, jf, nr: int, nc: int):
    """Where the camera chain of a sample's coordinates runs: the raw,
    unclipped, unsnapped coordinate strictly inside the texel range
    (``rows_in``/``cols_in``, ``slab_bwd_kernel.py:827-830``)."""
    rows_raw = f[F_RS] * jf + f[F_RB]
    cols_raw = f[F_CS] * jf + f[F_CB]
    return (rows_raw > 0.0) & (rows_raw < nr - 1.0), (cols_raw > 0.0) & (cols_raw < nc - 1.0)


def _coord_chain(sl: torch.Tensor, rows_c, cols_c, masks, v: torch.Tensor):
    """``v`` times the coordinate derivative of the sample of ``sl``
    (:func:`_dsample`), zero where :func:`_coord_masks` clips it ->
    ``(d_rows, d_cols)``."""
    ddr, ddc = _dsample(sl, rows_c, cols_c)
    return torch.where(masks[0], v * ddr, 0.0), torch.where(masks[1], v * ddc, 0.0)


def _add_coord_chain(d_feats: torch.Tensor, j: int, d_rows: torch.Tensor, d_cols: torch.Tensor) -> None:
    """Add march step j's coordinate cotangents into the affine rows of the
    (N_FEATURES, R) table cotangent (rows = F_RS * j + F_RB, cols alike)."""
    d_feats[F_RS] += d_rows * float(j)
    d_feats[F_RB] += d_rows
    d_feats[F_CS] += d_cols * float(j)
    d_feats[F_CB] += d_cols


def _scatter_sample(dst: torch.Tensor, rows_c, cols_c, value: torch.Tensor, bilinear: bool) -> None:
    """Transpose of one slice sample: add ``value`` (R,) into the (nr, nc)
    slice ``dst`` with the sample's own bilinear or box weights (the fused
    scatter of the TPU replay, ``slab_bwd_kernel.py:792-815``)."""
    nr, nc = dst.shape
    flat = dst.view(-1)
    if not bilinear:
        flat.index_add_(0, _nearest_tap(rows_c, cols_c, nr, nc), value)
        return
    r0, r1, c0, c1, tr, tc = _bilinear_taps(rows_c, cols_c, nr, nc)
    ur, uc = 1.0 - tr, 1.0 - tc
    idx = torch.cat([r0 * nc + c0, r0 * nc + c1, r1 * nc + c0, r1 * nc + c1])
    flat.index_add_(0, idx, torch.cat([value * ur * uc, value * ur * tc, value * tr * uc, value * tr * tc]))


def march_knobs(params: RenderParams, u8: bool) -> tuple[float, float, float | None]:
    """(threshold, early alpha, TF density scale) of a march, as float32
    values: in u8 mode the threshold is float32(threshold) * 255 and the TF
    coordinate takes the 1/255 scale."""
    thr = np.float32(params.density_threshold)
    if u8:
        thr = thr * np.float32(255.0)
    return float(thr), float(np.float32(params.early_termination_alpha)), (1.0 / 255.0) if u8 else None


def _step_coords(f: torch.Tensor, j: int, n: int, nr: int, nc: int, sign: int, bits: int):
    """March step j: (physical plane k, t, snapped rows, snapped cols)."""
    k = j if sign > 0 else n - 1 - j
    t = f[F_TS] * float(j) + f[F_TB]
    rows_c = snap(torch.clamp(f[F_RS] * float(j) + f[F_RB], 0.0, nr - 1.0), bits)
    cols_c = snap(torch.clamp(f[F_CS] * float(j) + f[F_CB], 0.0, nc - 1.0), bits)
    return k, t, rows_c, cols_c


def check_smooth_planes(n: int) -> None:
    """Raise unless the smoothing stencil covers ``n`` march planes: its
    taps lie up to ``K * STEP * n`` steps away, and past
    :data:`SMOOTH_HALO` the outer taps would get no weight while still
    counting in the normalisation (the JAX package's bound)."""
    if GAUSSIAN_KERNEL_SIZE * GAUSSIAN_STEP * n > SMOOTH_HALO:
        raise NotImplementedError(
            f"Gaussian smoothing stencil (halo {SMOOTH_HALO}) only covers volumes up to "
            f"{SMOOTH_MAX_PLANES} slabs (got {n})"
        )


def smooth_row(f: torch.Tensor, jf, rows, n: int, nr: int, nc: int, bilinear: bool) -> torch.Tensor:
    """The Gaussian-smoothed density (M, R) of the march steps ``jf`` ((M, 1)
    float32 step indices) from ``rows``, the 7 plain density rows (M, R) of
    steps clamp(j-3 .. j+3) to [0, n-1].

    The reference smooths along the ray with 5 taps at t-offsets delta =
    i * 0.005 (``wgsl:44-75``).  A tap lies ``u = delta / ts`` march steps
    from step j, a per-ray constant, so it is a hat (trilinear) or box
    (nearest) combination of the plain rows j-3..j+3.  A tap counts where
    it lies in the box (rows and columns bounded by the texel counts
    ``nr``/``nc``, the slab axis by the plane count ``n``), and the sum is
    normalised by the weights that count.  Every expression follows the
    TPU kernel's ``_smooth_row`` (``slab_kernel.py:879-934``) and the CUDA
    kernels' ``smooth_density`` (csrc/slab_common.cuh) in operation order,
    ``delta / ts`` divided tensor by tensor."""
    ts = torch.where(f[F_TS] == 0.0, 1.0, f[F_TS])  # padded-lane guard of the TPU kernel
    rows_raw = f[F_RS] * jf + f[F_RB]
    cols_raw = f[F_CS] * jf + f[F_CB]
    total = torch.zeros_like(rows_raw)
    wsum = torch.zeros_like(rows_raw)
    for delta, w in GAUSS_TAPS:
        u = torch.full_like(ts, delta) / ts
        rt = rows_raw + u * f[F_RS]
        ct = cols_raw + u * f[F_CS]
        st = jf + u
        in_box = (
            (rt >= -0.5) & (rt <= nr - 0.5) & (ct >= -0.5) & (ct <= nc - 0.5) & (st >= -0.5) & (st <= n - 0.5)
        )
        del rt, ct, st
        tap = torch.zeros_like(rows_raw)
        for off in range(-SMOOTH_HALO, SMOOTH_HALO + 1):
            d = u - off
            ker = torch.clamp(1.0 - torch.abs(d), min=0.0) if bilinear else ((d >= -0.5) & (d < 0.5)).float()
            tap = tap + ker * rows[off + SMOOTH_HALO]
        wb = torch.where(in_box, w, 0.0)
        total = total + wb * tap
        wsum = wsum + wb
    return total / torch.where(wsum > 0.0, wsum, 1.0)


def smooth_row_dts(f: torch.Tensor, jf, rows, n: int, nr: int, nc: int, bilinear: bool) -> torch.Tensor:
    """d(smoothed density)/d(F_TS) (M, R) of the march steps ``jf``, with
    :func:`smooth_row`'s arguments: the counterpart of
    ``slab_bwd_kernel._smooth_row_dts`` (``:118-166``) in its operation
    order.  The in-box masks and ``wsum`` are indicators (zero derivative
    almost everywhere), so only the stencil's hats ``ker(u - off)`` chain,
    with ``du/dts = -delta / ts^2``, normalised by ``wsum``.  Box (nearest)
    hats have no derivative: zeros."""
    if not bilinear:
        return torch.zeros_like(rows[0])
    ts_raw = f[F_TS]
    ts = torch.where(ts_raw == 0.0, 1.0, ts_raw)
    rows_raw = f[F_RS] * jf + f[F_RB]
    cols_raw = f[F_CS] * jf + f[F_CB]
    total = torch.zeros_like(rows_raw)
    wsum = torch.zeros_like(rows_raw)
    for delta, w in GAUSS_TAPS:
        u = torch.full_like(ts, delta) / ts
        rt = rows_raw + u * f[F_RS]
        ct = cols_raw + u * f[F_CS]
        st = jf + u
        in_box = (
            (rt >= -0.5) & (rt <= nr - 0.5) & (ct >= -0.5) & (ct <= nc - 0.5) & (st >= -0.5) & (st <= n - 0.5)
        )
        del rt, ct, st
        du_dts = torch.full_like(ts, -delta) / (ts_raw * ts_raw)
        dtap = torch.zeros_like(rows_raw)
        for off in range(-SMOOTH_HALO, SMOOTH_HALO + 1):
            d = u - off
            dker = torch.where(torch.abs(d) < 1.0, -torch.sign(d), 0.0)
            dtap = dtap + dker * rows[off + SMOOTH_HALO]
        wb = torch.where(in_box, w, 0.0)
        total = total + wb * dtap * du_dts
        wsum = wsum + wb
    return total / torch.where(wsum > 0.0, wsum, 1.0)


def _stencil_rows(f: torch.Tensor, vol_perm: torch.Tensor, sign: int, params: RenderParams):
    """The 7 plain density rows (N, R) of the stencil at every march step:
    row ``o + 3`` holds the plain row of step clamp(j + o) to [0, N-1].  The
    plain row of step j is the sample at the step's own snapped
    coordinates, whatever the ray's t-window."""
    n, nr, nc = vol_perm.shape
    check_smooth_planes(n)
    sample2d = _bilinear_slice if params.interpolation == Interpolation.TRILINEAR else _nearest_slice
    plain = torch.stack([
        sample2d(vol_perm[k], rows_c, cols_c)
        for k, _, rows_c, cols_c in (_step_coords(f, j, n, nr, nc, sign, params.subtexel_bits) for j in range(n))
    ])
    idx = torch.arange(n, device=plain.device)
    return [plain[torch.clamp(idx + o, 0, n - 1)] for o in range(-SMOOTH_HALO, SMOOTH_HALO + 1)]


def smoothed_densities(feats: torch.Tensor, vol_perm: torch.Tensor, sign: int, params: RenderParams) -> torch.Tensor:
    """(N, H, W) Gaussian-smoothed density at every march step j, the
    counterpart of the jnp spec ``volym_tpu.render.slab.smoothed_densities``
    (:func:`smooth_row` over the plain rows of :func:`_stencil_rows`; rows
    beyond the sweep clamp to its end rows).  ``vol_perm`` as in
    :func:`march_slabs` (uint8 in the u8 domain: the stencil is linear and
    normalised, so the smoothed scaled density is 255x the smoothed
    density)."""
    _, height, width = feats.shape
    f = feats.reshape(N_FEATURES, -1)
    n, nr, nc = vol_perm.shape
    rows = _stencil_rows(f, vol_perm, sign, params)
    jf = torch.arange(n, dtype=torch.float32, device=f.device)[:, None]
    out = smooth_row(f, jf, rows, n, nr, nc, params.interpolation == Interpolation.TRILINEAR)
    return out.reshape(n, height, width)


def smooth_dd_transpose(feats: torch.Tensor, dd: torch.Tensor, nr: int, nc: int, bilinear: bool) -> torch.Tensor:
    """Transpose of the smoothing stencil: the (N, H, W) smoothed-density
    cotangent of every march step -> the cotangent of the plain rows, in
    march order.  Plain row k takes ``c_off(j) * dd[j]`` for every (j, off)
    with ``clamp(j + off) == k``, so the end rows collect the clamped taps;
    ``c_off`` is the weight of row j+off in :func:`smooth_row`, normalised.
    The counterpart of ``slab_bwd_kernel._smooth_dd_transpose``
    (``:895-965``) in its operation order, with the in-plane bounds ``nr``/
    ``nc`` (the texel counts) and the slab bound N.  The JAX package runs
    it in jnp, outside its kernels; it runs as written here on every
    device (the masks are kept as bools: ``where(in_box, x, 0)`` is
    ``x * in_box`` for the x >= 0 it takes)."""
    m, height, width = dd.shape
    f = feats.reshape(N_FEATURES, -1)
    ts = torch.where(f[F_TS] == 0.0, 1.0, f[F_TS])
    jf = torch.arange(m, dtype=torch.float32, device=dd.device)[:, None]
    rows_raw = f[F_RS] * jf + f[F_RB]  # (M, R)
    cols_raw = f[F_CS] * jf + f[F_CB]
    taps = []
    wsum = torch.zeros_like(rows_raw)
    for delta, w in GAUSS_TAPS:
        u = torch.full_like(ts, delta) / ts  # (R,)
        rt = rows_raw + u * f[F_RS]
        ct = cols_raw + u * f[F_CS]
        st = jf + u
        in_box = (
            (rt >= -0.5) & (rt <= nr - 0.5) & (ct >= -0.5) & (ct <= nc - 0.5) & (st >= -0.5) & (st <= m - 0.5)
        )
        del rt, ct, st
        taps.append((w, u, in_box))
        wsum = wsum + torch.where(in_box, w, 0.0)
    del rows_raw, cols_raw
    wsum = torch.where(wsum > 0.0, wsum, 1.0)
    dd2 = dd.reshape(m, -1)
    out = torch.zeros_like(dd2)
    idx = torch.arange(m, device=dd.device)
    for off in range(-SMOOTH_HALO, SMOOTH_HALO + 1):
        coeff = torch.zeros_like(dd2)
        for w, u, in_box in taps:
            d = u - off
            ker = torch.clamp(1.0 - torch.abs(d), min=0.0) if bilinear else ((d >= -0.5) & (d < 0.5)).float()
            coeff = coeff + torch.where(in_box, w * ker, 0.0)
        out.index_add_(0, torch.clamp(idx + off, 0, m - 1), coeff / wsum * dd2)
    return out.reshape(m, height, width)


def dense_dd(dd: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """``dd`` (N, H, W) or (N, 4, H, W) with every entry outside each ray's
    step range ``[steps[0], steps[1]]`` ((2, H, W) int32, :func:`replay_slabs`)
    set to 0.0: the plain replay's ``dd`` from the CUDA replay's, which
    leaves the entries outside the range unspecified.  For a reader of all
    of ``dd``; the fold reads only inside the range and needs none."""
    j = torch.arange(dd.shape[0], device=dd.device)[:, None, None]
    inside = (j >= steps[0]) & (j <= steps[1])
    return torch.where(inside[:, None] if dd.dim() == 4 else inside, dd, 0.0)


def voxel_grad(feats: torch.Tensor, dd: torch.Tensor, vol_shape, sign: int, params: RenderParams):
    """The voxel-gradient scatter: per-(march step, ray) cotangents ->
    ``(d_vol, d_grad)``.  The plain version of the CUDA kernels
    (``ops/csrc/voxel_grad.cu``) and the counterpart of the TPU's
    ``_voxel_grad_kernel`` (B3) and ``_voxel_grad_shaded_kernel`` (B4).

    ``dd``: (N, H, W) density cotangents in march order j, or (N, 4, H, W)
    with the three gradient-field channels.  Step j's cotangent goes into
    the physical plane k(j) with the sample's own bilinear or box weights at
    its snapped coordinates (:func:`_scatter_sample`).  ``vol_shape``: (N,
    rows, cols).  -> d_vol (N, rows, cols) and d_grad (3, N, rows, cols), or
    None for a 1-channel ``dd``."""
    f = feats.reshape(N_FEATURES, -1)
    n, nr, nc = vol_shape
    shaded = dd.dim() == 4
    dd = dd.reshape(n, 4 if shaded else 1, -1)
    bilinear = params.interpolation == Interpolation.TRILINEAR
    d_vol = torch.zeros((n, nr, nc), dtype=torch.float32, device=dd.device)
    d_grad = torch.zeros((3, n, nr, nc), dtype=torch.float32, device=dd.device) if shaded else None
    for j in range(n):
        k, _, rows_c, cols_c = _step_coords(f, j, n, nr, nc, sign, params.subtexel_bits)
        _scatter_sample(d_vol[k], rows_c, cols_c, dd[j, 0], bilinear)
        if shaded:
            for ch in range(3):
                _scatter_sample(d_grad[ch, k], rows_c, cols_c, dd[j, 1 + ch], bilinear)
    return d_vol, d_grad


def smooth_voxel_grad(feats: torch.Tensor, dd: torch.Tensor, steps, vol_shape, sign: int, params: RenderParams,
                      want_folded: bool = False):
    """The backward's scatter under Gaussian smoothing: the replay's
    per-step cotangents -> ``(d_vol, d_grad, folded)``.  The plain version
    of the fused fold-and-scatter kernel (``ops/csrc/voxel_grad.cu``,
    ``FOLD``), the redesigned B3 (``dd`` (N, H, W)) and B4 (``dd`` (N, 4, H,
    W)).

    The density channel goes through the stencil's transpose
    (:func:`smooth_dd_transpose`) onto the plain rows; the gradient-field
    channels pass as they are (the field is sampled at each step's own
    coordinates, ``slab_bwd_kernel.py:1684-1691``); then :func:`voxel_grad`
    scatters them.  ``folded``, the (N, H, W) plain-row density cotangents
    that the plain rows' camera chain (:func:`feats_grad`) reads, is
    returned when ``want_folded``, else None.  ``steps``, the replay's
    per-ray step range, can only skip zeros: it is not read here.  ``dd``
    is not modified."""
    _, nr, nc = vol_shape
    shaded = dd.dim() == 4
    folded = smooth_dd_transpose(feats, dd[:, 0] if shaded else dd, nr, nc,
                                 params.interpolation == Interpolation.TRILINEAR)
    plain = torch.cat([folded[:, None], dd[:, 1:]], dim=1) if shaded else folded
    d_vol, d_grad = voxel_grad(feats, plain, vol_shape, sign, params)
    return d_vol, d_grad, folded if want_folded else None


def lookahead_gate(
    feats: torch.Tensor, cone_feats: torch.Tensor | None, levels: torch.Tensor, sign: int, subtexel: int
) -> torch.Tensor:
    """The importance look-ahead gate -> (N, H, W) bool in march order j:
    the plain version of the CUDA gate kernels (``ops/csrc/lookahead.cu``)
    and the function the TPU's ``lookahead_kernel.lookahead_call`` computes.

    ``feats``: the (N_FEATURES, H, W) per-ray table; ``cone_feats``: the
    (CONE_FEATURES, H, W) cone table for the cone variant, or None for the
    straight one; ``levels``: the (N, rows, cols) :func:`importance_levels`
    of the permuted importance grid.

    A reverse march over j = N-1 .. 0 carries ``ns``, the march index of
    the next important crossing ahead: one for the straight variant, along
    the ray itself, and one per cone direction, each re-anchored at the
    camera.  Step j's bit is set when the step is in the ray's window, an
    important crossing lies ahead within the reference's probe range, and
    the ray's own nearest sample at j is not opaque.  The range ends at
    ``exit - |pos|``, a t-value minus the norm of the sample's position (the
    reference's ``max_distance - length(pos)``).  Then ``ns`` takes j where
    the step's nearest sample, snapped like the march's, is important:
    the ray's own sample inside its window (straight), or each cone
    direction's sample inside the box and ahead of the camera (cone, at
    every step whatever the main ray's window).  Every expression follows
    the TPU kernel's operation order (``lookahead_kernel.py:203-259``,
    ``:467-612``), so a compare such as ``ns <= m_end`` decides as there.
    """
    _, height, width = feats.shape
    f = feats.reshape(N_FEATURES, -1)
    n, nr, nc = levels.shape
    lv = levels.reshape(n, -1)
    sign_ok = f[F_SIGNOK] > 0.5
    entry, exit_, ts, c2, cd = f[F_ENTRY], f[F_EXIT], f[F_TS], f[F_C2], f[F_CD]
    cone = cone_feats is not None
    if cone:
        cf = cone_feats.reshape(CONE_SAMPLES, CF_STRIDE, -1)
        rate = cf[:, CF_RATE]
    ns = torch.full((CONE_SAMPLES if cone else 1, f.shape[1]), FAR, dtype=torch.float32, device=f.device)
    gate = torch.zeros((n, f.shape[1]), dtype=torch.bool, device=f.device)
    for j in reversed(range(n)):
        k, t, rows_c, cols_c = _step_coords(f, j, n, nr, nc, sign, subtexel)
        jf = torch.tensor(float(j), dtype=torch.float32, device=f.device)
        valid = sign_ok & (t >= entry) & (t < exit_)
        norm_pos = sqrt_rn(torch.clamp(c2 + 2.0 * t * cd + t * t, min=0.0))
        level = lv[k][_nearest_tap(rows_c, cols_c, nr, nc)]
        if cone:
            d_range = exit_ - norm_pos
            ahead = ((ns <= jf + d_range * rate) & (rate > 0.0)).any(0) & valid
            rows_u = cf[:, CF_RS] * jf + cf[:, CF_RB]
            cols_u = cf[:, CF_CS] * jf + cf[:, CF_CB]
            t_c = cf[:, CF_TS] * jf + cf[:, CF_TB]
            inbox = (
                (rows_u >= -0.5) & (rows_u <= nr - 0.5) & (cols_u >= -0.5) & (cols_u <= nc - 0.5) & (t_c > 0.0)
            )
            rows_s = snap(torch.clamp(rows_u, 0.0, nr - 1.0), subtexel)
            cols_s = snap(torch.clamp(cols_u, 0.0, nc - 1.0), subtexel)
            hit = (lv[k][_nearest_tap(rows_s, cols_s, nr, nc)] >= 1) & inbox
        else:
            m_end = jf + (exit_ - norm_pos) / ts
            ahead = (ns[0] <= m_end) & valid
            hit = ((level >= 1) & valid)[None]
        gate[j] = ahead & (level < 2)
        ns = torch.where(hit, jf, ns)
    return gate.reshape(n, height, width)


def _blinn_phong(rgb: torch.Tensor, g: torch.Tensor, half: torch.Tensor):
    """Blinn-Phong from a gradient-field sample g (R, 3) (``wgsl:190-211``):
    (shaded rgb, unit normal, nonzero mask, the diffuse dot before its
    clamp, h.n, the shade factor), in the CUDA march's operation order."""
    nrm, nonzero = safe_normalize(g)
    s_diff = (nrm[:, 0:1] + nrm[:, 1:2] + nrm[:, 2:3]) * INV_SQRT3
    hdotn = half[:, 0:1] * nrm[:, 0:1] + half[:, 1:2] * nrm[:, 1:2] + half[:, 2:3] * nrm[:, 2:3]
    spec = torch.clamp(hdotn, min=0.0) ** SHININESS
    shade_f = AMBIENT + DIFFUSE * torch.clamp(s_diff, min=0.0)
    shaded = rgb * shade_f + SPECULAR * spec
    return torch.where(nonzero, shaded, rgb), nrm, nonzero, s_diff, hdotn, shade_f


def march_slabs(
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
    """Front-to-back slab march -> (H, W, 4) image.

    ``feats``: (N_FEATURES, H, W) per-ray table (``F_*`` rows).
    ``vol_perm``: (N, rows, cols) permuted grid, float32 in [0, 1], or the
    uint8 grid when ``u8`` (the march then runs in the 0..255 domain).
    ``grad_perm``: (3, N, rows, cols) permuted :func:`gradient_volume`,
    required when ``params.use_shading``.

    ``emit_density``: also return the stored-density residual the replay
    (:func:`replay_slabs`) reads instead of re-sampling, as ``(img, dens)``.
    ``dens`` is (N, H, W) float32 in march order j, or (N, 4, H, W) when
    shaded.  Row 0 holds the sampled density (0..255 in the u8 domain) at
    every step the kernel samples (sign flag set, ``entry <= t < exit``,
    alpha below the early-termination alpha before the step, gate bit
    clear) and exactly 0.0 elsewhere; rows 1..3 hold the gradient-field
    sample where the density also passes the threshold, and 0.0
    elsewhere.  A step that was not sampled then contributes exactly
    nothing to the replay.

    ``gate``: the (N, H, W) bool look-ahead gate (:func:`lookahead_gate`);
    a step whose bit is set adds nothing, as if its density were below the
    threshold.

    With ``params.use_gaussian_smoothing`` the step's density is the
    smoothed one (:func:`smoothed_densities`): the threshold mask, the TF
    lookup and the residual's row 0 read it, while the gradient field is
    still sampled at the step's own coordinates.

    ``params.use_importance_coloring`` takes the step's colour and opacity
    from ``imp_perm``, the (N, rows, cols) float32 permuted importance grid,
    sampled with the box tap at the step's snapped coordinates, through
    :func:`golden.importance_to_color` (``slab_kernel.py:1182-1196``); the
    LUT is not read and the density is only the threshold mask.  It
    composes with shading and smoothing.  First-hit (``use_opacity``
    False, unless coloring: ``slab_kernel.py:1451``) sets the colour of the
    first step that passes the mask and alpha to ``max(acc_a, 1)``, which
    retires the ray through the early-termination alpha
    (``slab_kernel.py:1248-1256``).
    """
    _, height, width = feats.shape
    f = feats.reshape(N_FEATURES, -1)
    n, nr, nc = vol_perm.shape
    threshold, early_alpha, dscale = march_knobs(params, u8)
    bits = params.subtexel_bits
    sample2d = _bilinear_slice if params.interpolation == Interpolation.TRILINEAR else _nearest_slice
    shading = params.use_shading
    if shading and grad_perm is None:
        raise ValueError("shading needs the permuted gradient field")
    coloring = params.use_importance_coloring
    if coloring and imp_perm is None:
        raise ValueError("importance coloring needs the permuted importance grid")
    first_hit = not (params.use_opacity or coloring)
    smooth = (
        smoothed_densities(feats, vol_perm, sign, params).reshape(n, -1) if params.use_gaussian_smoothing else None
    )

    sign_ok = f[F_SIGNOK] > 0.5
    entry, exit_, aexp = f[F_ENTRY], f[F_EXIT], f[F_AEXP]
    half = f[F_HX : F_HZ + 1].t()
    acc_c = torch.zeros((f.shape[1], 3), dtype=torch.float32, device=f.device)
    acc_a = torch.zeros((f.shape[1],), dtype=torch.float32, device=f.device)
    dens = (
        torch.zeros((n, 4 if shading else 1, f.shape[1]), dtype=torch.float32, device=f.device)
        if emit_density
        else None
    )
    for j in range(n):
        k, t, rows_c, cols_c = _step_coords(f, j, n, nr, nc, sign, bits)
        density = smooth[j] if smooth is not None else sample2d(vol_perm[k], rows_c, cols_c)
        live = sign_ok & (t >= entry) & (t < exit_) & (acc_a < early_alpha)
        if gate is not None:
            live = live & ~gate[j].reshape(-1)
        m = live & (density >= threshold)

        if coloring:
            rgba = importance_to_color(_nearest_slice(imp_perm[k], rows_c, cols_c))
        else:
            rgba = lut_sample(lut, density, dscale)
        rgb = rgba[:, :3]
        if shading:
            g = torch.stack([sample2d(grad_perm[c, k], rows_c, cols_c) for c in range(3)], dim=-1)
            rgb = _blinn_phong(rgb, g, half)[0]
            if emit_density:
                dens[j, 1:] = torch.where(m, g.t(), 0.0)
        if emit_density:
            dens[j, 0] = torch.where(live, density, 0.0)

        if first_hit:
            mf = m.float()
            acc_c = acc_c * (1.0 - mf)[:, None] + rgb * mf[:, None]
            acc_a = torch.maximum(acc_a, mf)
            continue
        alpha = 1.0 - torch.exp(aexp * torch.log(torch.clamp(1.0 - rgba[:, 3], min=1e-37)))
        w = (1.0 - acc_a) * alpha * m.float()
        acc_c = acc_c + rgb * w[:, None]
        acc_a = acc_a + w
    img = torch.cat([acc_c, acc_a[:, None]], dim=-1)
    miss = (exit_ <= entry)[:, None]
    img = torch.where(miss, torch.tensor(MISS_COLOR, dtype=torch.float32, device=f.device), img)
    img = img.reshape(height, width, 4)
    if not emit_density:
        return img
    return img, (dens.reshape(n, height, width) if not shading else dens.reshape(n, 4, height, width))


def replay_slabs(
    feats: torch.Tensor,
    vol_perm: torch.Tensor,
    lut: torch.Tensor,
    sign: int,
    params: RenderParams,
    out: torch.Tensor,
    g_img: torch.Tensor,
    grad_perm: torch.Tensor | None = None,
    u8: bool = False,
    dens: torch.Tensor | None = None,
    gate: torch.Tensor | None = None,
    imp_perm: torch.Tensor | None = None,
):
    """Replay backward of :func:`march_slabs` -> ``(d_vol, d_grad, d_lut)``.

    The plain version of the CUDA replay kernel (``ops/csrc/slab_replay.cu``)
    and the counterpart of the TPU replay with its fused voxel scatter
    (``slab_bwd_kernel._replay_step_body``).  It re-runs the compositing
    recurrence plane by plane, rebuilds each step's transmittance from the
    running accumulator and its suffix from the final image ``out``, and
    chains the image cotangent ``g_img`` (H, W, 4) through the opacity
    correction, the shading and the TF lookup.

    ``dens``: the forward's residual (``march_slabs(..., emit_density=True)``);
    without it the volume (and the gradient field) is re-sampled.  Both
    routes give the same bits.  ``gate``: the forward's (N, H, W) bool
    look-ahead gate; a step whose bit is set adds nothing in either
    direction (``slab_bwd_kernel.py:633-637``), and the gate has no
    cotangent.

    ``d_vol`` (N, rows, cols) is d/d(``vol_perm`` as marched): in the u8
    domain d/d(scaled density), which the caller multiplies by 255.
    ``d_grad`` is (3, N, rows, cols) when shaded, else None; ``d_lut`` is
    (LN, 4).  The TF-coordinate derivative follows the TPU kernel: the
    slope ``lut[i1] - lut[i0]`` inside a texel, 0 at an integer coordinate,
    and none where the raw coordinate is clamped.

    Under Gaussian smoothing the replay cannot scatter: a step's density
    cotangent belongs to its smoothed density, a stencil over the plain
    rows.  It then replays the smoothed density (stored, or re-sampled
    through :func:`smoothed_densities`) and returns ``(dd, steps, d_lut)``:
    ``dd``, the TPU replay's unfused output, (N, H, W) holds each step's
    smoothed-density cotangent in march order, or (N, 4, H, W) when shaded
    with the gradient-field cotangent in rows 1..3, and exactly 0.0 at the
    steps that composite nothing; ``steps`` (2, H, W) int32 holds the first
    and the last march step of each ray at which the replay writes a
    cotangent (a composited step whose TF coordinate lies inside the LUT,
    or that is lit when shaded), ``(N, -1)`` for a ray with none, so ``dd``
    is 0.0 outside them.  :func:`smooth_voxel_grad` takes it from there.

    Under importance coloring (``imp_perm``, as in :func:`march_slabs`) the
    colour comes from the box-sampled importance and the density is only
    the threshold mask, so the result is ``(d_imp, d_grad, d_lut)`` in every
    case, smoothed too (nothing is folded, ``slab_bwd_kernel.py:1684-1691``):
    ``d_imp`` (N, rows, cols) takes each step's d_r * 1.5 * [1.5 imp < 1] -
    1.2 d_g + d_a (``:704-711``) with the sample's box hat, ``d_grad`` the
    gradient-field cotangent with its own hats when shaded, and ``d_lut``
    stays 0.

    With ``params.camera_grads`` the result gains ``d_feats`` (N_FEATURES,
    H, W), the cotangent of the per-ray table (``_replay_step_body``
    ``:817-892``): F_RS/F_RB/F_CS/F_CB from the coordinate derivative of
    the density sample (:func:`_dsample`; unsmoothed only, not under
    coloring) and, when shaded, of the three gradient-field samples, with
    trilinear sampling only (box hats have none); F_AEXP through the
    opacity correction; F_HX..F_HZ through the half vector when shaded;
    F_TS, under smoothing with trilinear sampling and without coloring,
    through the stencil's tap offsets (:func:`smooth_row_dts`).  Every
    other row is 0.  The rows/cols chain of the smoothed density is
    :func:`feats_grad`'s, after the stencil's transpose.  Camera cotangents
    need the volume: no residual.
    """
    camera = params.camera_grads
    if camera and dens is not None:
        raise ValueError("camera cotangents need the re-sampled replay: the stored residual has no coordinates")
    coloring = params.use_importance_coloring
    if coloring and imp_perm is None:
        raise ValueError("importance coloring needs the permuted importance grid")
    f = feats.reshape(N_FEATURES, -1)
    n_rays = f.shape[1]
    n, nr, nc = vol_perm.shape
    ln = lut.shape[0]
    threshold, early_alpha, dscale = march_knobs(params, u8)
    tf_scale = float(ln) * (dscale if dscale else 1.0)
    bits = params.subtexel_bits
    bilinear = params.interpolation == Interpolation.TRILINEAR
    sample2d = _bilinear_slice if bilinear else _nearest_slice
    shading = params.use_shading
    smoothing = params.use_gaussian_smoothing
    unfused = smoothing and not coloring  # the per-step cotangents belong to the smoothed density
    if shading and grad_perm is None and dens is None:
        raise ValueError("shading needs the permuted gradient field")
    if dens is not None:
        dens = dens.reshape(n, 4 if shading else 1, n_rays)
    elif smoothing:
        rows = _stencil_rows(f, vol_perm, sign, params)
        jf_all = torch.arange(n, dtype=torch.float32, device=f.device)[:, None]
        smooth = smooth_row(f, jf_all, rows, n, nr, nc, bilinear)
        dts = smooth_row_dts(f, jf_all, rows, n, nr, nc, bilinear) if camera and bilinear and unfused else None
        del rows

    sign_ok = f[F_SIGNOK] > 0.5
    entry, exit_, aexp = f[F_ENTRY], f[F_EXIT], f[F_AEXP]
    half = f[F_HX : F_HZ + 1].t()
    fin = out.reshape(n_rays, 4)
    g = g_img.reshape(n_rays, 4)
    g_c, g_a = g[:, :3], g[:, 3]
    dev = f.device
    if unfused:
        dd_out = torch.zeros((n, 4 if shading else 1, n_rays), dtype=torch.float32, device=dev)
        first = torch.full((n_rays,), n, dtype=torch.int32, device=dev)
        last = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    else:
        d_vol = torch.zeros((n, nr, nc), dtype=torch.float32, device=dev)  # d_imp under coloring
        d_grad = torch.zeros((3, n, nr, nc), dtype=torch.float32, device=dev) if shading else None
    d_lut = torch.zeros((ln, 4), dtype=torch.float32, device=dev)
    d_feats = torch.zeros_like(f) if camera else None
    acc_c = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    acc_a = torch.zeros((n_rays,), dtype=torch.float32, device=dev)
    for j in range(n):
        k, t, rows_c, cols_c = _step_coords(f, j, n, nr, nc, sign, bits)
        coord_chain = camera and bilinear  # the coordinates' chain (box hats have none)
        if coord_chain:
            masks = _coord_masks(f, float(j), nr, nc)
        if dens is not None:
            density = dens[j, 0]
        else:
            density = smooth[j] if smoothing else sample2d(vol_perm[k], rows_c, cols_c)
        live = sign_ok & (t >= entry) & (t < exit_) & (acc_a < early_alpha)
        if gate is not None:
            live = live & ~gate[j].reshape(-1)
        mf = (live & (density >= threshold)).float()

        if coloring:
            imp = _nearest_slice(imp_perm[k], rows_c, cols_c)
            rgba = importance_to_color(imp)
        else:
            # the TF lookup of lut_sample, keeping its texels and fraction
            c_raw = density * tf_scale - 0.5
            c = torch.clamp(c_raw, 0.0, ln - 1.0)
            i0f = torch.floor(c)
            fr = c - i0f
            i0 = i0f.long()
            i1 = torch.clamp(i0 + 1, max=ln - 1)
            rgba = lut[i0] * (1.0 - fr)[:, None] + lut[i1] * fr[:, None]
        rgb = rgba[:, :3]
        if shading:
            if dens is not None:
                gs = dens[j, 1:].t()
            else:
                gs = torch.stack([sample2d(grad_perm[ch, k], rows_c, cols_c) for ch in range(3)], dim=-1)
            rgb, nrm, nonzero, s_diff, hdotn, shade_f = _blinn_phong(rgb, gs, half)

        log1ma = torch.log(torch.clamp(1.0 - rgba[:, 3], min=1e-37))
        alpha = 1.0 - torch.exp(aexp * log1ma)
        t_k = 1.0 - acc_a
        beta = alpha * mf
        w = t_k * alpha * mf
        acc_c = acc_c + rgb * w[:, None]
        acc_a = acc_a + w
        suf_c = fin[:, :3] - acc_c
        suf_a = fin[:, 3] - acc_a

        inv = 1.0 / torch.clamp(1.0 - beta, min=1e-7)
        d_beta = t_k * ((g_c * rgb).sum(-1) + g_a) - ((g_c * suf_c).sum(-1) + g_a * suf_a) * inv
        d_alpha = d_beta * mf
        d_a = d_alpha * aexp * torch.exp((aexp - 1.0) * log1ma)
        d_rgb = g_c * w[:, None]
        if shading:
            # rgb = nonzero ? tf_rgb * shade_f + S * spec : tf_rgb
            nzf = nonzero.float()
            d_diffuse = (d_rgb * rgba[:, :3]).sum(-1, keepdim=True) * DIFFUSE * nzf
            d_spec = d_rgb.sum(-1, keepdim=True) * SPECULAR * nzf
            spec_base = torch.clamp(hdotn, min=0.0)
            d_hdotn = torch.where(hdotn > 0.0, d_spec * SHININESS * spec_base ** (SHININESS - 1.0), 0.0)
            d_sdiff = torch.where(s_diff > 0.0, d_diffuse, 0.0)
            d_n = d_sdiff * INV_SQRT3 + d_hdotn * half
            n_dot_dn = (nrm * d_n).sum(-1, keepdim=True)
            sq = gs[:, 0:1] * gs[:, 0:1] + gs[:, 1:2] * gs[:, 1:2] + gs[:, 2:3] * gs[:, 2:3]
            inv_norm = 1.0 / sqrt_rn(torch.where(nonzero, sq, 1.0))
            d_g = inv_norm * (d_n - nrm * n_dot_dn) * nzf
            d_rgb = d_rgb * torch.where(nonzero, shade_f, 1.0)
            for ch in range(3):
                if unfused:
                    dd_out[j, 1 + ch] = d_g[:, ch]
                else:
                    _scatter_sample(d_grad[ch, k], rows_c, cols_c, d_g[:, ch], bilinear)
            if camera:
                d_feats[F_HX : F_HZ + 1] += (d_hdotn * nrm).t()
        d_rgba = torch.cat([d_rgb, d_a[:, None]], dim=-1)

        if coloring:
            # rgba = (min(1.5 imp, 1), 1.2 (1 - imp), 0.2, imp)
            dd = d_rgba[:, 0] * torch.where(imp * 1.5 < 1.0, 1.5, 0.0) - d_rgba[:, 1] * 1.2 + d_rgba[:, 3]
            _scatter_sample(d_vol[k], rows_c, cols_c, dd, False)
        else:
            d_lut.index_add_(0, i0, d_rgba * (1.0 - fr)[:, None])
            d_lut.index_add_(0, i1, d_rgba * fr[:, None])
            slope = torch.where((fr > 0.0)[:, None], lut[i1] - lut[i0], 0.0)
            dd = (d_rgba * slope).sum(-1) * tf_scale
            tf_in = (fr > 0.0) & (c_raw > 0.0) & (c_raw < ln - 1.0)
            dd = dd * tf_in.float()
            if unfused:
                dd_out[j, 0] = dd
                written = (mf > 0.0) & (tf_in | nonzero[:, 0]) if shading else (mf > 0.0) & tf_in
                first = torch.where(written & (first == n), j, first)
                last = torch.where(written, j, last)
            else:
                _scatter_sample(d_vol[k], rows_c, cols_c, dd, bilinear)
        if not camera:
            continue
        d_feats[F_AEXP] += d_alpha * log1ma * (alpha - 1.0)
        if coord_chain:
            d_rows = torch.zeros_like(dd)
            d_cols = torch.zeros_like(dd)
            if not (smoothing or coloring):
                d_rows, d_cols = _coord_chain(vol_perm[k], rows_c, cols_c, masks, dd)
            if shading:
                for ch in range(3):
                    g_rows, g_cols = _coord_chain(grad_perm[ch, k], rows_c, cols_c, masks, d_g[:, ch])
                    d_rows = d_rows + g_rows
                    d_cols = d_cols + g_cols
            _add_coord_chain(d_feats, j, d_rows, d_cols)
            if unfused:
                d_feats[F_TS] += dd * dts[j]
    height, width = out.shape[:2]
    extra = (d_feats.reshape(N_FEATURES, height, width),) if camera else ()
    if unfused:
        dd_out = dd_out.reshape(n, 4, height, width) if shading else dd_out.reshape(n, height, width)
        return dd_out, torch.stack([first, last]).reshape(2, height, width), d_lut, *extra
    return d_vol, d_grad, d_lut, *extra


def feats_grad(feats: torch.Tensor, vol_perm: torch.Tensor, dd: torch.Tensor, sign: int, params: RenderParams):
    """The camera chain of the plain density rows under Gaussian smoothing
    -> d_feats (N_FEATURES, H, W), nonzero in F_RS/F_RB/F_CS/F_CB only.
    After :func:`smooth_voxel_grad`, the plain version of the fused CUDA
    kernel's ``CHAIN`` variant (``ops/csrc/voxel_grad.cu``) and the
    counterpart of the TPU's ``_feats_grad_kernel`` (B5, ``:968-1061``).

    ``dd``: (N, H, W) plain-row density cotangents in march order, the
    output of :func:`smooth_dd_transpose`.  A smoothed step's density mixes
    the plain rows of later steps, so their coordinate chain exists only
    after the whole replay and the transpose: step j's cotangent times the
    coordinate derivative of its own plain sample (:func:`_dsample` at the
    step's snapped coordinates in the f32 slice ``vol_perm[k(j)]``), masked
    where the raw coordinate is clipped, and accumulated over j in order.
    Trilinear sampling only: box hats have no coordinate derivative."""
    if params.interpolation != Interpolation.TRILINEAR:
        raise ValueError("the plain rows' camera chain needs trilinear sampling: box hats have no derivative")
    _, height, width = feats.shape
    f = feats.reshape(N_FEATURES, -1)
    n, nr, nc = vol_perm.shape
    d = dd.reshape(n, -1)
    out = torch.zeros_like(f)
    for j in range(n):
        k, _, rows_c, cols_c = _step_coords(f, j, n, nr, nc, sign, params.subtexel_bits)
        d_rows, d_cols = _coord_chain(vol_perm[k], rows_c, cols_c, _coord_masks(f, float(j), nr, nc), d[j])
        _add_coord_chain(out, j, d_rows, d_cols)
    return out.reshape(N_FEATURES, height, width)


def render(scene, camera_matrices, params: RenderParams, height: int, width: int) -> torch.Tensor:
    """Plain slab render -> (H, W, 4) on the scene's device."""
    from volym_tpu_torch.ops import slab_march

    return slab_march.render(
        scene, camera_matrices, params, height, width, march_fn=march_slabs, gate_fn=lookahead_gate
    )


def render_diff(scene, camera_matrices, params: RenderParams, height: int, width: int) -> torch.Tensor:
    """Plain differentiable slab render -> (H, W, 4) on the scene's device:
    :func:`march_slabs` forward and :func:`replay_slabs` backward (with
    :func:`smooth_voxel_grad` and, for camera gradients, :func:`feats_grad`
    under smoothing; gated by :func:`lookahead_gate` under look-ahead), the
    counterpart of the jnp ``slab.render_diff`` (see
    :func:`volym_tpu_torch.ops.slab_march.render_diff`)."""
    from volym_tpu_torch.ops import slab_march

    return slab_march.render_diff(
        scene, camera_matrices, params, height, width, march_fn=march_slabs, replay_fn=replay_slabs,
        scatter_fn=smooth_voxel_grad, feats_grad_fn=feats_grad, gate_fn=lookahead_gate,
    )
