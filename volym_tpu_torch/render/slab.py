"""Slab-marching renderer: plain PyTorch version.

Counterpart of :mod:`volym_tpu.render.slab` for the base and shading
modes, forward (with importance look-ahead) and backward (without camera
gradients or look-ahead).  The march steps
along the camera's dominant axis one voxel plane at a time, so every
sample lies on a plane and trilinear filtering is bilinear inside one
slice (see the JAX module for the derivation).

:func:`march_slabs` is the plain version of the CUDA march kernel
(:mod:`volym_tpu_torch.ops.slab_march`): it reads the same per-ray table and
evaluates every per-sample expression in the order the kernel does, so on
one device the two agree to the rounding of ``exp``/``log``/``pow``.  It
also runs the u8 scaled density domain of the TPU kernel, and emits the
stored-density residual.  :func:`replay_slabs` is the plain version of the
CUDA replay backward (:mod:`volym_tpu_torch.ops.slab_replay`), and
:func:`lookahead_gate` that of the CUDA look-ahead gate
(:mod:`volym_tpu_torch.ops.lookahead`).

Rays whose dominant-axis direction component opposes the camera forward
axis (possible at extreme fov) render as (0, 0, 0, 0), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from volym_tpu_torch.config import Interpolation, RenderParams
from volym_tpu_torch.render.golden import CONE_SAMPLES
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
    """Effective sample-plane count of a render (:func:`step_planes`)."""
    if params.use_gaussian_smoothing:
        raise NotImplementedError(
            "Gaussian smoothing is not ported to volym_tpu_torch yet "
            "(pass --no-gaussian / use_gaussian_smoothing=False)"
        )
    return step_planes(params.raymarching_step_size, n_slabs)


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
    alpha below the early-termination alpha before the step) and exactly
    0.0 elsewhere; rows 1..3 hold the gradient-field sample where the
    density also passes the threshold, and 0.0 elsewhere.  A step that was
    not sampled then contributes exactly nothing to the replay.

    ``gate``: the (N, H, W) bool look-ahead gate (:func:`lookahead_gate`);
    a step whose bit is set adds nothing, as if its density were below the
    threshold.  The residual with a gate belongs to the look-ahead's
    backward, which is not ported yet.
    """
    if gate is not None and emit_density:
        raise NotImplementedError("the stored-density residual with a look-ahead gate is not ported yet")
    _, height, width = feats.shape
    f = feats.reshape(N_FEATURES, -1)
    n, nr, nc = vol_perm.shape
    threshold, early_alpha, dscale = march_knobs(params, u8)
    bits = params.subtexel_bits
    sample2d = _bilinear_slice if params.interpolation == Interpolation.TRILINEAR else _nearest_slice
    shading = params.use_shading
    if shading and grad_perm is None:
        raise ValueError("shading needs the permuted gradient field")

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
        density = sample2d(vol_perm[k], rows_c, cols_c)
        live = sign_ok & (t >= entry) & (t < exit_) & (acc_a < early_alpha)
        m = live & (density >= threshold)
        if gate is not None:
            m = m & ~gate[j].reshape(-1)

        rgba = lut_sample(lut, density, dscale)
        rgb = rgba[:, :3]
        if shading:
            g = torch.stack([sample2d(grad_perm[c, k], rows_c, cols_c) for c in range(3)], dim=-1)
            rgb = _blinn_phong(rgb, g, half)[0]
            if emit_density:
                dens[j, 1:] = torch.where(m, g.t(), 0.0)
        if emit_density:
            dens[j, 0] = torch.where(live, density, 0.0)

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
    routes give the same bits.

    ``d_vol`` (N, rows, cols) is d/d(``vol_perm`` as marched): in the u8
    domain d/d(scaled density), which the caller multiplies by 255.
    ``d_grad`` is (3, N, rows, cols) when shaded, else None; ``d_lut`` is
    (LN, 4).  The TF-coordinate derivative follows the TPU kernel: the
    slope ``lut[i1] - lut[i0]`` inside a texel, 0 at an integer coordinate,
    and none where the raw coordinate is clamped.
    """
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
    if shading and grad_perm is None and dens is None:
        raise ValueError("shading needs the permuted gradient field")
    if dens is not None:
        dens = dens.reshape(n, 4 if shading else 1, n_rays)

    sign_ok = f[F_SIGNOK] > 0.5
    entry, exit_, aexp = f[F_ENTRY], f[F_EXIT], f[F_AEXP]
    half = f[F_HX : F_HZ + 1].t()
    fin = out.reshape(n_rays, 4)
    g = g_img.reshape(n_rays, 4)
    g_c, g_a = g[:, :3], g[:, 3]
    dev = f.device
    d_vol = torch.zeros((n, nr, nc), dtype=torch.float32, device=dev)
    d_grad = torch.zeros((3, n, nr, nc), dtype=torch.float32, device=dev) if shading else None
    d_lut = torch.zeros((ln, 4), dtype=torch.float32, device=dev)
    acc_c = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    acc_a = torch.zeros((n_rays,), dtype=torch.float32, device=dev)
    for j in range(n):
        k, t, rows_c, cols_c = _step_coords(f, j, n, nr, nc, sign, bits)
        density = dens[j, 0] if dens is not None else sample2d(vol_perm[k], rows_c, cols_c)
        live = sign_ok & (t >= entry) & (t < exit_) & (acc_a < early_alpha)
        mf = (live & (density >= threshold)).float()

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
                _scatter_sample(d_grad[ch, k], rows_c, cols_c, d_g[:, ch], bilinear)
        d_rgba = torch.cat([d_rgb, d_a[:, None]], dim=-1)

        d_lut.index_add_(0, i0, d_rgba * (1.0 - fr)[:, None])
        d_lut.index_add_(0, i1, d_rgba * fr[:, None])
        slope = torch.where((fr > 0.0)[:, None], lut[i1] - lut[i0], 0.0)
        dd = (d_rgba * slope).sum(-1) * tf_scale
        dd = dd * ((c_raw > 0.0) & (c_raw < ln - 1.0)).float()
        _scatter_sample(d_vol[k], rows_c, cols_c, dd, bilinear)
    return d_vol, d_grad, d_lut


def render(scene, camera_matrices, params: RenderParams, height: int, width: int) -> torch.Tensor:
    """Plain slab render -> (H, W, 4) on the scene's device."""
    from volym_tpu_torch.ops import slab_march

    return slab_march.render(
        scene, camera_matrices, params, height, width, march_fn=march_slabs, gate_fn=lookahead_gate
    )


def render_diff(scene, camera_matrices, params: RenderParams, height: int, width: int) -> torch.Tensor:
    """Plain differentiable slab render -> (H, W, 4) on the scene's device:
    :func:`march_slabs` forward and :func:`replay_slabs` backward, the
    counterpart of the jnp ``slab.render_diff`` (see
    :func:`volym_tpu_torch.ops.slab_march.render_diff`)."""
    from volym_tpu_torch.ops import slab_march

    return slab_march.render_diff(
        scene, camera_matrices, params, height, width, march_fn=march_slabs, replay_fn=replay_slabs
    )
