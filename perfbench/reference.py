"""The plain reference of the slab renderer: forward, look-ahead gate and
the training step's gradients, in plain PyTorch.

It imports nothing of the program (``volym_tpu_torch``) and nothing of the
JAX package.  It is a frozen transcription of the slab march's semantics
(the JAX package's ``render/slab.py`` and the reference shader it models):
the march steps along the camera's dominant axis one voxel plane at a time;
every sample is taken at coordinates snapped to ``subtexel_bits``
fractional bits; the density is smoothed along the ray by a 5-tap Gaussian
over the plain rows of the neighbouring steps; the TF lookup is linear,
clamp-to-edge; shading is Blinn-Phong from a gradient field sampled at the
step; compositing is front to back with the opacity correction
``1 - (1 - a) ** aexp`` and early termination at ``early_termination_alpha``.
Every per-sample expression is written in the order the shader model fixes
(divisions tensor by tensor, square roots correctly rounded), so that the
snap and the threshold decide as in any faithful float32 implementation.

Gradients come from ``torch.autograd`` through this forward, with the
derivative conventions the renderer's spec states at its two non-smooth
points: the TF lookup's slope is ``lut[i1] - lut[i0]`` strictly inside a
texel and 0 at an integer or clamped coordinate, and the opacity
correction's derivative is ``aexp * (1 - a) ** (aexp - 1)`` with ``1 - a``
floored at 1e-37.  Masks (window, threshold, early termination, gate)
carry no gradient.

``dtype`` is the precision of the data path (densities, gradient field,
LUT, colours, accumulators); the ray geometry stays float32.  The control
of ``correct`` runs it in bfloat16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

F32 = torch.float32

#: rows of the per-ray table: affine coefficients of rows, cols and t in the
#: march index, the [entry, exit) window, the opacity exponent, the sign
#: flag, the half vector, cam.dir and |cam|^2
F_RS, F_RB, F_CS, F_CB, F_TS, F_TB, F_ENTRY, F_EXIT, F_AEXP, F_SIGNOK = range(10)
F_HX, F_HY, F_HZ, F_CD, F_C2 = 10, 11, 12, 13, 14
N_FEATURES = 15
#: the cone table's rows per direction (affine rows, cols, t and the rate)
CF_RS, CF_RB, CF_CS, CF_CB, CF_TS, CF_TB, CF_RATE = range(7)
CF_STRIDE = 7
CONE_SAMPLES, CONE_ANGLE = 8, 0.2
#: per dominant axis: (permutation of a (D, H, W) grid, row component, column component)
AXIS_LAYOUT = {2: ((0, 1, 2), 1, 0), 1: ((1, 0, 2), 2, 0), 0: ((2, 1, 0), 1, 2)}
STEP_LADDER = (4.0, 2.0, 1.0, 0.5, 0.25)
GAUSSIAN_KERNEL_SIZE, GAUSSIAN_STEP, GAUSSIAN_SIGMA = 2, 0.005, 1.5
SMOOTH_HALO = 3
SMOOTH_MAX_PLANES = int(SMOOTH_HALO / (GAUSSIAN_KERNEL_SIZE * GAUSSIAN_STEP))
GAUSS_TAPS = tuple(
    (float(np.float32(i * GAUSSIAN_STEP)),
     float(np.float32(math.exp(-((i * GAUSSIAN_STEP) ** 2) / (2.0 * GAUSSIAN_SIGMA * GAUSSIAN_SIGMA)))))
    for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1)
)
GRADIENT_OFFSET = 0.01
AMBIENT, DIFFUSE, SPECULAR, SHININESS = 0.2, 0.7, 0.4, 24.0
INV_SQRT3 = 0.57735026
MISS_COLOR = (0.0, 0.0, 0.0, 1.0)
IMPORTANT_AHEAD, IMPORTANT_OPAQUE, FAR = 0.5, 1.0, 1e9


@dataclass(frozen=True)
class Params:
    """The render parameters the reference reads (a configuration's
    ``params``; names as in the program's ``RenderParams``)."""

    density_threshold: float = 0.12
    raymarching_step_size: float = 0.01
    interpolation: str = "nearest"
    early_termination_alpha: float = 0.95
    use_shading: bool = True
    use_gaussian_smoothing: bool = True
    use_importance_rendering: bool = False
    use_cone_importance_check: bool = False
    subtexel_bits: int = 8

    @classmethod
    def from_config(cls, params: dict) -> "Params":
        """The reference's parameters from a configuration's ``params``;
        a mode the reference does not implement is refused."""
        if params.get("use_importance_coloring") or not params.get("use_opacity", True):
            raise NotImplementedError("the reference renders alpha-composited frames without coloring")
        if params.get("u8_volume"):
            raise NotImplementedError("the reference marches the float32 volume")
        names = cls.__dataclass_fields__
        return cls(**{k: v for k, v in params.items() if k in names})

    @property
    def trilinear(self) -> bool:
        return self.interpolation == "trilinear"


# ---- the frame's layout and its grids -------------------------------------------------------------


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (the float64 root, rounded once)."""
    return torch.sqrt(x.double()).float()


def norm3(v: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(v[:, 0:1] * v[:, 0:1] + v[:, 1:2] * v[:, 1:2] + v[:, 2:3] * v[:, 2:3])


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (TwoSum on the float64 sum)."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r64 = r.double()
    r = torch.where((s == (r64 + up.double()) * 0.5) & (err > 0), up, r)
    return torch.where((s == (r64 + down.double()) * 0.5) & (err < 0), down, r)


def dominant_axis(view: np.ndarray) -> tuple[int, int]:
    """(major component, march sign) from the view matrix's forward row."""
    fwd = -np.asarray(view, np.float32)[2, :3]
    m = int(np.argmax(np.abs(fwd)))
    return m, (1 if fwd[m] > 0 else -1)


def plane_count(p: Params, n: int) -> int:
    """Sample planes for the step size, bucketed to the ladder in log space;
    under smoothing at most SMOOTH_MAX_PLANES and a multiple of 8."""
    if p.raymarching_step_size <= 0.0:
        planes = n
    else:
        f = (1.0 / n) / p.raymarching_step_size
        planes = max(1, int(round(n * min(STEP_LADDER, key=lambda x: abs(math.log(f / x))))))
    if p.use_gaussian_smoothing:
        planes = min(planes, n, SMOOTH_MAX_PLANES)
        if planes % 8:
            planes = max(8, planes // 8 * 8)
    return planes


def resample(grid: torch.Tensor, planes: int) -> torch.Tensor:
    """Linear resample along the leading (slab) axis, clamp-to-edge."""
    n = grid.shape[0]
    if planes == n:
        return grid
    ar = torch.arange(planes, dtype=F32, device=grid.device)
    s = torch.clamp((ar + 0.5) * (n / planes) - 0.5, 0.0, n - 1.0)
    lo_f = torch.floor(s)
    lo = lo_f.long()
    hi = torch.clamp(lo + 1, max=n - 1)
    w = (s - lo_f).reshape((planes,) + (1,) * (grid.ndim - 1))
    return torch.index_select(grid, 0, lo) * (1.0 - w) + torch.index_select(grid, 0, hi) * w


def resample_nearest(grid: torch.Tensor, planes: int) -> torch.Tensor:
    n = grid.shape[0]
    if planes == n:
        return grid
    s = (torch.arange(planes, dtype=F32, device=grid.device) + 0.5) * (n / planes) - 0.5
    return grid[torch.clamp(torch.floor(s + 0.5), 0, n - 1).long()]


def gradient_field(volume: torch.Tensor) -> torch.Tensor:
    """(3, D, H, W) central differences of the trilinear field at
    +-GRADIENT_OFFSET, clamp-to-edge, channels x, y, z."""
    d = volume.shape[0]
    off = GRADIENT_OFFSET * d
    lo, hi = int(math.floor(off)), int(math.floor(off)) + 1
    frac = off - math.floor(off)
    ar = torch.arange(d, device=volume.device)
    two_off = torch.tensor(2.0 * GRADIENT_OFFSET, dtype=F32, device=volume.device)

    def shift(axis, by):
        return torch.index_select(volume, axis, torch.clamp(ar + by, 0, d - 1))

    out = []
    for comp in (0, 1, 2):
        axis = 2 - comp
        plus = shift(axis, lo) * (1 - frac) + shift(axis, hi) * frac
        minus = shift(axis, -lo) * (1 - frac) + shift(axis, -hi) * frac
        out.append((plus - minus) / two_off)
    return torch.stack(out)


@dataclass
class Grids:
    major: int
    sign: int
    planes: int
    vol: torch.Tensor  # (N, rows, cols), the data dtype
    grad: torch.Tensor | None  # (3, N, rows, cols)
    levels: torch.Tensor | None  # (N, rows, cols) uint8


def grids(volume, importance, p: Params, view: np.ndarray, dtype=F32) -> Grids:
    """The frame's permuted, plane-resampled grids; differentiable in
    ``volume``."""
    major, sign = dominant_axis(view)
    planes = plane_count(p, volume.shape[0])
    order = AXIS_LAYOUT[major][0]
    vol = resample(volume.permute(order), planes).to(dtype)
    grad = None
    if p.use_shading:
        g = gradient_field(volume).permute((0,) + tuple(o + 1 for o in order))
        grad = resample(g.transpose(0, 1), planes).transpose(0, 1).to(dtype)
    levels = None
    if p.use_importance_rendering:
        with torch.no_grad():
            imp = resample_nearest(importance.permute(order), planes)
            levels = ((imp >= IMPORTANT_AHEAD).to(torch.uint8) + (imp >= IMPORTANT_OPAQUE).to(torch.uint8))
    return Grids(major, sign, planes, vol, grad, levels)


# ---- rays and the per-ray tables ----------------------------------------------------------------


def pixel_ndc(height: int, width: int, device) -> torch.Tensor:
    f32 = dict(dtype=F32, device=device)
    xs = torch.arange(width, **f32) / torch.tensor(float(width), **f32)
    ys = torch.arange(height, **f32) / torch.tensor(float(height), **f32)
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([u * 2.0 - 1.0, 1.0 - v * 2.0], dim=-1).reshape(-1, 2)


def rays(cam: dict, ndc: torch.Tensor):
    """(origin (3,), unit directions (R, 3), entry, exit) of the pinhole
    camera's rays through ``ndc``; ``cam`` holds float32 tensors."""
    ivp, origin = cam["inverse_view_proj"], cam["position"]
    world = ndc[:, 0:1] * ivp[:, 0][None, :] + ndc[:, 1:2] * ivp[:, 1][None, :] + ivp[:, 3][None, :]
    pos = world[:, :3] / world[:, 3:4]
    d = pos - origin[None, :]
    dirs = d / norm3(d)
    t1 = (0.0 - origin[None, :]) / dirs
    t2 = (1.0 - origin[None, :]) / dirs
    entry = torch.clamp(torch.amax(torch.minimum(t1, t2), dim=-1), min=0.0)
    exit_ = torch.clamp(torch.amin(torch.maximum(t1, t2), dim=-1), min=0.0)
    return origin, dirs, entry, exit_


def ray_affine(origin, dirs, planes: int, major: int, sign: int, n_plane: int):
    _, rc, cc = AXIS_LAYOUT[major]
    o_m, d_m = origin[major], dirs[:, major]
    sz = (1.0 / planes) * sign
    z0 = (0.5 / planes) if sign > 0 else ((planes - 0.5) / planes)
    safe = torch.where(torch.abs(d_m) > 1e-12, d_m, torch.full_like(d_m, 1e-12))
    ts = torch.full_like(d_m, sz) / safe
    tb = (z0 - o_m) / safe
    rs = ts * dirs[:, rc] * n_plane
    rb = (origin[rc] + tb * dirs[:, rc]) * n_plane - 0.5
    cs = ts * dirs[:, cc] * n_plane
    cb = (origin[cc] + tb * dirs[:, cc]) * n_plane - 0.5
    return rs, rb, cs, cb, ts, tb


def ray_table(cam: dict, ndc: torch.Tensor, g: Grids, n_plane: int) -> torch.Tensor:
    """The (N_FEATURES, R) per-ray table."""
    origin, dirs, entry, exit_ = rays(cam, ndc)
    d_m = dirs[:, g.major]
    rs, rb, cs, cb, ts, tb = ray_affine(origin, dirs, g.planes, g.major, g.sign, n_plane)
    aexp = torch.full_like(d_m, 1.0 / g.planes) / torch.clamp(torch.abs(d_m), min=1e-12) * 100.0
    signok = ((d_m * g.sign) > 0.0).float()
    light = 1.0 / sqrt_rn(torch.tensor(3.0, dtype=F32, device=dirs.device))
    half = -dirs + light
    half = half / norm3(half)
    cd = fma_rn(dirs[:, 2], origin[2], fma_rn(dirs[:, 1], origin[1], dirs[:, 0] * origin[0]))
    c2 = (origin[0] * origin[0] + origin[1] * origin[1]) + origin[2] * origin[2]
    rows = [rs, rb, cs, cb, ts, tb, entry, exit_, aexp, signok, half[:, 0], half[:, 1], half[:, 2], cd,
            torch.full_like(cd, float(c2))]
    return torch.stack(rows)


def _cross(a, b):
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def cone_table(cam: dict, ndc: torch.Tensor, g: Grids, n_plane: int) -> torch.Tensor:
    """The (CONE_SAMPLES, CF_STRIDE, R) cone table: each of the 8 cone
    directions' affine rows and its rate, re-anchored at the camera."""
    origin, dirs, _, _ = rays(cam, ndc)
    up = torch.zeros_like(dirs)
    up[:, 1] = 1.0
    right = _cross(dirs, up)
    right = right / torch.clamp(norm3(right), min=1e-12)
    new_up = _cross(dirs, right)
    out = []
    for s in range(CONE_SAMPLES):
        angle = (s / CONE_SAMPLES) * 2.0 * 3.14159
        d = dirs + right * (math.cos(angle) * CONE_ANGLE) + new_up * (math.sin(angle) * CONE_ANGLE)
        d = d / norm3(d)
        coeffs = ray_affine(origin, d, g.planes, g.major, g.sign, n_plane)
        out.append(torch.stack([*coeffs, d[:, g.major] * g.planes * g.sign]))
    return torch.stack(out)


# ---- sampling ------------------------------------------------------------------------------------


def snap(c: torch.Tensor, bits: int) -> torch.Tensor:
    if not bits:
        return c
    s = float(1 << bits)
    return torch.floor(c * s + 0.5) * (1.0 / s)


@dataclass
class Steps:
    """Every march step j of a block of rays at once, (N, R) each: the
    physical plane's offset in the flattened grid, t and the snapped
    texel coordinates."""

    base: torch.Tensor  # (N, 1) int64: k(j) * rows * cols
    t: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor


def steps(f, n: int, nr: int, nc: int, sign: int, bits: int) -> Steps:
    """Step j samples plane k = j (sign +) or n-1-j (sign -) at the affine
    coordinates of its index, clamped to the texel range and snapped."""
    jf = torch.arange(n, dtype=F32, device=f.device)[:, None]
    k = torch.arange(n, device=f.device)[:, None]
    k = k if sign > 0 else n - 1 - k
    rows = snap(torch.clamp(f[F_RS] * jf + f[F_RB], 0.0, nr - 1.0), bits)
    cols = snap(torch.clamp(f[F_CS] * jf + f[F_CB], 0.0, nc - 1.0), bits)
    return Steps(k * (nr * nc), f[F_TS] * jf + f[F_TB], rows, cols)


def nearest_index(rows, cols, nr: int, nc: int) -> torch.Tensor:
    r = torch.clamp(torch.floor(rows + 0.5), 0, nr - 1).long()
    c = torch.clamp(torch.floor(cols + 0.5), 0, nc - 1).long()
    return r * nc + c


def gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat[idx]`` whose backward adds by ``index_add_`` (atomics), not by
    the sorted scatter of advanced indexing, which runs the duplicates of
    one index one after another."""
    return torch.index_select(flat, 0, idx.reshape(-1)).reshape(idx.shape + flat.shape[1:])


def sample(flat: torch.Tensor, st: Steps, nr: int, nc: int, trilinear: bool) -> torch.Tensor:
    """(N, R) samples of a flattened (N * nr * nc) grid at every step,
    nearest or bilinear in the step's plane, clamp-to-edge: one gather of
    the grid (one scatter in its backward)."""
    if not trilinear:
        return gather(flat, st.base + nearest_index(st.rows, st.cols, nr, nc))
    r0f, c0f = torch.floor(st.rows), torch.floor(st.cols)
    tr, tc = st.rows - r0f, st.cols - c0f
    r0 = torch.clamp(r0f, 0, nr - 1).long() * nc + st.base
    r1 = torch.clamp(r0f + 1, 0, nr - 1).long() * nc + st.base
    c0 = torch.clamp(c0f, 0, nc - 1).long()
    c1 = torch.clamp(c0f + 1, 0, nc - 1).long()
    v00, v01, v10, v11 = gather(flat, r0 + c0), gather(flat, r0 + c1), gather(flat, r1 + c0), gather(flat, r1 + c1)
    return v00 * (1 - tr) * (1 - tc) + v01 * (1 - tr) * tc + v10 * tr * (1 - tc) + v11 * tr * tc


def _shifted(rows: torch.Tensor, o: int) -> torch.Tensor:
    """Row j of the result is row clamp(j + o) to [0, N-1] of ``rows``."""
    n = rows.shape[0]
    if o < 0:
        return torch.cat([rows[:1].expand(-o, -1), rows[:n + o]])
    if o > 0:
        return torch.cat([rows[o:], rows[-1:].expand(o, -1)])
    return rows


def smoothed(f, plain: torch.Tensor, nr: int, nc: int, p: Params) -> torch.Tensor:
    """(N, R) Gaussian-smoothed density of every march step from the plain
    rows ``plain`` (N, R): 5 taps at t-offsets i * 0.005, each a hat
    (trilinear) or box (nearest) combination of the plain rows of steps
    j-3..j+3 (clamped to the sweep), counted where the tap lies in the box,
    normalised by the weights that count."""
    n = plain.shape[0]
    dtype = plain.dtype
    rows = [_shifted(plain, o) for o in range(-SMOOTH_HALO, SMOOTH_HALO + 1)]
    jf = torch.arange(n, dtype=F32, device=f.device)[:, None]
    ts = torch.where(f[F_TS] == 0.0, 1.0, f[F_TS])
    rows_raw = f[F_RS] * jf + f[F_RB]
    cols_raw = f[F_CS] * jf + f[F_CB]
    total = torch.zeros_like(rows_raw, dtype=dtype)
    wsum = torch.zeros_like(rows_raw)
    for delta, w in GAUSS_TAPS:
        u = torch.full_like(ts, delta) / ts
        rt = rows_raw + u * f[F_RS]
        ct = cols_raw + u * f[F_CS]
        st = jf + u
        in_box = (rt >= -0.5) & (rt <= nr - 0.5) & (ct >= -0.5) & (ct <= nc - 0.5) & (st >= -0.5) & (st <= n - 0.5)
        del rt, ct, st
        tap = torch.zeros_like(total)
        for off in range(-SMOOTH_HALO, SMOOTH_HALO + 1):
            d = u - off
            ker = torch.clamp(1.0 - torch.abs(d), min=0.0) if p.trilinear else ((d >= -0.5) & (d < 0.5)).float()
            tap = (tap + ker * rows[off + SMOOTH_HALO]).to(dtype)
        wb = torch.where(in_box, w, 0.0)
        total = (total + wb * tap).to(dtype)
        wsum = wsum + wb
    return (total / torch.where(wsum > 0.0, wsum, 1.0)).to(dtype)


def lookahead_gate(f, cone, levels: torch.Tensor, sign: int, bits: int) -> tuple[torch.Tensor, dict]:
    """The (N, R) bool look-ahead gate and its work counts: a reverse march
    carries the march index of the next important crossing ahead (along the
    ray, or per cone direction re-anchored at the camera); step j is gated
    when it is in the window, an important crossing lies within the probe
    range ``exit - |pos|`` ahead, and the ray's own sample is not opaque."""
    n, nr, nc = levels.shape
    lv = levels.reshape(-1)
    important_slice = (levels.reshape(n, -1) >= 1).any(dim=1).tolist()
    st = steps(f, n, nr, nc, sign, bits)
    sign_ok = f[F_SIGNOK] > 0.5
    entry, exit_, ts, c2, cd = f[F_ENTRY], f[F_EXIT], f[F_TS], f[F_C2], f[F_CD]
    valid_all = sign_ok & (st.t >= entry) & (st.t < exit_)
    level_all = lv[st.base + nearest_index(st.rows, st.cols, nr, nc)]
    r = f.shape[1]
    ns = torch.full((CONE_SAMPLES if cone is not None else 1, r), FAR, dtype=F32, device=f.device)
    gate = torch.zeros((n, r), dtype=torch.bool, device=f.device)
    for j in reversed(range(n)):
        k = j if sign > 0 else n - 1 - j
        t, valid, level = st.t[j], valid_all[j], level_all[j]
        jf = torch.tensor(float(j), dtype=F32, device=f.device)
        norm_pos = sqrt_rn(torch.clamp(c2 + 2.0 * t * cd + t * t, min=0.0))
        if cone is not None:
            rate = cone[:, CF_RATE]
            ahead = ((ns <= jf + (exit_ - norm_pos) * rate) & (rate > 0.0)).any(0) & valid
            if important_slice[k]:
                rows_u = cone[:, CF_RS] * jf + cone[:, CF_RB]
                cols_u = cone[:, CF_CS] * jf + cone[:, CF_CB]
                t_c = cone[:, CF_TS] * jf + cone[:, CF_TB]
                inbox = ((rows_u >= -0.5) & (rows_u <= nr - 0.5) & (cols_u >= -0.5) & (cols_u <= nc - 0.5)
                         & (t_c > 0.0))
                rs_ = snap(torch.clamp(rows_u, 0.0, nr - 1.0), bits)
                cs_ = snap(torch.clamp(cols_u, 0.0, nc - 1.0), bits)
                hit = (lv[k * nr * nc + nearest_index(rs_, cs_, nr, nc)] >= 1) & inbox
                ns = torch.where(hit, jf, ns)
        else:
            ahead = (ns[0] <= jf + (exit_ - norm_pos) / ts) & valid
            ns = torch.where(((level >= 1) & valid)[None], jf, ns)
        gate[j] = ahead & (level < 2)
    probed = sum(int(important_slice[j if sign > 0 else n - 1 - j]) * valid_all[j].sum() for j in range(n))
    return gate, {"valid_steps": valid_all.sum(), "probed_steps": probed}


# ---- the march ----------------------------------------------------------------------------------


def _with_slope(value: torch.Tensor, x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """``value`` in the forward, with d value / d x = ``slope`` for autograd:
    the spec's derivative where it differs from the autograd of the forward
    expression (``x - x.detach()`` is exactly 0, so the value's bits stand)."""
    if not x.requires_grad:
        return value
    return value + (x - x.detach()) * slope.detach()


def march(f, g: Grids, lut: torch.Tensor, p: Params, gate: torch.Tensor | None = None):
    """Front-to-back slab march of the rays of the table ``f`` (N_FEATURES,
    R) -> ((R, 4) image in float32, counts): ``live_steps`` (in the window,
    not terminated, not gated) and ``composited_steps`` (live and at or over
    the threshold)."""
    dtype = g.vol.dtype
    n, nr, nc = g.vol.shape
    ln = lut.shape[0]
    lut = lut.to(dtype)
    threshold = float(np.float32(p.density_threshold))
    early_alpha = float(np.float32(p.early_termination_alpha))
    with torch.no_grad():
        st = steps(f, n, nr, nc, g.sign, p.subtexel_bits)
        sign_ok = f[F_SIGNOK] > 0.5
        entry, exit_ = f[F_ENTRY], f[F_EXIT]
        in_window = (sign_ok & (st.t >= entry) & (st.t < exit_)).unbind(0)
    plain = sample(g.vol.reshape(-1), st, nr, nc, p.trilinear)
    dens = smoothed(f, plain, nr, nc, p) if p.use_gaussian_smoothing else plain
    del plain
    dens = dens.unbind(0)
    if p.use_shading:
        gflat = g.grad.reshape(3, -1)
        gsamp = [sample(gflat[ch], st, nr, nc, p.trilinear).unbind(0) for ch in range(3)]
    del st
    r = f.shape[1]
    aexp = f[F_AEXP].to(dtype)
    half = f[F_HX:F_HZ + 1].t().to(dtype)
    acc_c = torch.zeros((r, 3), dtype=dtype, device=f.device)
    acc_a = torch.zeros((r,), dtype=dtype, device=f.device)
    live_steps = torch.zeros((), dtype=torch.int64, device=f.device)
    comp_steps = torch.zeros((), dtype=torch.int64, device=f.device)
    for j in range(n):
        density = dens[j]
        live = in_window[j] & (acc_a < early_alpha)
        if gate is not None:
            live = live & ~gate[j]
        m = live & (density >= threshold)
        live_steps += live.sum()
        comp_steps += m.sum()
        # the TF lookup: linear, clamp-to-edge, texel centres at (i + 0.5) / LN
        c_raw = density.detach().float() * float(ln) - 0.5
        c = torch.clamp(c_raw, 0.0, ln - 1.0)
        i0f = torch.floor(c)
        fr = (c - i0f)[:, None].to(dtype)
        i0 = i0f.long()
        i1 = torch.clamp(i0 + 1, max=ln - 1)
        lut0, lut1 = gather(lut, i0), gather(lut, i1)
        rgba = (lut0 * (1.0 - fr) + lut1 * fr).to(dtype)
        if density.requires_grad:
            inside = ((fr[:, 0] > 0.0) & (c_raw > 0.0) & (c_raw < ln - 1.0))[:, None]
            rgba = _with_slope(rgba, density[:, None], torch.where(inside, (lut1 - lut0) * float(ln), 0.0))
        rgb = rgba[:, :3]
        if p.use_shading:
            gs = torch.stack([gsamp[0][j], gsamp[1][j], gsamp[2][j]], dim=-1)
            sq = gs[:, 0:1] * gs[:, 0:1] + gs[:, 1:2] * gs[:, 1:2] + gs[:, 2:3] * gs[:, 2:3]
            nonzero = sq > 0.0
            nrm = torch.where(nonzero, gs / sqrt_rn(torch.where(nonzero, sq, 1.0).float()).to(dtype), 0.0)
            s_diff = (nrm[:, 0:1] + nrm[:, 1:2] + nrm[:, 2:3]) * INV_SQRT3
            hdotn = half[:, 0:1] * nrm[:, 0:1] + half[:, 1:2] * nrm[:, 1:2] + half[:, 2:3] * nrm[:, 2:3]
            # max(0, x) as ``where(x > 0, x, 0)``: its derivative at the kink
            # x = 0 is 0, as the spec's VJP takes it (clamp's would be 1)
            spec = torch.where(hdotn > 0.0, hdotn, 0.0) ** SHININESS
            shade = AMBIENT + DIFFUSE * torch.where(s_diff > 0.0, s_diff, 0.0)
            rgb = torch.where(nonzero, rgb * shade + SPECULAR * spec, rgb).to(dtype)
        a = rgba[:, 3]
        log1ma = torch.log(torch.clamp(1.0 - a.detach(), min=1e-37))
        alpha = (1.0 - torch.exp(aexp * log1ma)).to(dtype)
        alpha = _with_slope(alpha, a, aexp * torch.exp((aexp - 1.0) * log1ma))
        w = ((1.0 - acc_a) * alpha * m.to(dtype)).to(dtype)
        acc_c = (acc_c + rgb * w[:, None]).to(dtype)
        acc_a = (acc_a + w).to(dtype)
    img = torch.cat([acc_c, acc_a[:, None]], dim=-1).float()
    img = torch.where((exit_ <= entry)[:, None], torch.tensor(MISS_COLOR, dtype=F32, device=f.device), img)
    return img, {"live_steps": live_steps, "composited_steps": comp_steps}


# ---- frames and training steps ------------------------------------------------------------------


def cam_tensors(cam: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in cam.items()}


def _blocks(height: int, width: int, rows_per_block: int):
    for y0 in range(0, height, rows_per_block):
        y1 = min(height, y0 + rows_per_block)
        yield y0 * width, y1 * width


def render(volume, importance, lut, cam: dict, p: Params, height: int, width: int, dtype=F32,
           rows_per_block: int = 384) -> tuple[torch.Tensor, dict]:
    """A frame -> ((H, W, 4) float32, work counts summed over its rays), in
    blocks of image rows so that the march's per-step state fits."""
    with torch.no_grad():
        device = volume.device
        g = grids(volume.to(F32), importance, p, cam["view"], dtype)
        camt = cam_tensors(cam, device)
        ndc = pixel_ndc(height, width, device)
        out = torch.empty((height * width, 4), dtype=F32, device=device)
        counts: dict[str, int] = {}
        for a, b in _blocks(height, width, rows_per_block):
            f = ray_table(camt, ndc[a:b], g, g.vol.shape[1])
            gate = None
            if p.use_importance_rendering:
                cone = cone_table(camt, ndc[a:b], g, g.vol.shape[1]) if p.use_cone_importance_check else None
                gate, gc = lookahead_gate(f, cone, g.levels, g.sign, p.subtexel_bits)
                _add(counts, gc)
            out[a:b], mc = march(f, g, lut, p, gate)
            _add(counts, mc)
        return out.reshape(height, width, 4), {k: int(v) for k, v in counts.items()}


def _add(counts: dict, more: dict) -> None:
    for k, v in more.items():
        counts[k] = counts.get(k, 0) + v


def loss_and_grads(volume, importance, lut, cam: dict, target, p: Params, height: int, width: int, dtype=F32,
                   rows_per_block: int = 256):
    """The L2 loss ``mean((img - target)**2)`` of a frame and its gradients
    (d_volume, d_lut), by autograd through :func:`march` in blocks of image
    rows: each block's gradient reaches the frame's grids, and the grids'
    gradient goes back through the resample, the permute and the gradient
    field once.  -> (loss as a float, d_volume, d_lut, the image, counts)."""
    device = volume.device
    vol_leaf = volume.detach().to(dtype).requires_grad_()
    lut_leaf = lut.detach().to(dtype).requires_grad_()
    g_full = grids(vol_leaf, importance, p, cam["view"], dtype)
    g = Grids(g_full.major, g_full.sign, g_full.planes, g_full.vol.detach().requires_grad_(),
              None if g_full.grad is None else g_full.grad.detach().requires_grad_(), g_full.levels)
    camt = cam_tensors(cam, device)
    ndc = pixel_ndc(height, width, device)
    tgt = target.reshape(-1, 4)
    denom = float(height * width * 4)
    img = torch.empty((height * width, 4), dtype=F32, device=device)
    loss = 0.0
    counts: dict[str, int] = {}
    for a, b in _blocks(height, width, rows_per_block):
        with torch.no_grad():
            f = ray_table(camt, ndc[a:b], g, g.vol.shape[1])
            gate = None
            if p.use_importance_rendering:
                cone = cone_table(camt, ndc[a:b], g, g.vol.shape[1]) if p.use_cone_importance_check else None
                gate, _ = lookahead_gate(f, cone, g.levels, g.sign, p.subtexel_bits)
        out, mc = march(f, g, lut_leaf, p, gate)
        part = ((out - tgt[a:b]) ** 2).sum() / denom
        part.backward()
        loss += float(part.detach())
        img[a:b] = out.detach()
        _add(counts, mc)
    roots = [g_full.vol] + ([g_full.grad] if g_full.grad is not None else [])
    grads = [g.vol.grad] + ([g.grad.grad] if g.grad is not None else [])
    torch.autograd.backward(roots, grads)
    return (loss, vol_leaf.grad.float(), lut_leaf.grad.float(), img.reshape(height, width, 4),
            {k: int(v) for k, v in counts.items()})


class Adam:
    """Adam as the fit states it (b1 0.9, b2 0.999, eps 1e-8 after the root,
    bias-corrected), then the projection onto [0, 1]."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 state: dict[str, tuple[torch.Tensor, torch.Tensor]] | None = None, t: int = 0):
        """``state`` (each leaf's first and second moments) and ``t`` (the
        steps taken): where a job already stands; none: a fresh one."""
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.state: dict[str, tuple[torch.Tensor, torch.Tensor]] = dict(state or {})
        self.t = t

    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        self.t += 1
        out = {}
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            m, v = self.state.get(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m = self.b1 * m + (1.0 - self.b1) * g
            v = self.b2 * v + (1.0 - self.b2) * g * g
            self.state[name] = (m, v)
            mhat = m / (1.0 - self.b1 ** self.t)
            vhat = v / (1.0 - self.b2 ** self.t)
            out[name] = torch.clamp(p - self.lr * mhat / (torch.sqrt(vhat) + self.eps), 0.0, 1.0)
        return out
