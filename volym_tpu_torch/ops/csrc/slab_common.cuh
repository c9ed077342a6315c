// Device helpers shared by the slab march (slab_march.cu), its replay
// backward (slab_replay.cu), the voxel-gradient scatters with the plain
// rows' camera chain (voxel_grad.cu) and the look-ahead gate
// (lookahead.cu): the per-ray and cone tables' rows, the subtexel snap, the
// nearest tap, the clamp-to-edge slice sample, its transpose and its
// coordinate derivative, the TF texel lookup, the bound of a sample by its
// largest texel and the Gaussian smoothing stencil with its tap-offset
// derivative.  The kernels must evaluate these
// expressions identically, bit for bit (build with --fmad=false), so that
// the replay reproduces the forward's masks and the gate the march's
// samples.  A sample reads its texels through an accessor: a slice in
// global memory (GlobalTexels, what every kernel but the march reads) or a
// window of one staged in shared memory (StagedTexels, the march's stage);
// the taps and their arithmetic are the same either way.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace volym_slab {

// rows of the per-ray table (volym_tpu_torch/render/slab.py F_*, N_FEATURES)
constexpr int F_RS = 0, F_RB = 1, F_CS = 2, F_CB = 3, F_TS = 4, F_TB = 5;
constexpr int F_ENTRY = 6, F_EXIT = 7, F_AEXP = 8, F_SIGNOK = 9;
constexpr int F_HX = 10, F_HY = 11, F_HZ = 12;
constexpr int F_CD = 13, F_C2 = 14;
constexpr int N_FEATURES = 15;

// rows of the cone table, per cone direction (slab.py CF_*, CONE_SAMPLES)
constexpr int CF_RS = 0, CF_RB = 1, CF_CS = 2, CF_CB = 3, CF_TS = 4, CF_TB = 5, CF_RATE = 6;
constexpr int CF_STRIDE = 7;
constexpr int CONE_SAMPLES = 8;

// one thread per ray over 16x16 pixel tiles
constexpr int TILE_X = 16, TILE_Y = 16;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return min(max(x, lo), hi);
}

__device__ __forceinline__ float snap(float c, int bits) {
    if (bits == 0) return c;
    const float s = (float)(1 << bits);
    return floorf(c * s + 0.5f) * (1.0f / s);
}

// the texel index of a nearest sample: floor(c + 0.5) on each axis,
// clamp-to-edge.  This is the TPU's box hat, which takes index i where
// c - i lies in [-0.5, 0.5), at every coordinate but one: with subtexel_bits
// 0, c = 0.5 - 2^-25 rounds c + 0.5 up to 1.0 and picks 1 where the hat
// picks 0.  Snapped coordinates (subtexel_bits > 0) are exact.
__device__ __forceinline__ int nearest_index(float rows, float cols, int nr, int nc) {
    const int r = clampi((int)floorf(rows + 0.5f), 0, nr - 1);
    const int c = clampi((int)floorf(cols + 0.5f), 0, nc - 1);
    return r * nc + c;
}

template <typename T>
__device__ __forceinline__ float texel(const T* __restrict__ sl, int idx) {
    return (float)__ldg(sl + idx);
}

// texel (r, c) of one (nr, nc) slice in global memory
template <typename T>
struct GlobalTexels {
    const T* __restrict__ sl;
    int nc;
    __device__ __forceinline__ float operator()(int r, int c) const { return texel(sl, r * nc + c); }
};

// texel (r, c) of a slice whose window of rows r0.. and columns c0.. is
// staged in shared memory, `pitch` elements a row; (r, c) must lie inside
template <typename T>
struct StagedTexels {
    const T* base;
    int r0, c0, pitch;
    __device__ __forceinline__ float operator()(int r, int c) const {
        return (float)base[(r - r0) * pitch + (c - c0)];
    }
};

// the texel rows (or columns) a sample at the snapped coordinate `rows`
// reads, [lo, hi]: the bilinear taps r0 and r1 of sample_at, or its
// nearest tap, by the same expressions.  Non-decreasing in `rows`.
template <bool BILINEAR>
__device__ __forceinline__ int2 tap_span(float rows, int nr) {
    if (BILINEAR) {
        const float r0f = floorf(rows);
        return make_int2(clampi((int)r0f, 0, nr - 1), clampi((int)r0f + 1, 0, nr - 1));
    }
    const int r = clampi((int)floorf(rows + 0.5f), 0, nr - 1);
    return make_int2(r, r);
}

// one sample of an (nr, nc) slice at snapped texel coordinates, clamp-to-edge,
// its texels read through `tx`
template <bool BILINEAR, typename Texels>
__device__ __forceinline__ float sample_at(const Texels& tx, float rows, float cols, int nr, int nc) {
    if (BILINEAR) {
        const float r0f = floorf(rows), c0f = floorf(cols);
        const float tr = rows - r0f, tc = cols - c0f;
        const int r0 = clampi((int)r0f, 0, nr - 1), r1 = clampi((int)r0f + 1, 0, nr - 1);
        const int c0 = clampi((int)c0f, 0, nc - 1), c1 = clampi((int)c0f + 1, 0, nc - 1);
        const float v00 = tx(r0, c0), v01 = tx(r0, c1);
        const float v10 = tx(r1, c0), v11 = tx(r1, c1);
        const float ur = 1.0f - tr, uc = 1.0f - tc;
        return v00 * ur * uc + v01 * ur * tc + v10 * tr * uc + v11 * tr * tc;
    } else {
        const int r = clampi((int)floorf(rows + 0.5f), 0, nr - 1);
        const int c = clampi((int)floorf(cols + 0.5f), 0, nc - 1);
        return tx(r, c);
    }
}

// one sample of an (nr, nc) slice in global memory
template <bool BILINEAR, typename T>
__device__ __forceinline__ float sample(const T* __restrict__ sl, float rows, float cols, int nr, int nc) {
    return sample_at<BILINEAR>(GlobalTexels<T>{sl, nc}, rows, cols, nr, nc);
}

// transpose of sample<>: add v times the sample's bilinear (4 taps) or box
// (1 tap) weights into the slice, with global atomics
template <bool BILINEAR>
__device__ __forceinline__ void scatter(float* __restrict__ sl, float rows, float cols, int nr, int nc, float v) {
    if (BILINEAR) {
        const float r0f = floorf(rows), c0f = floorf(cols);
        const float tr = rows - r0f, tc = cols - c0f;
        const int r0 = clampi((int)r0f, 0, nr - 1), r1 = clampi((int)r0f + 1, 0, nr - 1);
        const int c0 = clampi((int)c0f, 0, nc - 1), c1 = clampi((int)c0f + 1, 0, nc - 1);
        const float ur = 1.0f - tr, uc = 1.0f - tc;
        atomicAdd(sl + r0 * nc + c0, v * ur * uc);
        atomicAdd(sl + r0 * nc + c1, v * ur * tc);
        atomicAdd(sl + r1 * nc + c0, v * tr * uc);
        atomicAdd(sl + r1 * nc + c1, v * tr * tc);
    } else {
        atomicAdd(sl + nearest_index(rows, cols, nr, nc), v);
    }
}

// d sample / d (rows, cols) of a bilinear sample of an f32 slice at snapped
// texel coordinates (volym_tpu_torch/render/slab.py _dsample): the hats'
// derivative contracted with the other axis' hats, as the TPU's _dhat
// (slab_bwd_kernel.py:94-115, 826-842).  Half-open: at a coordinate on
// texel i the derivative is v[i+1] - v[i].  Texel nr (nc) is absent from
// the TPU's hats and counts as 0, not as a clamped copy of texel nr - 1, so
// a coordinate snapped onto nr - 1 has derivative -v[nr-1].  The snapped
// coordinates lie in [0, nr-1] x [0, nc-1]; the caller masks the chain
// where the raw coordinate is clipped.
__device__ __forceinline__ float2 dsample(const float* __restrict__ sl, float rows, float cols, int nr, int nc) {
    const float r0f = floorf(rows), c0f = floorf(cols);
    const float tr = rows - r0f, tc = cols - c0f;
    const int r0 = (int)r0f, c0 = (int)c0f;
    const bool r1_in = r0 + 1 < nr, c1_in = c0 + 1 < nc;
    const float v00 = texel(sl, r0 * nc + c0);
    const float v01 = c1_in ? texel(sl, r0 * nc + c0 + 1) : 0.0f;
    const float v10 = r1_in ? texel(sl, (r0 + 1) * nc + c0) : 0.0f;
    const float v11 = (r1_in && c1_in) ? texel(sl, (r0 + 1) * nc + c0 + 1) : 0.0f;
    const float ur = 1.0f - tr, uc = 1.0f - tc;
    return make_float2((v10 - v00) * uc + (v11 - v01) * tc, (v01 * ur + v11 * tr) - (v00 * ur + v10 * tr));
}

// the two LUT texels and weights of a linear TF lookup: texel centres at
// (i + 0.5) / ln, clamp-to-edge
struct TfTexels {
    int i0, i1;
    float fr, ufr;
};

__device__ __forceinline__ TfTexels tf_texels(float density, float tf_scale, float lmax, int ln) {
    const float c = clampf(density * tf_scale - 0.5f, 0.0f, lmax);
    const float i0f = floorf(c);
    TfTexels t;
    t.fr = c - i0f;
    t.ufr = 1.0f - t.fr;
    t.i0 = (int)i0f;
    t.i1 = min(t.i0 + 1, ln - 1);
    return t;
}

// the largest value any sample over texels of at most m can take, with the
// rounding of its sums: a convex combination with weights that sum to one
// (a bilinear or box sample, or the smoothing stencil over plain rows, below).
// A sample whose texels (rows) all lie below the threshold by this bound is
// below it too: the march (slab_march.cu) and its replay (slab_replay.cu)
// skip it exactly.
__device__ __forceinline__ float sample_bound(float m) { return fmaxf(m, 0.0f) * (1.0f + 0x1p-16f); }

// ---------------------------------------------------------------------------
// Gaussian smoothing (volym_tpu_torch/render/slab.py smooth_row; the TPU
// kernel's _smooth_row, slab_kernel.py:879-934).  The reference smooths
// along the ray with 5 taps at t-offsets i * 0.005, i in [-2, 2].  A tap
// lies u = delta / ts march steps from step j, a per-ray constant, so it is
// a hat (bilinear) or box (nearest) combination of the plain density rows
// j-3 .. j+3: a 7-row stencil along the slab axis.

// slab-axis half-width of the stencil (slab.py SMOOTH_HALO)
constexpr int SMOOTH_HALO = 3;
constexpr int SMOOTH_ROWS = 2 * SMOOTH_HALO + 1;
constexpr int GAUSS_TAPS = 5;

// the taps' t-offsets and weights as float32, the values of slab.py
// GAUSS_TAPS (float32(i * 0.005), float32(exp(-d^2 / (2 * 1.5^2))))
__device__ __forceinline__ float gauss_delta(int i) {
    return i == 0 ? -0x1.47ae14p-7f : i == 1 ? -0x1.47ae14p-8f : i == 2 ? 0.0f : i == 3 ? 0x1.47ae14p-8f : 0x1.47ae14p-7f;
}

__device__ __forceinline__ float gauss_weight(int i) {
    return (i == 0 || i == 4) ? 0x1.fffd16p-1f : (i == 1 || i == 3) ? 0x1.ffff46p-1f : 1.0f;
}

// the plain density row of march step j: the sample at the step's own
// snapped coordinates, whatever the ray's t-window (the march's own
// expressions for rows, cols and the physical plane k)
template <bool BILINEAR, typename T>
__device__ __forceinline__ float plain_row(const T* __restrict__ vol, int j, float rs, float rb, float cs, float cb,
                                           int n, int nr, int nc, int sign, int subtexel) {
    const float jf = (float)j;
    const float rows = snap(clampf(rs * jf + rb, 0.0f, (float)(nr - 1)), subtexel);
    const float cols = snap(clampf(cs * jf + cb, 0.0f, (float)(nc - 1)), subtexel);
    const size_t k = (size_t)(sign > 0 ? j : n - 1 - j);
    return sample<BILINEAR>(vol + k * ((size_t)nr * nc), rows, cols, nr, nc);
}

// The sliding window of plain rows d[o + 3] = row clamp(j + o) to [0, n-1],
// o in [-3, 3], for march step j.  Call advance() at every step j from the
// first one the ray reaches on, in order: the first call samples the 7
// rows (prime), every later one shifts and samples row j + 3 (push; beyond
// the sweep the end row, already held).  A caller that samples row j + 3
// itself calls prime() and push() with that sample instead.
template <bool BILINEAR, typename T>
struct SmoothWindow {
    float d[SMOOTH_ROWS];
    bool primed;

    __device__ __forceinline__ SmoothWindow() : primed(false) {}

    __device__ __forceinline__ void prime(const T* __restrict__ vol, int j, float rs, float rb, float cs, float cb,
                                          int n, int nr, int nc, int sign, int subtexel) {
#pragma unroll
        for (int o = 0; o < SMOOTH_ROWS; ++o) {
            d[o] = plain_row<BILINEAR>(vol, clampi(j + o - SMOOTH_HALO, 0, n - 1), rs, rb, cs, cb, n, nr, nc, sign,
                                       subtexel);
        }
        primed = true;
    }

    // shift, taking `row` (plain row j + 3) where j + 3 lies in the sweep
    __device__ __forceinline__ void push(int j, int n, float row) {
#pragma unroll
        for (int o = 0; o < SMOOTH_ROWS - 1; ++o) d[o] = d[o + 1];
        if (j + SMOOTH_HALO <= n - 1) d[SMOOTH_ROWS - 1] = row;
    }

    __device__ __forceinline__ void advance(const T* __restrict__ vol, int j, float rs, float rb, float cs, float cb,
                                            int n, int nr, int nc, int sign, int subtexel) {
        if (!primed) {
            prime(vol, j, rs, rb, cs, cb, n, nr, nc, sign, subtexel);
        } else if (j + SMOOTH_HALO <= n - 1) {
            push(j, n, plain_row<BILINEAR>(vol, j + SMOOTH_HALO, rs, rb, cs, cb, n, nr, nc, sign, subtexel));
        } else {
            push(j, n, 0.0f);
        }
    }
};

// The smoothed density of march step j from the window's rows d: each tap
// counts where it lies in the box (rows and columns bounded by the texel
// counts nr/nc, the slab axis by the plane count n), and the sum is
// normalised by the weights that count.  Operation order as in
// slab.py::smooth_row; ts == 0 is guarded as in the TPU kernel.
template <bool BILINEAR>
__device__ __forceinline__ float smooth_density(const float (&d)[SMOOTH_ROWS], int j, float rs, float rb, float cs,
                                                float cb, float ts_raw, int n, int nr, int nc) {
    const float ts = ts_raw == 0.0f ? 1.0f : ts_raw;
    const float jf = (float)j;
    const float rows_raw = rs * jf + rb;
    const float cols_raw = cs * jf + cb;
    const float bnd_r = (float)nr - 0.5f, bnd_c = (float)nc - 0.5f, bnd_s = (float)n - 0.5f;
    float total = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int i = 0; i < GAUSS_TAPS; ++i) {
        const float u = gauss_delta(i) / ts;
        const float rt = rows_raw + u * rs;
        const float ct = cols_raw + u * cs;
        const float st = jf + u;
        const bool in_box = rt >= -0.5f && rt <= bnd_r && ct >= -0.5f && ct <= bnd_c && st >= -0.5f && st <= bnd_s;
        float tap = 0.0f;
#pragma unroll
        for (int o = 0; o < SMOOTH_ROWS; ++o) {
            const float dl = u - (float)(o - SMOOTH_HALO);
            const float ker = BILINEAR ? fmaxf(0.0f, 1.0f - fabsf(dl)) : ((dl >= -0.5f && dl < 0.5f) ? 1.0f : 0.0f);
            tap = tap + ker * d[o];
        }
        const float wb = in_box ? gauss_weight(i) : 0.0f;
        total = total + wb * tap;
        wsum = wsum + wb;
    }
    return total / (wsum > 0.0f ? wsum : 1.0f);
}

// d(smoothed density)/d(F_TS) of march step j (slab.py smooth_row_dts; the
// TPU's _smooth_row_dts, slab_bwd_kernel.py:118-166): the in-box masks and
// wsum are indicators, so only the hats ker(u - off) chain, with
// du/dts = -delta / ts^2 (the raw ts), normalised by wsum.  Bilinear only:
// box hats have no derivative.
__device__ __forceinline__ float smooth_density_dts(const float (&d)[SMOOTH_ROWS], int j, float rs, float rb,
                                                    float cs, float cb, float ts_raw, int n, int nr, int nc) {
    const float ts = ts_raw == 0.0f ? 1.0f : ts_raw;
    const float jf = (float)j;
    const float rows_raw = rs * jf + rb;
    const float cols_raw = cs * jf + cb;
    const float bnd_r = (float)nr - 0.5f, bnd_c = (float)nc - 0.5f, bnd_s = (float)n - 0.5f;
    const float ts2 = ts_raw * ts_raw;
    float total = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int i = 0; i < GAUSS_TAPS; ++i) {
        const float u = gauss_delta(i) / ts;
        const float rt = rows_raw + u * rs;
        const float ct = cols_raw + u * cs;
        const float st = jf + u;
        const bool in_box = rt >= -0.5f && rt <= bnd_r && ct >= -0.5f && ct <= bnd_c && st >= -0.5f && st <= bnd_s;
        const float du_dts = -gauss_delta(i) / ts2;
        float dtap = 0.0f;
#pragma unroll
        for (int o = 0; o < SMOOTH_ROWS; ++o) {
            const float dl = u - (float)(o - SMOOTH_HALO);
            const float dker = fabsf(dl) < 1.0f ? (dl > 0.0f ? -1.0f : (dl < 0.0f ? 1.0f : 0.0f)) : 0.0f;
            dtap = dtap + dker * d[o];
        }
        const float wb = in_box ? gauss_weight(i) : 0.0f;
        total = total + wb * dtap * du_dts;
        wsum = wsum + wb;
    }
    return total / (wsum > 0.0f ? wsum : 1.0f);
}

}  // namespace volym_slab
