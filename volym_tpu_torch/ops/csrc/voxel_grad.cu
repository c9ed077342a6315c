// Voxel-gradient scatters for Hopper (sm_90a), with the smoothing stencil's
// transpose fused in (FOLD) and, under it, the plain rows' camera chain
// (CHAIN, B5).
//
// Replaces the TPU kernels volym_tpu/ops/slab_bwd_kernel.py::
// _voxel_grad_kernel (B3: d_vol from a 1-channel cotangent) and
// _voxel_grad_shaded_kernel (B4: d_vol and the 3-channel d_grad from a
// 4-channel one), the unfused backward's pass 2, which the training step
// runs under Gaussian smoothing after the replay (slab_replay.cu, SMOOTH).
// The TPU runs the stencil's transpose (_smooth_dd_transpose,
// slab_bwd_kernel.py:895-965) in jnp between the two, for Mosaic's block
// layout; here one thread owns a ray and folds it on the way (FOLD).  The
// plain PyTorch versions are volym_tpu_torch/render/slab.py::
// smooth_voxel_grad (FOLD) and voxel_grad (without FOLD).
//
// Both variants add a cotangent into the physical plane k(j) of its march
// step j with the hats of the step's own sample: the coordinates of
// _coords (rs*j+rb, cs*j+cb, clipped, snapped to 2^-subtexel), bilinear
// (4 taps) or box (1 tap) weights, the transpose of sample<> (scatter<> in
// slab_common.cuh, shared with the replay's fused scatter), with global
// float atomics.  The TPU builds (rows x rays) and (cols x rays) hat
// matrices per slab block and contracts them on the MXU.
//
// FOLD (the smoothed backward's path): one thread per ray (and chunk of
// rows, below).  Plain row k of a ray is
//     sum over off = -3..3, and the steps j with clamp(j + off) == k, of
//     coeff_off(j) / wsum(j) * dd[j],
// coeff_off(j) = sum over the 5 taps t of [tap t of step j in the box] *
// w_t * ker(u_t - off), wsum(j) = sum of [in the box] * w_t (guarded to 1),
// u_t = delta_t / ts.  Only the in-box bits and wsum depend on j; the
// thread keeps them, with dd[j], for the steps in flight in a register
// window.  Most steps have all 5 taps in the box, and their 7 quotients
// coeff_off / wsum are constants of the ray, formed once in the same
// order, so such a step's term is one product; a step near the box's
// faces sums its taps' w_t * ker(u_t - off) as the plain version does.  Sums run in smooth_dd_transpose's order (taps in order,
// offsets -3..3, true division), so with --fmad=false a row with one
// source an offset (1 <= k <= n-2) equals the plain transpose bit for bit;
// the end rows collect several clamped steps, which the plain index_add_
// sums in no fixed order on the card.  Row k is scattered once; the gradient-field
// channels 1..3 of a shaded dd are not folded (slab_bwd_kernel.py:
// 1684-1691) and scatter at their own step.  When asked (the tests only)
// the kernel also writes the folded rows.
//
// CHAIN (camera gradients with trilinear sampling): the plain rows' camera
// chain, which replaces the TPU kernel _feats_grad_kernel (B5, pass 2b,
// slab_bwd_kernel.py:968, driven by _run_feats_grad; the plain version is
// volym_tpu_torch/render/slab.py::feats_grad on the folded rows).  A
// smoothed step's density mixes the plain rows of later steps, so the
// chain of plain row k needs its folded cotangent, which this thread has
// just summed in a register at row k's snapped coordinates and plane: at
// each nonzero row it takes the coordinate derivative of row k's own
// sample (dsample in slab_common.cuh, 4 taps of the f32 slice), masks it
// where the raw coordinate is clipped, and adds d_rows * k, d_rows,
// d_cols * k and d_cols to four register sums in row order, the plain
// version's order.  At the end of its chunk the thread writes them to the
// rows F_RS/F_RB/F_CS/F_CB of d_feats: a plain store when the grid has one
// chunk (bit for bit with the plain version on the same folded rows), an
// atomicAdd of its partial sums otherwise (their order changes from run to
// run: held to the plain version by tolerance).  No (n, H, W) tensor of
// folded rows is written or read: the TPU's pass 2b walks all of one, of
// which a ray's nonzero rows lie in [first - 3, last + 3].
// Instantiated with BILINEAR only: box hats have no coordinate derivative
// (slab_bwd_kernel.py:1789).
//
// Bound: bytes.  dd is 805 MB at 1024x768 x 256 planes (1.6 GB with 4
// channels), but a ray composites a few steps, and the replay records the
// first and last step it writes a cotangent at (steps, 2 x H x W int32).
// The kernel reads dd only inside that range and walks rows [first - 3,
// last + 3]: what it must read is the in-range dd, the range table and 5
// rows of the per-ray table, and it writes d_vol (and d_grad, and the
// folded rows when asked) once; CHAIN adds the texels its taps read and 4
// rows of d_feats written once.  The 32 rays of a warp walk the union of
// their ranges step by step, so a warp's loads at one step stay within two
// 64-byte rows of dd and its atomics land on neighbouring voxels of one
// plane (each thread walking its own range measured slower).  A walk is a
// chain of dependent loads (row k needs step k + 3):
// a thread folds 4 rows a trip and loads their 4 new sources together, and
// where few rays would leave the card idle behind the longest walk, the
// wrapper cuts the rows into chunks of `chunk` (grid z), one thread per
// (ray, chunk), each loading the 3-step halo of its chunk.  Every row is
// still summed by one thread, in the same order.  The summation order of the atomics changes from run
// to run: the kernel is held to its plain version by tolerance.
//
// Without FOLD (kept for importance coloring, whose cotangents are not
// folded): one thread per (march step, ray) over all of dd, skipping zeros.
//
// Numerics as the march: built with --fmad=false, so the coordinates, the
// snap and the stencil's masks round exactly as PyTorch's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slab_common.cuh"

namespace {

using namespace volym_slab;

template <bool BILINEAR, bool SHADED>
__device__ __forceinline__ void scatter_step(const float* __restrict__ feats, const float* __restrict__ dd,
                                             float* __restrict__ d_vol, float* __restrict__ d_grad, int height,
                                             int width, int n, int nr, int nc, int sign, int subtexel) {
    constexpr int DW = SHADED ? 4 : 1;
    const int x = blockIdx.x * TILE_X + threadIdx.x;
    const int y = blockIdx.y * TILE_Y + threadIdx.y;
    const int j = blockIdx.z;
    if (x >= width || y >= height) return;
    const size_t n_rays = (size_t)height * width;
    const size_t r = (size_t)y * width + x;
    const float* dj = dd + (size_t)j * DW * n_rays + r;
    float v[DW];
    bool any = false;
#pragma unroll
    for (int c = 0; c < DW; ++c) {
        v[c] = __ldg(dj + c * n_rays);
        any = any || v[c] != 0.0f;
    }
    if (!any) return;

    const float* f = feats + r;
    const float jf = (float)j;
    const float rows = snap(clampf(f[F_RS * n_rays] * jf + f[F_RB * n_rays], 0.0f, (float)(nr - 1)), subtexel);
    const float cols = snap(clampf(f[F_CS * n_rays] * jf + f[F_CB * n_rays], 0.0f, (float)(nc - 1)), subtexel);
    const size_t slice = (size_t)nr * nc;
    const size_t k = (size_t)(sign > 0 ? j : n - 1 - j);
    if (v[0] != 0.0f) scatter<BILINEAR>(d_vol + k * slice, rows, cols, nr, nc, v[0]);
    if (SHADED) {
#pragma unroll
        for (int c = 1; c < DW; ++c) {
            if (v[c] != 0.0f) scatter<BILINEAR>(d_grad + ((size_t)(c - 1) * n + k) * slice, rows, cols, nr, nc, v[c]);
        }
    }
}

template <bool BILINEAR, bool SHADED, bool CHAIN>
__device__ __forceinline__ void fold_scatter(const float* __restrict__ feats, const float* __restrict__ dd,
                                             const int* __restrict__ steps, const float* __restrict__ vol,
                                             float* __restrict__ d_vol, float* __restrict__ d_grad,
                                             float* __restrict__ folded, float* __restrict__ d_feats, int height,
                                             int width, int n, int nr, int nc, int sign, int subtexel,
                                             int chunk) {
    static_assert(BILINEAR || !CHAIN, "box hats have no coordinate derivative");
    constexpr int DW = SHADED ? 4 : 1;
    constexpr int HALO = SMOOTH_HALO, ROWS = SMOOTH_ROWS;
    const int x = blockIdx.x * TILE_X + threadIdx.x;
    const int y = blockIdx.y * TILE_Y + threadIdx.y;
    const bool active = x < width && y < height;
    const size_t n_rays = (size_t)height * width;
    const size_t r = active ? (size_t)y * width + x : 0;

    // the steps with a cotangent, and the plain rows they reach
    int first = n, last = -1;
    if (active) {
        first = __ldg(steps + r);
        last = __ldg(steps + n_rays + r);
    }
    int k_lo = n, k_hi = -1;
    if (first <= last) {
        k_lo = max(first - HALO, 0);
        k_hi = min(last + HALO, n - 1);
    }
    // the warp walks the union of its rays' rows
    k_lo = __reduce_min_sync(0xffffffffu, k_lo);
    k_hi = __reduce_max_sync(0xffffffffu, k_hi);
    // this thread's chunk of the rows
    k_lo = max(k_lo, (int)blockIdx.z * chunk);
    k_hi = min(k_hi, (int)blockIdx.z * chunk + chunk - 1);
    if (k_lo > k_hi) return;

    // constants of the ray: the taps' offsets u_t, u_t * rs and u_t * cs,
    // and the 7 quotients coeff_off / wsum of a step with every tap in the
    // box, formed as smooth_dd_transpose forms them
    const float* f = feats + r;
    const float rs = f[F_RS * n_rays], rb = f[F_RB * n_rays];
    const float cs = f[F_CS * n_rays], cb = f[F_CB * n_rays];
    const float ts_raw = f[F_TS * n_rays];
    const float ts = ts_raw == 0.0f ? 1.0f : ts_raw;
    const float bnd_r = (float)nr - 0.5f, bnd_c = (float)nc - 0.5f, bnd_s = (float)n - 0.5f;
    float u[GAUSS_TAPS], urs[GAUSS_TAPS], ucs[GAUSS_TAPS];
#pragma unroll
    for (int t = 0; t < GAUSS_TAPS; ++t) {
        u[t] = gauss_delta(t) / ts;
        urs[t] = u[t] * rs;
        ucs[t] = u[t] * cs;
    }
    // w_t * ker(u_t - off), off = o - 3
    auto wk = [&](int t, int o) {
        const float dl = u[t] - (float)(o - HALO);
        const float ker = BILINEAR ? fmaxf(0.0f, 1.0f - fabsf(dl)) : ((dl >= -0.5f && dl < 0.5f) ? 1.0f : 0.0f);
        return gauss_weight(t) * ker;
    };
    constexpr unsigned ALL_IN = (1u << GAUSS_TAPS) - 1u;
    float w_all = 0.0f;
#pragma unroll
    for (int t = 0; t < GAUSS_TAPS; ++t) w_all = w_all + gauss_weight(t);
    float q_all[ROWS];
#pragma unroll
    for (int o = 0; o < ROWS; ++o) {
        float coeff = 0.0f;
#pragma unroll
        for (int t = 0; t < GAUSS_TAPS; ++t) coeff = coeff + wk(t, o);
        q_all[o] = coeff / w_all;
    }

    // a source step j: its density cotangent (0 outside the ray's range),
    // then, where it is not 0, its taps' in-box bits m and its normaliser w
    auto load = [&](int j) { return (j < first || j > last) ? 0.0f : __ldg(dd + (size_t)j * DW * n_rays + r); };
    auto classify = [&](int j, float v, float& w, unsigned& m) {
        w = 1.0f;
        m = 0u;
        if (v == 0.0f) return;
        const float jf = (float)j;
        const float rows_raw = rs * jf + rb, cols_raw = cs * jf + cb;
        float wsum = 0.0f;
#pragma unroll
        for (int t = 0; t < GAUSS_TAPS; ++t) {
            const float rt = rows_raw + urs[t];
            const float ct = cols_raw + ucs[t];
            const float st = jf + u[t];
            const bool in_box = rt >= -0.5f && rt <= bnd_r && ct >= -0.5f && ct <= bnd_c && st >= -0.5f && st <= bnd_s;
            wsum = wsum + (in_box ? gauss_weight(t) : 0.0f);
            m |= (unsigned)in_box << t;
        }
        w = wsum > 0.0f ? wsum : 1.0f;
    };
    // coeff_off(j) / wsum(j) * dd[j], off = o - 3
    auto term = [&](float v, float w, unsigned m, int o) {
        if (m == ALL_IN) return q_all[o] * v;
        float coeff = 0.0f;
#pragma unroll
        for (int t = 0; t < GAUSS_TAPS; ++t) coeff = coeff + (((m >> t) & 1u) ? wk(t, o) : 0.0f);
        return coeff / w * v;
    };

    // The window: slot s holds source step k + s - 3 for the trip's first
    // row k.  A trip folds UNROLL rows, whose UNROLL new sources it loads
    // together, so that their latencies overlap.
    constexpr int UNROLL = 4, WIN = ROWS + UNROLL - 1;
    float rv[WIN], rw[WIN];
    unsigned rm[WIN];
#pragma unroll
    for (int s = 0; s < ROWS - 1; ++s) rv[s] = load(k_lo + s - HALO);
#pragma unroll
    for (int s = 0; s < ROWS - 1; ++s) classify(k_lo + s - HALO, rv[s], rw[s], rm[s]);

    const size_t slice = (size_t)nr * nc;
    // CHAIN: the plain rows' camera chain, d_feats' rows F_RS, F_RB, F_CS, F_CB
    float a_rs = 0.0f, a_rb = 0.0f, a_cs = 0.0f, a_cb = 0.0f;
    for (int k = k_lo; k <= k_hi; k += UNROLL) {
#pragma unroll
        for (int s = ROWS - 1; s < WIN; ++s) rv[s] = load(k + s - HALO);
#pragma unroll
        for (int s = ROWS - 1; s < WIN; ++s) classify(k + s - HALO, rv[s], rw[s], rm[s]);
#pragma unroll
        for (int e = 0; e < UNROLL; ++e) {  // row kr, its sources in slots e .. e + 6
            const int kr = k + e;
            if (kr > k_hi) break;
            bool any = false;
#pragma unroll
            for (int o = 0; o < ROWS; ++o) any = any || rv[e + o] != 0.0f;
            const bool src = SHADED && kr >= first && kr <= last;  // channels 1..3 of step kr
            if (!any && !src) continue;

            // plain row kr, the offsets -3..3 in order
            float acc = 0.0f;
            if (any) {
                if (kr > 0 && kr < n - 1) {  // one source an offset: j = kr - off, slot e + 6 - o
#pragma unroll
                    for (int o = 0; o < ROWS; ++o) {
                        const int s = e + 2 * HALO - o;
                        if (rv[s] != 0.0f) acc = acc + term(rv[s], rw[s], rm[s], o);
                    }
                } else {  // an end row: the steps j with clamp(j + off) == kr, in order
#pragma unroll
                    for (int o = 0; o < ROWS; ++o) {
                        const int off = o - HALO;
                        const int j_lo = kr == 0 ? 0 : kr - off;
                        const int j_hi = kr == n - 1 ? n - 1 : kr - off;
#pragma unroll
                        for (int d = 0; d < ROWS; ++d) {
                            const int s = e + d, j = kr + d - HALO;
                            if (j >= j_lo && j <= j_hi && rv[s] != 0.0f) acc = acc + term(rv[s], rw[s], rm[s], o);
                        }
                    }
                }
            }
            if (acc == 0.0f && !src) continue;

            const float kf = (float)kr;
            const float rows = snap(clampf(rs * kf + rb, 0.0f, (float)(nr - 1)), subtexel);
            const float cols = snap(clampf(cs * kf + cb, 0.0f, (float)(nc - 1)), subtexel);
            const size_t kk = (size_t)(sign > 0 ? kr : n - 1 - kr);
            if (acc != 0.0f) {
                scatter<BILINEAR>(d_vol + kk * slice, rows, cols, nr, nc, acc);
                if (folded != nullptr) folded[(size_t)kr * n_rays + r] = acc;
                if (CHAIN) {  // as feats_grad: masked where the raw coordinate is clipped
                    const float rows_raw = rs * kf + rb, cols_raw = cs * kf + cb;
                    const float2 ds = dsample(vol + kk * slice, rows, cols, nr, nc);
                    const float d_rows = (rows_raw > 0.0f && rows_raw < (float)(nr - 1)) ? acc * ds.x : 0.0f;
                    const float d_cols = (cols_raw > 0.0f && cols_raw < (float)(nc - 1)) ? acc * ds.y : 0.0f;
                    a_rs = a_rs + d_rows * kf;
                    a_rb = a_rb + d_rows;
                    a_cs = a_cs + d_cols * kf;
                    a_cb = a_cb + d_cols;
                }
            }
            if (SHADED && src) {
                const float* dk = dd + (size_t)kr * DW * n_rays + r;
#pragma unroll
                for (int c = 1; c < DW; ++c) {
                    const float v = __ldg(dk + c * n_rays);
                    if (v != 0.0f) {
                        scatter<BILINEAR>(d_grad + ((size_t)(c - 1) * n + kk) * slice, rows, cols, nr, nc, v);
                    }
                }
            }
        }
#pragma unroll
        for (int s = 0; s < ROWS - 1; ++s) {
            rv[s] = rv[s + UNROLL];
            rw[s] = rw[s + UNROLL];
            rm[s] = rm[s + UNROLL];
        }
    }
    if (CHAIN && active) {
        float* df = d_feats + r;
        if (gridDim.z == 1) {  // the ray's one chunk: its sums in row order
            df[F_RS * n_rays] = a_rs;
            df[F_RB * n_rays] = a_rb;
            df[F_CS * n_rays] = a_cs;
            df[F_CB * n_rays] = a_cb;
        } else if (a_rs != 0.0f || a_rb != 0.0f || a_cs != 0.0f || a_cb != 0.0f) {
            atomicAdd(df + F_RS * n_rays, a_rs);
            atomicAdd(df + F_RB * n_rays, a_rb);
            atomicAdd(df + F_CS * n_rays, a_cs);
            atomicAdd(df + F_CB * n_rays, a_cb);
        }
    }
}

template <bool BILINEAR, bool SHADED, bool FOLD>
__global__ void __launch_bounds__(TILE_X * TILE_Y) voxel_grad_kernel(
    const float* __restrict__ feats,  // (N_FEATURES, H, W)
    const float* __restrict__ dd,     // (n, SHADED ? 4 : 1, H, W) in march order j
    const int* __restrict__ steps,    // (2, H, W) first and last step with a cotangent (FOLD)
    float* __restrict__ d_vol,        // (n, nr, nc), zero-filled
    float* __restrict__ d_grad,       // (3, n, nr, nc) when SHADED, zero-filled
    float* __restrict__ folded,       // (n, H, W) zero-filled, or NULL (FOLD)
    int height, int width, int n, int nr, int nc, int sign, int subtexel, int chunk) {
    if constexpr (FOLD) {
        fold_scatter<BILINEAR, SHADED, false>(feats, dd, steps, nullptr, d_vol, d_grad, folded, nullptr, height,
                                              width, n, nr, nc, sign, subtexel, chunk);
    } else {
        scatter_step<BILINEAR, SHADED>(feats, dd, d_vol, d_grad, height, width, n, nr, nc, sign, subtexel);
    }
}

// FOLD with CHAIN (bilinear): held to two blocks an SM, the occupancy of
// the fold without the chain (128 registers); unbounded, the chain's sums
// and taps take ptxas past 128 registers, to one block an SM.  A kernel of
// its own, so that the bound leaves the variants without the chain as
// they are.
template <bool SHADED>
__global__ void __launch_bounds__(TILE_X * TILE_Y, 2) voxel_grad_chain_kernel(
    const float* __restrict__ feats,  // (N_FEATURES, H, W)
    const float* __restrict__ dd,     // (n, SHADED ? 4 : 1, H, W) in march order j
    const int* __restrict__ steps,    // (2, H, W) first and last step with a cotangent
    const float* __restrict__ vol,    // (n, nr, nc) f32, the volume as marched
    float* __restrict__ d_vol,        // (n, nr, nc), zero-filled
    float* __restrict__ d_grad,       // (3, n, nr, nc) when SHADED, zero-filled
    float* __restrict__ d_feats,      // (N_FEATURES, H, W), zero-filled; rows F_RS..F_CB added here
    int height, int width, int n, int nr, int nc, int sign, int subtexel, int chunk) {
    fold_scatter<true, SHADED, true>(feats, dd, steps, vol, d_vol, d_grad, nullptr, d_feats, height, width, n, nr,
                                     nc, sign, subtexel, chunk);
}

// 16x16 rays a block; the grid's z extent is the step without FOLD, the chunk with it
dim3 grid_of(int height, int width, int z) {
    return dim3((width + TILE_X - 1) / TILE_X, (height + TILE_Y - 1) / TILE_Y, z);
}

template <bool BILINEAR, bool SHADED, bool FOLD>
void launch(const float* feats, const float* dd, const int* steps, float* d_vol, float* d_grad, float* folded,
            int height, int width, int n, int nr, int nc, int sign, int subtexel, int chunk, cudaStream_t stream) {
    const dim3 block(TILE_X, TILE_Y);
    const dim3 grid = grid_of(height, width, FOLD ? (n + chunk - 1) / chunk : n);
    voxel_grad_kernel<BILINEAR, SHADED, FOLD><<<grid, block, 0, stream>>>(
        feats, dd, steps, d_vol, d_grad, folded, height, width, n, nr, nc, sign, subtexel, chunk);
}

template <bool FOLD>
int launch_variant(const float* feats, const float* dd, const int* steps, float* d_vol, float* d_grad,
                   float* folded, int height, int width, int n, int nr, int nc, int sign, int subtexel,
                   int bilinear, int shaded, int chunk, cudaStream_t s) {
    switch ((bilinear ? 2 : 0) | (shaded ? 1 : 0)) {
        case 0: launch<false, false, FOLD>(feats, dd, steps, d_vol, d_grad, folded, height, width, n, nr, nc, sign,
                                           subtexel, chunk, s); break;
        case 1: launch<false, true, FOLD>(feats, dd, steps, d_vol, d_grad, folded, height, width, n, nr, nc, sign,
                                          subtexel, chunk, s); break;
        case 2: launch<true, false, FOLD>(feats, dd, steps, d_vol, d_grad, folded, height, width, n, nr, nc, sign,
                                          subtexel, chunk, s); break;
        default: launch<true, true, FOLD>(feats, dd, steps, d_vol, d_grad, folded, height, width, n, nr, nc, sign,
                                          subtexel, chunk, s); break;
    }
    return (int)cudaGetLastError();
}

template <bool SHADED>
int launch_chain(const float* feats, const float* dd, const int* steps, const float* vol, float* d_vol,
                 float* d_grad, float* d_feats, int height, int width, int n, int nr, int nc, int sign, int subtexel,
                 int chunk, cudaStream_t s) {
    const dim3 block(TILE_X, TILE_Y);
    voxel_grad_chain_kernel<SHADED><<<grid_of(height, width, (n + chunk - 1) / chunk), block, 0, s>>>(
        feats, dd, steps, vol, d_vol, d_grad, d_feats, height, width, n, nr, nc, sign, subtexel, chunk);
    return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes: launch on `stream` and return cudaGetLastError().
// `d_grad` is NULL unless `shaded`.

// without FOLD: one thread per (step, ray)
extern "C" int voxel_grad_launch(const float* feats, const float* dd, float* d_vol, float* d_grad, int height,
                                 int width, int n, int nr, int nc, int sign, int subtexel, int bilinear, int shaded,
                                 void* stream) {
    if (n < 1 || n > 65535) return (int)cudaErrorInvalidValue;  // the grid's z extent
    return launch_variant<false>(feats, dd, nullptr, d_vol, d_grad, nullptr, height, width, n, nr, nc, sign,
                                 subtexel, bilinear, shaded, 1, static_cast<cudaStream_t>(stream));
}

// FOLD: one thread per (ray, chunk of `chunk` rows) over the ray's step
// range; `folded` may be NULL.  With `vol` (the f32 volume as marched) and
// `d_feats` (zero-filled) not NULL, the CHAIN variant (`bilinear` only,
// `folded` NULL) also adds the plain rows' camera chain into d_feats.  The
// two come after `stream`, so that a caller of an older build passes them
// to no effect.
extern "C" int voxel_grad_fold_launch(const float* feats, const float* dd, const int* steps, float* d_vol,
                                      float* d_grad, float* folded, int height, int width, int n, int nr, int nc,
                                      int sign, int subtexel, int bilinear, int shaded, int chunk, void* stream,
                                      const float* vol, float* d_feats) {
    if (n < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vol == nullptr && d_feats == nullptr) {
        return launch_variant<true>(feats, dd, steps, d_vol, d_grad, folded, height, width, n, nr, nc, sign,
                                    subtexel, bilinear, shaded, chunk, s);
    }
    if (vol == nullptr || d_feats == nullptr || folded != nullptr || !bilinear) return (int)cudaErrorInvalidValue;
    return shaded ? launch_chain<true>(feats, dd, steps, vol, d_vol, d_grad, d_feats, height, width, n, nr, nc, sign,
                                       subtexel, chunk, s)
                  : launch_chain<false>(feats, dd, steps, vol, d_vol, d_grad, d_feats, height, width, n, nr, nc, sign,
                                        subtexel, chunk, s);
}
