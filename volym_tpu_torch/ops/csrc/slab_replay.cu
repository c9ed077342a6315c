// Replay backward of the slab march for Hopper (sm_90a): one CUDA thread per
// ray, with the voxel scatter fused in.
//
// Replaces the TPU kernel volym_tpu/ops/slab_bwd_kernel.py::_replay_kernel
// (step body _replay_step_body): the stored-density or re-sampled replay
// with the voxel scatter fused (slab_bwd_kernel.py:792-815), in the base and
// Blinn-Phong shading modes, nearest or bilinear, f32 or u8 density stream,
// under smoothing the per-step cotangents, with its camera chain (CAM), the
// look-ahead gate and importance coloring (all below).  The plain PyTorch version is
// volym_tpu_torch/render/slab.py::replay_slabs.
//
// Per ray the kernel re-runs the forward's compositing recurrence with the
// forward's own control flow (break on t >= exit or alpha >= early alpha,
// skip t < entry, skip density < threshold), so it visits exactly the steps
// the forward composited: the stored residual (slab_march.cu, EMIT) is read
// only where the forward wrote it, and without it the volume is re-sampled
// with the forward's own sample<>.  At each composited step it rebuilds the
// transmittance from the running accumulator and the suffix from the final
// image, chains the image cotangent through the opacity correction, the
// shading and the TF lookup, and
//   - adds the step's density cotangent dd, times the sample's own bilinear
//     (4 taps) or box (1 tap) weights, into d_vol[k], and the gradient-field
//     cotangent into d_grad[c][k] when shaded, with global atomics;
//   - adds the TF cotangent into a per-block copy of d_lut in shared memory
//     (shared atomics, weights (1-fr, fr) on texels (i0, i1)), flushed with
//     one global atomicAdd per nonzero entry per block.
// The TF-coordinate derivative follows the TPU kernel: lut[i1] - lut[i0]
// inside a texel, exactly 0 at an integer coordinate, and dd is dropped
// where the raw coordinate is clamped.
//
// Bound: latency.  A step is a chain of dependent loads (the residual or
// the taps, then the LUT) as in the forward, and ends in 4 (or 16 when
// shaded) global float atomics into the permuted grid (64 MB f32 at 256^3,
// a little above the 50 MB L2) plus 8 shared atomics.  Neighbouring
// threads of a 16x16 tile hit neighbouring voxels, so the atomics of a
// warp spread over few cache lines; the LUT gradient, which every ray
// touches, stays in shared memory.  On the H100 the global scatter and
// the shared atomics are 3-17% of the time at 1024x768, and combining a
// warp's atomics on one target first (cooperative groups'
// labeled_partition and reduce) measured slower on every route than the
// atomics it saves (PERF.md §6), so each thread adds its own.  Under
// smoothing the bytes are the in-range dd, written once (below).  The
// summation order of d_vol and d_lut changes from run to run: the kernel
// is held to its plain version by tolerance.
//
// Numerics: built with --fmad=false like the forward.  The replayed
// accumulator must equal the forward's bit for bit, or the early-alpha mask
// of a later step flips.
//
// Gaussian smoothing (SMOOTH; the TPU replay with fuse_scatter=False,
// slab_bwd_kernel.py:329-400, 1590-1600): the step's density is the
// smoothed one, read from the residual or re-sampled through the forward's
// own SmoothWindow and smooth_density (slab_common.cuh), so the replay
// retraces the forward bit for bit.  Re-sampled, a step whose 7 plain rows
// all lie below the threshold by sample_bound skips its stencil, as the
// forward does: its smoothed density lies below it too, so the step
// composites nothing either way.  A step's density cotangent belongs to
// the smoothed density, a stencil over plain rows, and cannot be scattered
// at the step's own coordinates: the kernel writes it, and the
// gradient-field cotangents when shaded, into dd (n, 1 or 4, H, W) at
// (j, ray), rays fastest, and scatters nothing into d_vol or d_grad.  The
// fused fold-and-scatter of voxel_grad.cu (B3, B4) takes dd from there.
// d_lut stays here.  The kernel also writes each ray's step range, steps
// (2, H, W) int32: the first and the last step at which it writes a
// cotangent (a composited step whose TF coordinate lies inside the LUT, or
// that is lit when shaded; n and -1 for a ray with none), so that the fold
// walks only those steps and their stencil halo.
//
// dd's contract: the kernel writes every channel of every step inside each
// ray's range, exact 0.0 where a step composites nothing or leaves a
// channel unwritten, and nothing outside it.  It writes lazily: a written
// step first zero-fills the steps since the previous written one, so the
// steps before the first and after the last cost nothing.  dd outside the
// range is unspecified (the wrapper allocates it with torch.empty); the
// fold reads only inside it, and the plain version's dd is 0.0 there
// (slab.py::dense_dd makes the kernel's dd dense for a reader of all of
// it).
//
// Camera cotangents (CAM; _replay_step_body :817-892): the kernel also
// accumulates d_feats, the cotangent of the ray's table, in registers over
// its steps and writes it once (one thread per ray: no atomics):
//   - F_RS/F_RB/F_CS/F_CB: d_rows * j, d_rows, d_cols * j, d_cols, where
//     d_rows is dd times the density sample's coordinate derivative
//     (dsample, slab_common.cuh; unsmoothed only) plus, when shaded, each
//     gradient-field channel's cotangent times that channel's derivative,
//     each masked where the raw coordinate is clipped; bilinear only (box
//     hats have none).  Under smoothing the density's part belongs to the
//     plain rows and runs in voxel_grad.cu (CHAIN, B5) with the transpose;
//   - F_TS: under smoothing with bilinear sampling, dd times the smoothed
//     density's tap-offset derivative (smooth_density_dts, from the same
//     window);
//   - F_AEXP: d_alpha * log(1 - a) * (alpha - 1);
//   - F_HX..F_HZ: d(h.n) * n when shaded.
// The wrapper zero-fills d_feats; its other rows stay 0.  The chain reads
// the f32 slices, so CAM comes only without U8 and STORED: 8 variants.
//
// Look-ahead gate (_replay_step_body :633-637): with a gate, B1's packed
// bits (lookahead.cu), a step whose bit is set adds nothing in either
// direction, on every route: the kernel skips it as the forward did (after
// advancing the smoothing window, which every step the ray reaches does).
// A nullable pointer, not a template argument, read at each step it tests.
//
// Importance coloring (COLOR; _replay_step_body :588-597, :704-747,
// :823-835, :878-879): the colour comes from the importance grid's box tap
// at the step's coordinates, rgba = (min(1.5 imp, 1), 1.2 (1 - imp), 0.2,
// imp), and the density (plain, or smoothed and re-sampled) is only the
// threshold mask.  The step's cotangent d_imp = d_r * 1.5 * [1.5 imp < 1] -
// 1.2 d_g + d_a scatters with the tap's box hat into d_imp (the d_vol
// argument), and when shaded the gradient-field cotangent with its own
// hats into d_grad: fused on every route, smoothed too, since nothing is
// folded (slab_bwd_kernel.py:1684-1691), so neither dd nor steps is
// written and there is no d_lut.  Under CAM only F_AEXP, the half vector
// and, shaded and bilinear, the gradient field's coordinate chain run: the
// box-sampled importance and the density have none, and F_TS none either.
// COLOR comes without STORED (the training step stores no residual under
// coloring): 16 + 8 more variants.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "slab_common.cuh"

namespace {

using namespace volym_slab;

// Blinn-Phong constants (volym_tpu_torch/render/shading.py)
constexpr float AMBIENT = 0.2f, DIFFUSE = 0.7f, SPECULAR = 0.4f, SHININESS = 24.0f;
constexpr float INV_SQRT3 = 0.57735026f;

template <bool BILINEAR, bool U8, bool SHADING, bool STORED, bool SMOOTH, bool CAM, bool COLOR>
__device__ __forceinline__ void replay_ray(
    const float* __restrict__ f, const void* __restrict__ vol_, const float* __restrict__ grad,
    const float* __restrict__ s_lut, const float* __restrict__ dens, float4 fin, float4 g,
    float* __restrict__ d_vol, float* __restrict__ d_grad, float* __restrict__ s_dlut, float* __restrict__ dd,
    int* __restrict__ steps, float* __restrict__ df, const uint32_t* __restrict__ gate,
    const float* __restrict__ imp, size_t n_rays, size_t r, int n, int nr, int nc, int ln,
    int sign, int subtexel, float threshold, float early_alpha, float tf_scale) {
    static_assert(!(CAM && (U8 || STORED)), "camera cotangents read the f32 slices");
    static_assert(!(COLOR && STORED), "coloring re-samples");
    constexpr bool COORD = CAM && BILINEAR;  // the coordinates' chain (box hats have none)
    constexpr bool UNFUSED = SMOOTH && !COLOR;  // dd and steps: the smoothed density's cotangents
    using T = typename std::conditional<U8, uint8_t, float>::type;
    const T* __restrict__ vol = static_cast<const T*>(vol_);
    constexpr int DW = SHADING ? 4 : 1;

    const float entry = f[F_ENTRY * n_rays], exit_ = f[F_EXIT * n_rays];
    // the first and last step with a written cotangent (SMOOTH)
    int first = n, last = -1;
    // a ray that misses the box or fails the sign flag composites nothing:
    // its cotangents are zero whatever fin and g hold there
    if (exit_ <= entry || !(f[F_SIGNOK * n_rays] > 0.5f)) {
        if (UNFUSED) {
            steps[r] = first;
            steps[n_rays + r] = last;
        }
        return;
    }
    const float rs = f[F_RS * n_rays], rb = f[F_RB * n_rays];
    const float cs = f[F_CS * n_rays], cb = f[F_CB * n_rays];
    const float ts = f[F_TS * n_rays], tb = f[F_TB * n_rays];
    const float aexp = f[F_AEXP * n_rays];
    float hx = 0.0f, hy = 0.0f, hz = 0.0f;
    if (SHADING) {
        hx = f[F_HX * n_rays];
        hy = f[F_HY * n_rays];
        hz = f[F_HZ * n_rays];
    }
    const size_t slice = (size_t)nr * nc;
    const float rmax = (float)(nr - 1), cmax = (float)(nc - 1), lmax = (float)(ln - 1);

    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
    // the camera chain's accumulators: F_RS, F_RB, F_CS, F_CB, F_TS, F_AEXP, F_HX..F_HZ
    float a_rs = 0.0f, a_rb = 0.0f, a_cs = 0.0f, a_cb = 0.0f, a_ts = 0.0f, a_aexp = 0.0f;
    float a_hx = 0.0f, a_hy = 0.0f, a_hz = 0.0f;
    SmoothWindow<BILINEAR, T> win;
    for (int j = 0; j < n; ++j) {
        const float jf = (float)j;
        const float t = ts * jf + tb;
        if (t >= exit_ || acc_a >= early_alpha) break;
        if (!(t >= entry)) continue;
        if (SMOOTH && !STORED) {
            win.advance(vol, j, rs, rb, cs, cb, n, nr, nc, sign, subtexel);
            float m = win.d[0];
#pragma unroll
            for (int o = 1; o < SMOOTH_ROWS; ++o) m = fmaxf(m, win.d[o]);
            if (!(sample_bound(m) >= threshold)) continue;  // the stencil of rows below it is below it
        }
        // the gate's word loaded at every step it tests (an L1 hit but the
        // first of 32): a word kept across steps held two more registers on
        // every route, gated or not, and cost the fused route a block an SM
        if (gate != nullptr && ((__ldg(gate + (size_t)(j >> 5) * n_rays + r) >> (j & 31)) & 1u)) continue;
        const float rows = snap(clampf(rs * jf + rb, 0.0f, rmax), subtexel);
        const float cols = snap(clampf(cs * jf + cb, 0.0f, cmax), subtexel);
        const size_t k = (size_t)(sign > 0 ? j : n - 1 - j);
        const float* dj = STORED ? dens + (size_t)j * DW * n_rays + r : nullptr;
        float density;
        if (STORED) {
            density = dj[0];
        } else if (SMOOTH) {
            density = smooth_density<BILINEAR>(win.d, j, rs, rb, cs, cb, ts, n, nr, nc);
        } else {
            density = sample<BILINEAR>(vol + k * slice, rows, cols, nr, nc);
        }
        if (!(density >= threshold)) continue;

        // the colour before shading: the TF lookup, or the importance heat map
        float c_raw = 0.0f, fr = 0.0f, ufr = 0.0f, im = 0.0f, tf_r, tf_g, tf_b, tf_a;
        int i0 = 0, i1 = 0;
        if (COLOR) {
            im = sample<false>(imp + k * slice, rows, cols, nr, nc);
            tf_r = fminf(im * 1.5f, 1.0f);
            tf_g = (1.0f - im) * 1.2f;
            tf_b = 0.2f;
            tf_a = im;
        } else {
            c_raw = density * tf_scale - 0.5f;
            const TfTexels tx = tf_texels(density, tf_scale, lmax, ln);
            i0 = tx.i0;
            i1 = tx.i1;
            fr = tx.fr;
            ufr = tx.ufr;
            tf_r = s_lut[i0 * 4 + 0] * ufr + s_lut[i1 * 4 + 0] * fr;
            tf_g = s_lut[i0 * 4 + 1] * ufr + s_lut[i1 * 4 + 1] * fr;
            tf_b = s_lut[i0 * 4 + 2] * ufr + s_lut[i1 * 4 + 2] * fr;
            tf_a = s_lut[i0 * 4 + 3] * ufr + s_lut[i1 * 4 + 3] * fr;
        }
        float cr = tf_r, cg = tf_g, cbl = tf_b;

        // the coordinates' chain masks: the raw coordinate strictly inside
        bool rows_in = false, cols_in = false;
        if (COORD) {
            const float rows_raw = rs * jf + rb, cols_raw = cs * jf + cb;
            rows_in = rows_raw > 0.0f && rows_raw < rmax;
            cols_in = cols_raw > 0.0f && cols_raw < cmax;
        }
        // the gradient field's part of d_rows / d_cols, per channel
        float g_rows[3] = {0.0f, 0.0f, 0.0f}, g_cols[3] = {0.0f, 0.0f, 0.0f};

        // shading state (the forward's expressions, slab_march.cu)
        bool lit_on = false;
        float gx = 0.0f, gy = 0.0f, gz = 0.0f, norm = 1.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
        float s_diff = 0.0f, hdotn = 0.0f, lit = 1.0f;
        if (SHADING) {
            if (STORED) {
                gx = dj[n_rays];
                gy = dj[2 * n_rays];
                gz = dj[3 * n_rays];
            } else {
                gx = sample<BILINEAR>(grad + k * slice, rows, cols, nr, nc);
                gy = sample<BILINEAR>(grad + ((size_t)n + k) * slice, rows, cols, nr, nc);
                gz = sample<BILINEAR>(grad + ((size_t)2 * n + k) * slice, rows, cols, nr, nc);
            }
            const float sq = gx * gx + gy * gy + gz * gz;
            if (sq > 0.0f) {
                lit_on = true;
                norm = sqrtf(sq);
                nx = gx / norm;
                ny = gy / norm;
                nz = gz / norm;
                s_diff = (nx + ny + nz) * INV_SQRT3;
                const float diffuse = fmaxf(s_diff, 0.0f);
                hdotn = hx * nx + hy * ny + hz * nz;
                const float spec = powf(fmaxf(hdotn, 0.0f), SHININESS);
                lit = AMBIENT + DIFFUSE * diffuse;
                const float sp = SPECULAR * spec;
                cr = cr * lit + sp;
                cg = cg * lit + sp;
                cbl = cbl * lit + sp;
            }
        }

        // compositing, exactly as the forward
        const float log1ma = logf(fmaxf(1.0f - tf_a, 1e-37f));
        const float alpha = 1.0f - expf(aexp * log1ma);
        const float t_k = 1.0f - acc_a;
        const float w = t_k * alpha;
        acc_r = acc_r + cr * w;
        acc_g = acc_g + cg * w;
        acc_b = acc_b + cbl * w;
        acc_a = acc_a + w;

        // d loss / d alpha from the suffix fin - acc (behind this sample)
        const float suf_r = fin.x - acc_r, suf_g = fin.y - acc_g, suf_b = fin.z - acc_b;
        const float suf_a = fin.w - acc_a;
        const float inv = 1.0f / fmaxf(1.0f - alpha, 1e-7f);
        const float d_beta = t_k * ((g.x * cr + g.y * cg + g.z * cbl) + g.w) -
                             ((g.x * suf_r + g.y * suf_g + g.z * suf_b) + g.w * suf_a) * inv;
        const float d_a = d_beta * aexp * expf((aexp - 1.0f) * log1ma);
        float d_r = g.x * w, d_g = g.y * w, d_b = g.z * w;

        // the gradient-field cotangent (0 where unlit)
        float d_gx = 0.0f, d_gy = 0.0f, d_gz = 0.0f;
        if (SHADING && lit_on) {
            // rgb = tf_rgb * lit + S * spec  ->  d tf_rgb, d normal -> d g
            const float d_diffuse = (d_r * tf_r + d_g * tf_g + d_b * tf_b) * DIFFUSE;
            const float d_spec = (d_r + d_g + d_b) * SPECULAR;
            const float d_hdotn =
                hdotn > 0.0f ? d_spec * SHININESS * powf(fmaxf(hdotn, 0.0f), SHININESS - 1.0f) : 0.0f;
            const float d_sdiff = s_diff > 0.0f ? d_diffuse : 0.0f;
            const float d_nx = d_sdiff * INV_SQRT3 + d_hdotn * hx;
            const float d_ny = d_sdiff * INV_SQRT3 + d_hdotn * hy;
            const float d_nz = d_sdiff * INV_SQRT3 + d_hdotn * hz;
            const float n_dot_dn = nx * d_nx + ny * d_ny + nz * d_nz;
            const float inv_norm = 1.0f / norm;
            d_gx = inv_norm * (d_nx - nx * n_dot_dn);
            d_gy = inv_norm * (d_ny - ny * n_dot_dn);
            d_gz = inv_norm * (d_nz - nz * n_dot_dn);
            if (CAM) {
                a_hx = a_hx + d_hdotn * nx;
                a_hy = a_hy + d_hdotn * ny;
                a_hz = a_hz + d_hdotn * nz;
            }
            if (COORD) {
                const float d_gc[3] = {d_gx, d_gy, d_gz};
#pragma unroll
                for (int ch = 0; ch < 3; ++ch) {
                    const float2 ds = dsample(grad + ((size_t)ch * n + k) * slice, rows, cols, nr, nc);
                    g_rows[ch] = rows_in ? d_gc[ch] * ds.x : 0.0f;
                    g_cols[ch] = cols_in ? d_gc[ch] * ds.y : 0.0f;
                }
            }
            d_r = d_r * lit;
            d_g = d_g * lit;
            d_b = d_b * lit;
        }

        float ddv = 0.0f;  // the density cotangent (none under COLOR)
        bool tf_in = false;
        if (COLOR) {
            // d_imp, scattered with the importance tap's box hat
            const float d_imp = d_r * (im * 1.5f < 1.0f ? 1.5f : 0.0f) - d_g * 1.2f + d_a;
            atomicAdd(d_vol + k * slice + nearest_index(rows, cols, nr, nc), d_imp);
        } else {
            // TF: d_lut on the two texels, dd through the texel slope
            const float d_rgba[4] = {d_r, d_g, d_b, d_a};
            float d_c = 0.0f;
#pragma unroll
            for (int ch = 0; ch < 4; ++ch) {
                atomicAdd(s_dlut + i0 * 4 + ch, d_rgba[ch] * ufr);
                atomicAdd(s_dlut + i1 * 4 + ch, d_rgba[ch] * fr);
                d_c = d_c + d_rgba[ch] * (s_lut[i1 * 4 + ch] - s_lut[i0 * 4 + ch]);
            }
            tf_in = fr > 0.0f && c_raw > 0.0f && c_raw < lmax;
            ddv = tf_in ? d_c * tf_scale : 0.0f;
        }
        if (UNFUSED) {
            if (tf_in || lit_on) {
                // the steps since the previous written one carry no cotangent
                if (last >= 0) {
                    for (int s = last + 1; s < j; ++s) {
                        float* dz = dd + (size_t)s * DW * n_rays + r;
#pragma unroll
                        for (int c = 0; c < DW; ++c) dz[c * n_rays] = 0.0f;
                    }
                } else {
                    first = j;
                }
                last = j;
                float* ddj = dd + (size_t)j * DW * n_rays + r;
                ddj[0] = ddv;
                if (SHADING) {
                    ddj[n_rays] = d_gx;
                    ddj[2 * n_rays] = d_gy;
                    ddj[3 * n_rays] = d_gz;
                }
            }
        } else {
            if (SHADING && lit_on) {
                scatter<BILINEAR>(d_grad + k * slice, rows, cols, nr, nc, d_gx);
                scatter<BILINEAR>(d_grad + ((size_t)n + k) * slice, rows, cols, nr, nc, d_gy);
                scatter<BILINEAR>(d_grad + ((size_t)2 * n + k) * slice, rows, cols, nr, nc, d_gz);
            }
            if (tf_in) scatter<BILINEAR>(d_vol + k * slice, rows, cols, nr, nc, ddv);
        }
        if (CAM) {
            a_aexp = a_aexp + d_beta * log1ma * (alpha - 1.0f);
            if (COORD) {
                float d_rows = 0.0f, d_cols = 0.0f;
                if (!SMOOTH && !COLOR) {
                    const float2 ds = dsample(reinterpret_cast<const float*>(vol) + k * slice, rows, cols, nr, nc);
                    d_rows = rows_in ? ddv * ds.x : 0.0f;
                    d_cols = cols_in ? ddv * ds.y : 0.0f;
                }
                if (SHADING) {
#pragma unroll
                    for (int ch = 0; ch < 3; ++ch) {
                        d_rows = d_rows + g_rows[ch];
                        d_cols = d_cols + g_cols[ch];
                    }
                }
                a_rs = a_rs + d_rows * jf;
                a_rb = a_rb + d_rows;
                a_cs = a_cs + d_cols * jf;
                a_cb = a_cb + d_cols;
                if (UNFUSED) a_ts = a_ts + ddv * smooth_density_dts(win.d, j, rs, rb, cs, cb, ts, n, nr, nc);
            }
        }
    }
    if (UNFUSED) {
        steps[r] = first;
        steps[n_rays + r] = last;
    }
    if (CAM) {
        df[F_AEXP * n_rays] = a_aexp;
        if (SHADING) {
            df[F_HX * n_rays] = a_hx;
            df[F_HY * n_rays] = a_hy;
            df[F_HZ * n_rays] = a_hz;
        }
        if (COORD) {
            df[F_RS * n_rays] = a_rs;
            df[F_RB * n_rays] = a_rb;
            df[F_CS * n_rays] = a_cs;
            df[F_CB * n_rays] = a_cb;
            if (UNFUSED) df[F_TS * n_rays] = a_ts;
        }
    }
}

// The kernel's parameters, shared by its two launch-bound variants below
#define VOLYM_REPLAY_PARAMS                                                                                         \
    const float* __restrict__ feats,    /* (N_FEATURES, H, W) */                                                     \
        const void* __restrict__ vol,   /* (n, nr, nc) uint8 if U8 else float; unread when STORED */                 \
        const float* __restrict__ grad, /* (3, n, nr, nc) when SHADING and not STORED */                             \
        const float* __restrict__ lut,  /* (ln, 4) */                                                                \
        const float* __restrict__ dens, /* (n, SHADING ? 4 : 1, H, W) when STORED */                                 \
        const float* __restrict__ fin,  /* (H, W, 4) the forward's image */                                          \
        const float* __restrict__ gimg, /* (H, W, 4) its cotangent */                                                \
        float* __restrict__ d_vol,      /* (n, nr, nc), zero-filled; d_imp when COLOR */                             \
        float* __restrict__ d_grad,     /* (3, n, nr, nc) when SHADING, zero-filled */                               \
        float* __restrict__ d_lut,      /* (ln, 4), zero-filled */                                                   \
        float* __restrict__ dd,         /* (n, SHADING ? 4 : 1, H, W) when SMOOTH, written in each ray's range */    \
        int* __restrict__ steps,        /* (2, H, W) when SMOOTH: first and last written step */                     \
        float* __restrict__ d_feats,    /* (N_FEATURES, H, W) when CAM, zero-filled */                               \
        const uint32_t* __restrict__ gate, /* (ceil(n / 32), H, W) packed gate bits, or NULL */                      \
        const float* __restrict__ imp,  /* (n, nr, nc) importance when COLOR */                                      \
        int height, int width, int n, int nr, int nc, int ln, int sign, int subtexel, float threshold,               \
        float early_alpha, float tf_scale
#define VOLYM_REPLAY_ARGS                                                                                           \
    feats, vol, grad, lut, dens, fin, gimg, d_vol, d_grad, d_lut, dd, steps, d_feats, gate, imp, height, width, n,   \
        nr, nc, ln, sign, subtexel, threshold, early_alpha, tf_scale

// one block a 16x16 tile of rays: the LUT and a block copy of d_lut in shared
// memory, a ray a thread, the copy flushed with one atomic a nonzero entry
template <bool BILINEAR, bool U8, bool SHADING, bool STORED, bool SMOOTH, bool CAM, bool COLOR>
__device__ __forceinline__ void replay_tile(VOLYM_REPLAY_PARAMS) {
    extern __shared__ float smem[];
    float* s_lut = smem;
    float* s_dlut = smem + ln * 4;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int i = tid; i < ln * 4; i += nthreads) {
        s_lut[i] = lut[i];
        s_dlut[i] = 0.0f;
    }
    __syncthreads();

    const int x = blockIdx.x * TILE_X + threadIdx.x;
    const int y = blockIdx.y * TILE_Y + threadIdx.y;
    if (x < width && y < height) {
        const size_t n_rays = (size_t)height * width;
        const size_t r = (size_t)y * width + x;
        const float4 fo = reinterpret_cast<const float4*>(fin)[r];
        const float4 go = reinterpret_cast<const float4*>(gimg)[r];
        replay_ray<BILINEAR, U8, SHADING, STORED, SMOOTH, CAM, COLOR>(
            feats + r, vol, grad, s_lut, dens, fo, go, d_vol, d_grad, s_dlut, dd, steps, CAM ? d_feats + r : nullptr,
            gate, imp, n_rays, r, n, nr, nc, ln, sign, subtexel, threshold, early_alpha, tf_scale);
    }
    __syncthreads();
    for (int i = tid; i < ln * 4; i += nthreads) {
        const float v = s_dlut[i];
        if (v != 0.0f) atomicAdd(d_lut + i, v);
    }
}

// The blocks of 256 threads an SM must hold on the routes without the
// stencil, a bound on the registers: the gate (a pointer tested at every
// step, on every route) cost them 7 to 10 registers, and with them a block
// an SM (4 -> 3 unshaded at 64, 3 -> 2 shaded or with the camera chain at
// 85); the bound keeps the occupancy they had without it (a spill of at
// most 32 bytes).  0: no bound, the compiler's own choice, for the
// smoothed routes and the bilinear shaded camera chain, which hold 100 to
// 180 registers (a bound of one block made the compiler take more, and
// cost the smoothed routes 70%).
template <bool BILINEAR, bool SHADING, bool SMOOTH, bool CAM>
constexpr int replay_min_blocks() {
    return (SMOOTH || (CAM && BILINEAR && SHADING)) ? 0 : ((!SHADING && !CAM) ? 4 : 3);
}

template <bool BILINEAR, bool U8, bool SHADING, bool STORED, bool SMOOTH, bool CAM, bool COLOR>
__global__ void __launch_bounds__(TILE_X * TILE_Y) slab_replay_kernel(VOLYM_REPLAY_PARAMS) {
    replay_tile<BILINEAR, U8, SHADING, STORED, SMOOTH, CAM, COLOR>(VOLYM_REPLAY_ARGS);
}

template <bool BILINEAR, bool U8, bool SHADING, bool STORED, bool SMOOTH, bool CAM, bool COLOR, int MIN_BLOCKS>
__global__ void __launch_bounds__(TILE_X * TILE_Y, MIN_BLOCKS) slab_replay_kernel_bounded(VOLYM_REPLAY_PARAMS) {
    replay_tile<BILINEAR, U8, SHADING, STORED, SMOOTH, CAM, COLOR>(VOLYM_REPLAY_ARGS);
}

template <bool BILINEAR, bool U8, bool SHADING, bool STORED, bool SMOOTH, bool CAM, bool COLOR>
void launch(VOLYM_REPLAY_PARAMS, cudaStream_t stream) {
    const dim3 block(TILE_X, TILE_Y);
    const dim3 grid((width + TILE_X - 1) / TILE_X, (height + TILE_Y - 1) / TILE_Y);
    const size_t smem = (size_t)ln * 8 * sizeof(float);
    constexpr int MIN_BLOCKS = replay_min_blocks<BILINEAR, SHADING, SMOOTH, CAM>();
    if constexpr (MIN_BLOCKS > 0) {
        slab_replay_kernel_bounded<BILINEAR, U8, SHADING, STORED, SMOOTH, CAM, COLOR, MIN_BLOCKS>
            <<<grid, block, smem, stream>>>(VOLYM_REPLAY_ARGS);
    } else {
        slab_replay_kernel<BILINEAR, U8, SHADING, STORED, SMOOTH, CAM, COLOR><<<grid, block, smem, stream>>>(
            VOLYM_REPLAY_ARGS);
    }
}

#undef VOLYM_REPLAY_ARGS
#undef VOLYM_REPLAY_PARAMS

}  // namespace

// C entry for ctypes: launches on `stream` and returns cudaGetLastError().
// `grad` may be NULL when stored or unshaded, `dens` unless stored,
// `d_vol` and `d_grad` when smoothing without coloring (and `d_grad` unless
// shaded), `dd` and `steps` unless smoothing without coloring, `d_feats`
// unless `camera` (which takes neither `u8` nor `stored`), `gate` without
// look-ahead and `imp` unless `coloring` (which takes no `stored`; `d_vol`
// then receives d_imp).  The arguments that came with the gate and coloring
// follow `stream`, so that a build of an earlier source, whose entry ends
// there, takes the same call.
extern "C" int slab_replay_launch(const float* feats, const void* vol, const float* grad,
                                  const float* lut, const float* dens, const float* fin,
                                  const float* gimg, float* d_vol, float* d_grad, float* d_lut,
                                  float* dd, int* steps, float* d_feats, int height, int width, int n, int nr,
                                  int nc, int ln, int sign, int subtexel, int bilinear, int u8, int shading,
                                  int stored, int smooth, int camera, float threshold, float early_alpha,
                                  float tf_scale, void* stream, const uint32_t* gate, const float* imp,
                                  int coloring) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOLYM_LAUNCH_C(B, U, S, D, G, C, K)                                                                        \
    launch<B, U, S, D, G, C, K>(feats, vol, grad, lut, dens, fin, gimg, d_vol, d_grad, d_lut, dd, steps, d_feats, \
                                gate, imp, height, width, n, nr, nc, ln, sign, subtexel, threshold, early_alpha,   \
                                tf_scale, s)
#define VOLYM_LAUNCH(B, U, S, D, G) VOLYM_LAUNCH_C(B, U, S, D, G, false, false)
#define VOLYM_LAUNCH_K(B, U, S, G) VOLYM_LAUNCH_C(B, U, S, false, G, false, true)
#define VOLYM_LAUNCH_G(B, U, S, D)        \
    if (smooth) {                         \
        VOLYM_LAUNCH(B, U, S, D, true);   \
    } else {                              \
        VOLYM_LAUNCH(B, U, S, D, false);  \
    }
#define VOLYM_LAUNCH_D(B, U, S)           \
    if (coloring) {                       \
        if (smooth) {                     \
            VOLYM_LAUNCH_K(B, U, S, true);  \
        } else {                          \
            VOLYM_LAUNCH_K(B, U, S, false); \
        }                                 \
    } else if (stored) {                  \
        VOLYM_LAUNCH_G(B, U, S, true);    \
    } else {                              \
        VOLYM_LAUNCH_G(B, U, S, false);   \
    }
#define VOLYM_LAUNCH_CAM(B, S, G)                                      \
    if (coloring) {                                                    \
        VOLYM_LAUNCH_C(B, false, S, false, G, true, true);             \
    } else {                                                           \
        VOLYM_LAUNCH_C(B, false, S, false, G, true, false);            \
    }
    if (coloring && stored) return (int)cudaErrorInvalidValue;
    if (camera) {
        if (u8 || stored) return (int)cudaErrorInvalidValue;
        switch ((bilinear ? 4 : 0) | (shading ? 2 : 0) | (smooth ? 1 : 0)) {
            case 0: VOLYM_LAUNCH_CAM(false, false, false); break;
            case 1: VOLYM_LAUNCH_CAM(false, false, true); break;
            case 2: VOLYM_LAUNCH_CAM(false, true, false); break;
            case 3: VOLYM_LAUNCH_CAM(false, true, true); break;
            case 4: VOLYM_LAUNCH_CAM(true, false, false); break;
            case 5: VOLYM_LAUNCH_CAM(true, false, true); break;
            case 6: VOLYM_LAUNCH_CAM(true, true, false); break;
            default: VOLYM_LAUNCH_CAM(true, true, true); break;
        }
        return (int)cudaGetLastError();
    }
    const int variant = (bilinear ? 4 : 0) | (u8 ? 2 : 0) | (shading ? 1 : 0);
    switch (variant) {
        case 0: VOLYM_LAUNCH_D(false, false, false); break;
        case 1: VOLYM_LAUNCH_D(false, false, true); break;
        case 2: VOLYM_LAUNCH_D(false, true, false); break;
        case 3: VOLYM_LAUNCH_D(false, true, true); break;
        case 4: VOLYM_LAUNCH_D(true, false, false); break;
        case 5: VOLYM_LAUNCH_D(true, false, true); break;
        case 6: VOLYM_LAUNCH_D(true, true, false); break;
        default: VOLYM_LAUNCH_D(true, true, true); break;
    }
#undef VOLYM_LAUNCH_CAM
#undef VOLYM_LAUNCH_D
#undef VOLYM_LAUNCH_G
#undef VOLYM_LAUNCH_K
#undef VOLYM_LAUNCH
#undef VOLYM_LAUNCH_C
    return (int)cudaGetLastError();
}
