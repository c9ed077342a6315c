// Replay backward of the slab march for Hopper (sm_90a): one CUDA thread per
// ray, with the voxel scatter fused in.
//
// Replaces the TPU kernel volym_tpu/ops/slab_bwd_kernel.py::_replay_kernel
// (step body _replay_step_body) on its fused path, the one the training
// step runs: the stored-density or re-sampled replay with the voxel scatter
// fused (slab_bwd_kernel.py:792-815), in the base and Blinn-Phong shading
// modes, nearest or bilinear, f32 or u8 density stream, without camera
// cotangents.  The plain PyTorch version is
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
//     (4 taps) or box (1 tap) weights, into d_vol[k] with atomicAdd, and the
//     gradient-field cotangent into d_grad[c][k] when shaded;
//   - adds the TF cotangent into a per-block copy of d_lut in shared memory
//     (shared atomics, weights (1-fr, fr) on texels (i0, i1)), flushed with
//     one global atomicAdd per nonzero entry per block.
// The TF-coordinate derivative follows the TPU kernel: lut[i1] - lut[i0]
// inside a texel, exactly 0 at an integer coordinate, and dd is dropped
// where the raw coordinate is clamped.
//
// Bound: latency and atomics.  A step is a chain of dependent loads (the
// residual or the taps, then the LUT) as in the forward, and ends in 4 (or
// 16 when shaded) global float atomics into the permuted grid (64 MB f32 at
// 256^3, a little above the 50 MB L2) plus 8 shared atomics.  Neighbouring
// threads of a 16x16 tile hit neighbouring voxels, so the atomics of a warp
// spread over few cache lines; the LUT gradient, which every ray touches,
// stays in shared memory.  The summation order of d_vol and d_lut changes
// from run to run: the kernel is held to its plain version by tolerance.
//
// Numerics: built with --fmad=false like the forward.  The replayed
// accumulator must equal the forward's bit for bit, or the early-alpha mask
// of a later step flips.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "slab_common.cuh"

namespace {

using namespace volym_slab;

// Blinn-Phong constants (volym_tpu_torch/render/shading.py)
constexpr float AMBIENT = 0.2f, DIFFUSE = 0.7f, SPECULAR = 0.4f, SHININESS = 24.0f;
constexpr float INV_SQRT3 = 0.57735026f;

// transpose of sample<>: add v times the sample's weights into the slice
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
        const int r = clampi((int)floorf(rows + 0.5f), 0, nr - 1);
        const int c = clampi((int)floorf(cols + 0.5f), 0, nc - 1);
        atomicAdd(sl + r * nc + c, v);
    }
}

template <bool BILINEAR, bool U8, bool SHADING, bool STORED>
__device__ __forceinline__ void replay_ray(
    const float* __restrict__ f, const void* __restrict__ vol_, const float* __restrict__ grad,
    const float* __restrict__ s_lut, const float* __restrict__ dens, float4 fin, float4 g,
    float* __restrict__ d_vol, float* __restrict__ d_grad, float* __restrict__ s_dlut,
    size_t n_rays, size_t r, int n, int nr, int nc, int ln, int sign, int subtexel,
    float threshold, float early_alpha, float tf_scale) {
    using T = typename std::conditional<U8, uint8_t, float>::type;
    const T* __restrict__ vol = static_cast<const T*>(vol_);
    constexpr int DW = SHADING ? 4 : 1;

    const float entry = f[F_ENTRY * n_rays], exit_ = f[F_EXIT * n_rays];
    // a ray that misses the box or fails the sign flag composites nothing:
    // its cotangents are zero whatever fin and g hold there
    if (exit_ <= entry || !(f[F_SIGNOK * n_rays] > 0.5f)) return;
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
    for (int j = 0; j < n; ++j) {
        const float jf = (float)j;
        const float t = ts * jf + tb;
        if (t >= exit_ || acc_a >= early_alpha) break;
        if (!(t >= entry)) continue;
        const float rows = snap(clampf(rs * jf + rb, 0.0f, rmax), subtexel);
        const float cols = snap(clampf(cs * jf + cb, 0.0f, cmax), subtexel);
        const size_t k = (size_t)(sign > 0 ? j : n - 1 - j);
        const float* dj = STORED ? dens + (size_t)j * DW * n_rays + r : nullptr;
        const float density = STORED ? dj[0] : sample<BILINEAR>(vol + k * slice, rows, cols, nr, nc);
        if (!(density >= threshold)) continue;

        const float c_raw = density * tf_scale - 0.5f;
        const TfTexels tx = tf_texels(density, tf_scale, lmax, ln);
        const int i0 = tx.i0, i1 = tx.i1;
        const float fr = tx.fr, ufr = tx.ufr;
        const float tf_r = s_lut[i0 * 4 + 0] * ufr + s_lut[i1 * 4 + 0] * fr;
        const float tf_g = s_lut[i0 * 4 + 1] * ufr + s_lut[i1 * 4 + 1] * fr;
        const float tf_b = s_lut[i0 * 4 + 2] * ufr + s_lut[i1 * 4 + 2] * fr;
        const float tf_a = s_lut[i0 * 4 + 3] * ufr + s_lut[i1 * 4 + 3] * fr;
        float cr = tf_r, cg = tf_g, cbl = tf_b;

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
            const float d_gx = inv_norm * (d_nx - nx * n_dot_dn);
            const float d_gy = inv_norm * (d_ny - ny * n_dot_dn);
            const float d_gz = inv_norm * (d_nz - nz * n_dot_dn);
            scatter<BILINEAR>(d_grad + k * slice, rows, cols, nr, nc, d_gx);
            scatter<BILINEAR>(d_grad + ((size_t)n + k) * slice, rows, cols, nr, nc, d_gy);
            scatter<BILINEAR>(d_grad + ((size_t)2 * n + k) * slice, rows, cols, nr, nc, d_gz);
            d_r = d_r * lit;
            d_g = d_g * lit;
            d_b = d_b * lit;
        }

        // TF: d_lut on the two texels, dd through the texel slope
        const float d_rgba[4] = {d_r, d_g, d_b, d_a};
        float d_c = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
            atomicAdd(s_dlut + i0 * 4 + ch, d_rgba[ch] * ufr);
            atomicAdd(s_dlut + i1 * 4 + ch, d_rgba[ch] * fr);
            d_c = d_c + d_rgba[ch] * (s_lut[i1 * 4 + ch] - s_lut[i0 * 4 + ch]);
        }
        if (fr > 0.0f && c_raw > 0.0f && c_raw < lmax) {
            scatter<BILINEAR>(d_vol + k * slice, rows, cols, nr, nc, d_c * tf_scale);
        }
    }
}

template <bool BILINEAR, bool U8, bool SHADING, bool STORED>
__global__ void __launch_bounds__(TILE_X * TILE_Y) slab_replay_kernel(
    const float* __restrict__ feats,  // (N_FEATURES, H, W)
    const void* __restrict__ vol,     // (n, nr, nc) uint8 if U8 else float; unread when STORED
    const float* __restrict__ grad,   // (3, n, nr, nc) when SHADING and not STORED
    const float* __restrict__ lut,    // (ln, 4)
    const float* __restrict__ dens,   // (n, SHADING ? 4 : 1, H, W) when STORED
    const float* __restrict__ fin,    // (H, W, 4) the forward's image
    const float* __restrict__ gimg,   // (H, W, 4) its cotangent
    float* __restrict__ d_vol,        // (n, nr, nc), zero-filled
    float* __restrict__ d_grad,       // (3, n, nr, nc) when SHADING, zero-filled
    float* __restrict__ d_lut,        // (ln, 4), zero-filled
    int height, int width, int n, int nr, int nc, int ln, int sign, int subtexel,
    float threshold, float early_alpha, float tf_scale) {
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
        replay_ray<BILINEAR, U8, SHADING, STORED>(
            feats + r, vol, grad, s_lut, dens, fo, go, d_vol, d_grad, s_dlut, n_rays, r, n, nr, nc,
            ln, sign, subtexel, threshold, early_alpha, tf_scale);
    }
    __syncthreads();
    for (int i = tid; i < ln * 4; i += nthreads) {
        const float v = s_dlut[i];
        if (v != 0.0f) atomicAdd(d_lut + i, v);
    }
}

template <bool BILINEAR, bool U8, bool SHADING, bool STORED>
void launch(const float* feats, const void* vol, const float* grad, const float* lut,
            const float* dens, const float* fin, const float* gimg, float* d_vol, float* d_grad,
            float* d_lut, int height, int width, int n, int nr, int nc, int ln, int sign,
            int subtexel, float threshold, float early_alpha, float tf_scale, cudaStream_t stream) {
    const dim3 block(TILE_X, TILE_Y);
    const dim3 grid((width + TILE_X - 1) / TILE_X, (height + TILE_Y - 1) / TILE_Y);
    const size_t smem = (size_t)ln * 8 * sizeof(float);
    slab_replay_kernel<BILINEAR, U8, SHADING, STORED><<<grid, block, smem, stream>>>(
        feats, vol, grad, lut, dens, fin, gimg, d_vol, d_grad, d_lut, height, width, n, nr, nc, ln,
        sign, subtexel, threshold, early_alpha, tf_scale);
}

}  // namespace

// C entry for ctypes: launches on `stream` and returns cudaGetLastError().
// `grad` may be NULL when stored or unshaded, `dens` unless stored, and
// `d_grad` unless shaded.
extern "C" int slab_replay_launch(const float* feats, const void* vol, const float* grad,
                                  const float* lut, const float* dens, const float* fin,
                                  const float* gimg, float* d_vol, float* d_grad, float* d_lut,
                                  int height, int width, int n, int nr, int nc, int ln, int sign,
                                  int subtexel, int bilinear, int u8, int shading, int stored,
                                  float threshold, float early_alpha, float tf_scale,
                                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOLYM_LAUNCH(B, U, S, D)                                                              \
    launch<B, U, S, D>(feats, vol, grad, lut, dens, fin, gimg, d_vol, d_grad, d_lut, height, \
                       width, n, nr, nc, ln, sign, subtexel, threshold, early_alpha, tf_scale, s)
#define VOLYM_LAUNCH_D(B, U, S)        \
    if (stored) {                      \
        VOLYM_LAUNCH(B, U, S, true);   \
    } else {                           \
        VOLYM_LAUNCH(B, U, S, false);  \
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
#undef VOLYM_LAUNCH_D
#undef VOLYM_LAUNCH
    return (int)cudaGetLastError();
}
