// Forward slab march for Hopper (sm_90a): one CUDA thread per ray.
//
// Replaces the TPU kernel volym_tpu/ops/slab_kernel.py::_march_kernel (step
// body _march_step_body, TF lookup _tf_lookup) in its base and Blinn-Phong
// shading modes, with nearest or bilinear sampling and the f32 or u8 density
// stream.  The TPU kernel turns every texel gather into hat-matrix products
// on the MXU; here each thread reads its texels directly.  The plain PyTorch
// version is volym_tpu_torch/render/slab.py::march_slabs, which evaluates
// every per-sample expression in the order written below.
//
// Bound: latency.  A step is four or more dependent gathers (bilinear taps,
// then the TF lookup, then the gradient-field taps when shaded), and a warp
// waits on each.  Threads cover 16x16 pixel tiles so that neighbouring
// threads read neighbouring texels of the same slice: the 16 MB u8 volume
// (64 MB f32) stays mostly in the 50 MB L2.  The LUT lives in shared memory.
// Staging slabs through shared memory or TMA is left to later work.
//
// Numerics.  Build with --fmad=false: the affine coordinates rs*j+rb, the
// subtexel snap and t = ts*j+tb must round after the product as PyTorch does,
// or a one-ulp difference flips floor(c*256+0.5) at half-texel boundaries
// and the threshold and t-window masks with it.  No fast math: expf, logf,
// powf and sqrtf stay the accurate library versions PyTorch also calls.
//
// Early exit: t = ts*j+tb is non-decreasing in j when the sign flag holds
// (ts > 0), and the accumulated alpha never decreases, so breaking on
// t >= exit or on alpha >= early_alpha skips only samples the mask rejects.
//
// Stored-density residual (EMIT, the TPU kernel's emit_density): the kernel
// also writes, for the replay backward (slab_replay.cu), the density of
// every step it samples into dens (n, 1, H, W), or (n, 4, H, W) with the
// gradient-field sample in rows 1..3 when shaded (written only where the
// density passes the threshold: the field is sampled only there).  Rays
// fastest, so a warp's stores at one step are coalesced.  Every step the
// kernel does not sample must read 0.0; the kernel does not write those,
// the wrapper zero-fills the buffer (torch.zeros, one memset at full
// bandwidth) before the launch.
//
// Look-ahead gate (the TPU kernel's `ahead` input): with a gate, the packed
// bits of lookahead.cu, a step whose bit is set adds nothing, as if its
// density were below the threshold (_march_step_body's `m & ~ahead`); it is
// not sampled at all.  The word of steps j..j+31 is loaded at step j = 0
// mod 32.  Without a gate (NULL) the word stays 0.  The t >= exit and
// alpha >= early_alpha breaks are unchanged: a gated step adds no alpha.
// The wrapper refuses a gate together with EMIT, whose residual belongs to
// the look-ahead's backward.
//
// Gaussian smoothing (SMOOTH, the TPU kernel's smoothing block
// slab_kernel.py:216-261): the step's density is the smoothed one, a
// 7-row stencil along the slab axis over the plain density rows j-3..j+3
// (smooth_density in slab_common.cuh).  The TPU kernel samples the rows of
// a whole slab batch plus its halo from the previous and next slice
// blocks; here each thread keeps a sliding window of 7 plain samples in
// registers (SmoothWindow), primed at the first step the ray reaches and
// then one new sample a step, three steps ahead of the composited one.
// The rows are sampled at the steps' clipped coordinates whatever the
// t-window, and rows beyond the sweep clamp to its end rows, as in the
// plain version.  The smoothed density takes the place of the sample in
// the threshold mask, the TF lookup and the residual's row 0; the gradient
// field is still sampled at the step's own coordinates.  A gated step
// still advances the window.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "slab_common.cuh"

namespace {

using namespace volym_slab;

template <bool BILINEAR, bool U8, bool SHADING, bool EMIT, bool SMOOTH>
__global__ void __launch_bounds__(TILE_X * TILE_Y) slab_march_kernel(
    const float* __restrict__ feats,  // (N_FEATURES, H, W)
    const void* __restrict__ vol_,    // (n, nr, nc) uint8 if U8 else float
    const float* __restrict__ grad,   // (3, n, nr, nc) when SHADING
    const float* __restrict__ lut,    // (ln, 4)
    float* __restrict__ out,          // (H, W, 4)
    float* __restrict__ dens,         // (n, SHADING ? 4 : 1, H, W) when EMIT, zero-filled
    const uint32_t* __restrict__ gate,  // (ceil(n / 32), H, W) packed gate bits, or NULL
    int height, int width, int n, int nr, int nc, int ln, int sign, int subtexel,
    float threshold, float early_alpha, float tf_scale) {
    using T = typename std::conditional<U8, uint8_t, float>::type;
    const T* __restrict__ vol = static_cast<const T*>(vol_);

    extern __shared__ float s_lut[];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int i = tid; i < ln * 4; i += blockDim.x * blockDim.y) s_lut[i] = lut[i];
    __syncthreads();

    const int x = blockIdx.x * TILE_X + threadIdx.x;
    const int y = blockIdx.y * TILE_Y + threadIdx.y;
    if (x >= width || y >= height) return;
    const size_t n_rays = (size_t)height * width;
    const size_t r = (size_t)y * width + x;
    const float* f = feats + r;

    const float entry = f[F_ENTRY * n_rays], exit_ = f[F_EXIT * n_rays];
    float4* o = reinterpret_cast<float4*>(out) + r;
    if (exit_ <= entry) {  // the ray misses the box
        *o = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
        return;
    }
    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
    if (f[F_SIGNOK * n_rays] > 0.5f) {
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
        uint32_t word = 0u;
        SmoothWindow<BILINEAR, T> win;
        for (int j = 0; j < n; ++j) {
            const float jf = (float)j;
            const float t = ts * jf + tb;
            if (t >= exit_ || acc_a >= early_alpha) break;
            if (gate != nullptr && (j & 31) == 0) word = __ldg(gate + (size_t)(j >> 5) * n_rays + r);
            if (!(t >= entry)) continue;
            if (SMOOTH) win.advance(vol, j, rs, rb, cs, cb, n, nr, nc, sign, subtexel);
            if ((word >> (j & 31)) & 1u) continue;
            const float rows = snap(clampf(rs * jf + rb, 0.0f, rmax), subtexel);
            const float cols = snap(clampf(cs * jf + cb, 0.0f, cmax), subtexel);
            const size_t k = (size_t)(sign > 0 ? j : n - 1 - j);
            const float density = SMOOTH ? smooth_density<BILINEAR>(win.d, j, rs, rb, cs, cb, ts, n, nr, nc)
                                         : sample<BILINEAR>(vol + k * slice, rows, cols, nr, nc);
            float* dj = EMIT ? dens + (size_t)j * (SHADING ? 4 : 1) * n_rays + r : nullptr;
            if (EMIT) dj[0] = density;
            if (!(density >= threshold)) continue;

            // TF: linear filter, texel centres at (i + 0.5) / ln, clamp-to-edge
            const TfTexels tx = tf_texels(density, tf_scale, lmax, ln);
            const int i0 = tx.i0, i1 = tx.i1;
            const float fr = tx.fr, ufr = tx.ufr;
            float cr = s_lut[i0 * 4 + 0] * ufr + s_lut[i1 * 4 + 0] * fr;
            float cg = s_lut[i0 * 4 + 1] * ufr + s_lut[i1 * 4 + 1] * fr;
            float cbl = s_lut[i0 * 4 + 2] * ufr + s_lut[i1 * 4 + 2] * fr;
            const float ca = s_lut[i0 * 4 + 3] * ufr + s_lut[i1 * 4 + 3] * fr;

            if (SHADING) {
                // Blinn-Phong from the precomputed gradient field (wgsl:190-211)
                const float gx = sample<BILINEAR>(grad + k * slice, rows, cols, nr, nc);
                const float gy = sample<BILINEAR>(grad + ((size_t)n + k) * slice, rows, cols, nr, nc);
                const float gz = sample<BILINEAR>(grad + ((size_t)2 * n + k) * slice, rows, cols, nr, nc);
                if (EMIT) {
                    dj[n_rays] = gx;
                    dj[2 * n_rays] = gy;
                    dj[3 * n_rays] = gz;
                }
                const float sq = gx * gx + gy * gy + gz * gz;
                if (sq > 0.0f) {
                    const float norm = sqrtf(sq);
                    const float nx = gx / norm, ny = gy / norm, nz = gz / norm;
                    const float diffuse = fmaxf((nx + ny + nz) * 0.57735026f, 0.0f);
                    const float hdotn = hx * nx + hy * ny + hz * nz;
                    const float spec = powf(fmaxf(hdotn, 0.0f), 24.0f);
                    const float lit = 0.2f + 0.7f * diffuse;
                    const float sp = 0.4f * spec;
                    cr = cr * lit + sp;
                    cg = cg * lit + sp;
                    cbl = cbl * lit + sp;
                }
            }

            const float alpha = 1.0f - expf(aexp * logf(fmaxf(1.0f - ca, 1e-37f)));
            const float w = (1.0f - acc_a) * alpha;
            acc_r = acc_r + cr * w;
            acc_g = acc_g + cg * w;
            acc_b = acc_b + cbl * w;
            acc_a = acc_a + w;
        }
    }
    *o = make_float4(acc_r, acc_g, acc_b, acc_a);
}

template <bool BILINEAR, bool U8, bool SHADING, bool EMIT, bool SMOOTH>
void launch(const float* feats, const void* vol, const float* grad, const float* lut, float* out,
            float* dens, const uint32_t* gate, int height, int width, int n, int nr, int nc, int ln, int sign,
            int subtexel, float threshold, float early_alpha, float tf_scale, cudaStream_t stream) {
    const dim3 block(TILE_X, TILE_Y);
    const dim3 grid((width + TILE_X - 1) / TILE_X, (height + TILE_Y - 1) / TILE_Y);
    const size_t smem = (size_t)ln * 4 * sizeof(float);
    slab_march_kernel<BILINEAR, U8, SHADING, EMIT, SMOOTH><<<grid, block, smem, stream>>>(
        feats, vol, grad, lut, out, dens, gate, height, width, n, nr, nc, ln, sign, subtexel,
        threshold, early_alpha, tf_scale);
}

}  // namespace

// C entry for ctypes: launches on `stream` and returns cudaGetLastError().
// `dens` is NULL unless `emit` is set; `gate` is NULL without look-ahead.
extern "C" int slab_march_launch(const float* feats, const void* vol, const float* grad,
                                 const float* lut, float* out, float* dens, const uint32_t* gate,
                                 int height, int width,
                                 int n, int nr, int nc, int ln, int sign, int subtexel,
                                 int bilinear, int u8, int shading, int emit, int smooth, float threshold,
                                 float early_alpha, float tf_scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOLYM_LAUNCH(B, U, S, E, G)                                                            \
    launch<B, U, S, E, G>(feats, vol, grad, lut, out, dens, gate, height, width, n, nr, nc, ln, sign, \
                          subtexel, threshold, early_alpha, tf_scale, s)
#define VOLYM_LAUNCH_G(B, U, S, E)         \
    if (smooth) {                          \
        VOLYM_LAUNCH(B, U, S, E, true);    \
    } else {                               \
        VOLYM_LAUNCH(B, U, S, E, false);   \
    }
#define VOLYM_LAUNCH_E(B, U, S)            \
    if (emit) {                            \
        VOLYM_LAUNCH_G(B, U, S, true);     \
    } else {                               \
        VOLYM_LAUNCH_G(B, U, S, false);    \
    }
    const int variant = (bilinear ? 4 : 0) | (u8 ? 2 : 0) | (shading ? 1 : 0);
    switch (variant) {
        case 0: VOLYM_LAUNCH_E(false, false, false); break;
        case 1: VOLYM_LAUNCH_E(false, false, true); break;
        case 2: VOLYM_LAUNCH_E(false, true, false); break;
        case 3: VOLYM_LAUNCH_E(false, true, true); break;
        case 4: VOLYM_LAUNCH_E(true, false, false); break;
        case 5: VOLYM_LAUNCH_E(true, false, true); break;
        case 6: VOLYM_LAUNCH_E(true, true, false); break;
        default: VOLYM_LAUNCH_E(true, true, true); break;
    }
#undef VOLYM_LAUNCH_E
#undef VOLYM_LAUNCH_G
#undef VOLYM_LAUNCH
    return (int)cudaGetLastError();
}
