// Voxel-gradient scatters for Hopper (sm_90a): one CUDA thread per
// (march step, ray).
//
// Replaces the TPU kernels volym_tpu/ops/slab_bwd_kernel.py::
// _voxel_grad_kernel (B3: d_vol from a 1-channel cotangent) and
// _voxel_grad_shaded_kernel (B4: d_vol and the 3-channel d_grad from a
// 4-channel one), the unfused backward's pass 2, which the training step
// runs under Gaussian smoothing after the replay (slab_replay.cu, SMOOTH)
// and the stencil's transpose.  The plain PyTorch version is
// volym_tpu_torch/render/slab.py::voxel_grad.
//
// For march step j and ray r the kernel adds dd[j, c, r] times the hats of
// the step's own sample into plane k(j) of its grid: the coordinates of
// _coords (rs*j+rb, cs*j+cb, clipped, snapped to 2^-subtexel), bilinear
// (4 taps) or box (1 tap) weights, the transpose of sample<> (scatter<> in
// slab_common.cuh, shared with the replay's fused scatter).  The TPU builds
// (rows x rays) and (cols x rays) hat matrices per slab block and contracts
// them on the MXU; here each thread adds its 4 (or 16 when shaded) weighted
// values with global float atomics.
//
// Bound: the bytes of dd.  At 1024x768 x 256 planes dd is 805 MB (3.2 GB
// with 4 channels), read once with rays fastest, so a warp's loads at one
// step are coalesced; most entries are zero (a ray composites a few dozen
// steps, and only those carry a cotangent), and their threads read the
// step's dd and exit.  The atomics of a 16x16 tile land on neighbouring
// voxels of one plane.  The summation order changes from run to run: the
// kernel is held to its plain version by tolerance.  Numerics as the
// march: built with --fmad=false, so the coordinates and the snap round
// exactly as PyTorch's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slab_common.cuh"

namespace {

using namespace volym_slab;

template <bool BILINEAR, bool SHADED>
__global__ void __launch_bounds__(TILE_X * TILE_Y) voxel_grad_kernel(
    const float* __restrict__ feats,  // (N_FEATURES, H, W)
    const float* __restrict__ dd,     // (n, SHADED ? 4 : 1, H, W) in march order j
    float* __restrict__ d_vol,        // (n, nr, nc), zero-filled
    float* __restrict__ d_grad,       // (3, n, nr, nc) when SHADED, zero-filled
    int height, int width, int n, int nr, int nc, int sign, int subtexel) {
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

template <bool BILINEAR, bool SHADED>
void launch(const float* feats, const float* dd, float* d_vol, float* d_grad, int height, int width, int n, int nr,
            int nc, int sign, int subtexel, cudaStream_t stream) {
    const dim3 block(TILE_X, TILE_Y);
    const dim3 grid((width + TILE_X - 1) / TILE_X, (height + TILE_Y - 1) / TILE_Y, n);
    voxel_grad_kernel<BILINEAR, SHADED><<<grid, block, 0, stream>>>(feats, dd, d_vol, d_grad, height, width, n, nr,
                                                                   nc, sign, subtexel);
}

}  // namespace

// C entry for ctypes: launches on `stream` and returns cudaGetLastError().
// `d_grad` is NULL unless `shaded`.
extern "C" int voxel_grad_launch(const float* feats, const float* dd, float* d_vol, float* d_grad, int height,
                                 int width, int n, int nr, int nc, int sign, int subtexel, int bilinear, int shaded,
                                 void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 1 || n > 65535) return (int)cudaErrorInvalidValue;  // the grid's z extent
    const int variant = (bilinear ? 2 : 0) | (shaded ? 1 : 0);
    switch (variant) {
        case 0: launch<false, false>(feats, dd, d_vol, d_grad, height, width, n, nr, nc, sign, subtexel, s); break;
        case 1: launch<false, true>(feats, dd, d_vol, d_grad, height, width, n, nr, nc, sign, subtexel, s); break;
        case 2: launch<true, false>(feats, dd, d_vol, d_grad, height, width, n, nr, nc, sign, subtexel, s); break;
        default: launch<true, true>(feats, dd, d_vol, d_grad, height, width, n, nr, nc, sign, subtexel, s); break;
    }
    return (int)cudaGetLastError();
}
