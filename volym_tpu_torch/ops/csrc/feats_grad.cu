// The plain density rows' camera chain for Hopper (sm_90a): one CUDA thread
// per ray.
//
// Replaces the TPU kernel volym_tpu/ops/slab_bwd_kernel.py::
// _feats_grad_kernel (B5, pass 2b, driven by _run_feats_grad), which the
// training step runs under Gaussian smoothing with camera gradients and
// bilinear sampling, after the replay (slab_replay.cu, SMOOTH and CAM) and
// the stencil's transpose.  The plain PyTorch version is
// volym_tpu_torch/render/slab.py::feats_grad.
//
// A smoothed step's density mixes the plain rows of later steps, so the
// coordinate chain of each plain row exists only once the whole replay and
// the transpose have run.  For ray r the kernel walks the march steps j in
// order and, where the plain-row cotangent dd[j, r] is nonzero, takes the
// coordinate derivative of the step's own plain sample (dsample in
// slab_common.cuh: the 4 taps of the f32 slice k(j) at the step's snapped
// coordinates, texels nr and nc absent), masks it where the raw coordinate
// is clipped, and accumulates d_rows * j, d_rows, d_cols * j and d_cols in
// registers; at the end it writes the four rows F_RS/F_RB/F_CS/F_CB of
// d_feats once.  The TPU contracts a hat and a hat-derivative matrix per
// step on the MXU over an inverted grid with an aliased accumulator; one
// thread per ray needs neither.
//
// Bound: the bytes of dd.  At 1024x768 x 256 planes dd is 805 MB, read once
// with rays fastest (a warp's loads at one step are coalesced, at the
// view's step stride when dd is one channel of a 4-channel tensor); most
// entries are zero, and the few dozen nonzero steps of a ray each load 4
// texels of the 67 MB f32 volume, which L2 mostly holds.  Numerics as the
// march: built with --fmad=false, so the coordinates, the snap and the
// masks round as PyTorch's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slab_common.cuh"

namespace {

using namespace volym_slab;

__global__ void __launch_bounds__(TILE_X * TILE_Y) feats_grad_kernel(
    const float* __restrict__ feats,  // (N_FEATURES, H, W)
    const float* __restrict__ vol,    // (n, nr, nc) f32, the volume as marched
    const float* __restrict__ dd,     // plain-row cotangent of step j at dd[j * dd_step + ray]
    float* __restrict__ d_feats,      // (N_FEATURES, H, W), zero-filled; rows 0..3 written here
    int height, int width, int n, int nr, int nc, int sign, int subtexel, long long dd_step) {
    const int x = blockIdx.x * TILE_X + threadIdx.x;
    const int y = blockIdx.y * TILE_Y + threadIdx.y;
    if (x >= width || y >= height) return;
    const size_t n_rays = (size_t)height * width;
    const size_t r = (size_t)y * width + x;
    const float* f = feats + r;
    const float rs = f[F_RS * n_rays], rb = f[F_RB * n_rays];
    const float cs = f[F_CS * n_rays], cb = f[F_CB * n_rays];
    const float rmax = (float)(nr - 1), cmax = (float)(nc - 1);
    const size_t slice = (size_t)nr * nc;
    const float* dr = dd + r;
    float a_rs = 0.0f, a_rb = 0.0f, a_cs = 0.0f, a_cb = 0.0f;
    for (int j = 0; j < n; ++j) {
        const float v = __ldg(dr + (size_t)j * (size_t)dd_step);
        if (v == 0.0f) continue;
        const float jf = (float)j;
        const float rows_raw = rs * jf + rb, cols_raw = cs * jf + cb;
        const float rows = snap(clampf(rows_raw, 0.0f, rmax), subtexel);
        const float cols = snap(clampf(cols_raw, 0.0f, cmax), subtexel);
        const size_t k = (size_t)(sign > 0 ? j : n - 1 - j);
        const float2 ds = dsample(vol + k * slice, rows, cols, nr, nc);
        const float d_rows = (rows_raw > 0.0f && rows_raw < rmax) ? v * ds.x : 0.0f;
        const float d_cols = (cols_raw > 0.0f && cols_raw < cmax) ? v * ds.y : 0.0f;
        a_rs = a_rs + d_rows * jf;
        a_rb = a_rb + d_rows;
        a_cs = a_cs + d_cols * jf;
        a_cb = a_cb + d_cols;
    }
    float* df = d_feats + r;
    df[F_RS * n_rays] = a_rs;
    df[F_RB * n_rays] = a_rb;
    df[F_CS * n_rays] = a_cs;
    df[F_CB * n_rays] = a_cb;
}

}  // namespace

// C entry for ctypes: launches on `stream` and returns cudaGetLastError().
extern "C" int feats_grad_launch(const float* feats, const float* vol, const float* dd, float* d_feats, int height,
                                 int width, int n, int nr, int nc, int sign, int subtexel, long long dd_step,
                                 void* stream) {
    const dim3 block(TILE_X, TILE_Y);
    const dim3 grid((width + TILE_X - 1) / TILE_X, (height + TILE_Y - 1) / TILE_Y);
    feats_grad_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        feats, vol, dd, d_feats, height, width, n, nr, nc, sign, subtexel, dd_step);
    return (int)cudaGetLastError();
}
