// Importance look-ahead gate for Hopper (sm_90a): one CUDA thread per ray.
//
// Replaces the TPU kernels volym_tpu/ops/lookahead_kernel.py::_straight_kernel
// (B6, step _straight_step) and ::_cone_kernel (B7, step _cone_step), which
// lookahead_call launches.  The plain PyTorch version is
// volym_tpu_torch/render/slab.py::lookahead_gate; every expression below is
// written in its order, which is the TPU kernels' order.
//
// Each thread marches its ray's steps in reverse, j = n-1 .. 0, and carries
// ns, the march index of the next important crossing ahead (float32, FAR
// when none): one along the ray itself (straight) or one per cone direction
// (cone).  Step j's gate bit is
//   valid (sign flag, entry <= t < exit)
//   AND an important crossing lies ahead within the probe range
//   AND the ray's own nearest sample at j is not opaque (level < 2),
// the probe range ending at exit - |pos| (the reference's quirk; |pos| is
// norm_pos below).  Then ns takes j where the step's nearest sample is
// important (level >= 1): the ray's own sample where valid (straight), or
// each cone direction's sample inside the box and ahead of the camera
// (cone; at every step, whatever the main ray's window).  A ray whose sign
// flag is clear or that misses the box has no valid step: its bits are 0.
//
// Input: the uint8 level grid (n, nr, nc), level = (imp >= 0.5) +
// (imp >= 1.0), resampled nearest to the march's planes (16 MB at 256^3,
// resident in the 50 MB L2).  Output: the packed gate, (ceil(n/32), H, W)
// uint32 words, bit j % 32 of word j / 32, rays fastest.  A thread builds
// each word in a register and stores it once, so nothing is zero-filled and
// nothing is atomic; the march (slab_march.cu) loads one word per 32 steps.
//
// Bound: operations, then latency.  A straight step is ~30 float operations
// and one gather where valid; a cone step is 9 such chains (8 probes and the
// main ray) with up to 9 gathers.  Threads cover 16x16 pixel tiles, so that
// neighbouring threads gather neighbouring voxels.  The TPU machinery (the
// occupancy meta, the inverted grid, ternary bf16 slices, 8-columns-a-word
// bit planes, row windows) is not carried over: a thread reads the voxel it
// needs.
//
// Numerics: built with --fmad=false, and sqrtf and '/' are correctly
// rounded without fast math, so norm_pos, m_end, j + d_range * rate and the
// snapped probe coordinates round as in PyTorch and on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slab_common.cuh"

namespace {

using namespace volym_slab;

constexpr float FAR = 1e9f;  // no important crossing ahead (slab.py FAR)

// |pos| at t along the ray, from |cam|^2 and cam.dir: the probe range's end
// is exit - norm_pos
__device__ __forceinline__ float norm_pos(float c2, float cd, float t) {
    return sqrtf(fmaxf(c2 + 2.0f * t * cd + t * t, 0.0f));
}

// append step j's bit to the word being built; store the word when j is the
// lowest step it holds
__device__ __forceinline__ void emit(uint32_t* __restrict__ g, size_t n_rays, int j, bool bit, uint32_t& word) {
    word |= (uint32_t)bit << (j & 31);
    if ((j & 31) == 0) {
        g[(size_t)(j >> 5) * n_rays] = word;
        word = 0u;
    }
}

template <bool CONE>
__global__ void __launch_bounds__(TILE_X * TILE_Y) lookahead_kernel(
    const float* __restrict__ feats,   // (N_FEATURES, H, W)
    const float* __restrict__ cfeats,  // (CONE_SAMPLES * CF_STRIDE, H, W) when CONE
    const uint8_t* __restrict__ levels,  // (n, nr, nc)
    uint32_t* __restrict__ gate,       // (ceil(n / 32), H, W)
    int height, int width, int n, int nr, int nc, int sign, int subtexel) {
    const int x = blockIdx.x * TILE_X + threadIdx.x;
    const int y = blockIdx.y * TILE_Y + threadIdx.y;
    if (x >= width || y >= height) return;
    const size_t n_rays = (size_t)height * width;
    const size_t r = (size_t)y * width + x;
    const float* f = feats + r;
    uint32_t* g = gate + r;

    const float entry = f[F_ENTRY * n_rays], exit_ = f[F_EXIT * n_rays];
    if (!(f[F_SIGNOK * n_rays] > 0.5f) || exit_ <= entry) {
        for (int w = 0; w < (n + 31) / 32; ++w) g[(size_t)w * n_rays] = 0u;
        return;
    }
    const float rs = f[F_RS * n_rays], rb = f[F_RB * n_rays];
    const float cs = f[F_CS * n_rays], cb = f[F_CB * n_rays];
    const float ts = f[F_TS * n_rays], tb = f[F_TB * n_rays];
    const float cd = f[F_CD * n_rays], c2 = f[F_C2 * n_rays];
    const size_t slice = (size_t)nr * nc;
    const float rmax = (float)(nr - 1), cmax = (float)(nc - 1);
    const float rhi = (float)nr - 0.5f, chi = (float)nc - 0.5f;

    // the cone directions' coefficients and next-important indices
    float crs[CONE ? CONE_SAMPLES : 1], crb[CONE ? CONE_SAMPLES : 1], ccs[CONE ? CONE_SAMPLES : 1];
    float ccb[CONE ? CONE_SAMPLES : 1], cts[CONE ? CONE_SAMPLES : 1], ctb[CONE ? CONE_SAMPLES : 1];
    float rate[CONE ? CONE_SAMPLES : 1], ns[CONE ? CONE_SAMPLES : 1];
#pragma unroll
    for (int c = 0; c < (CONE ? CONE_SAMPLES : 1); ++c) {
        ns[c] = FAR;
        if (CONE) {
            const float* cf = cfeats + (size_t)c * CF_STRIDE * n_rays + r;
            crs[c] = cf[CF_RS * n_rays];
            crb[c] = cf[CF_RB * n_rays];
            ccs[c] = cf[CF_CS * n_rays];
            ccb[c] = cf[CF_CB * n_rays];
            cts[c] = cf[CF_TS * n_rays];
            ctb[c] = cf[CF_TB * n_rays];
            rate[c] = cf[CF_RATE * n_rays];
        }
    }

    uint32_t word = 0u;
    for (int j = n - 1; j >= 0; --j) {
        const float jf = (float)j;
        const float t = ts * jf + tb;
        const bool valid = t >= entry && t < exit_;
        const uint8_t* sl = levels + (size_t)(sign > 0 ? j : n - 1 - j) * slice;
        bool bit = false;
        if (valid) {
            const float d_range = exit_ - norm_pos(c2, cd, t);
            if (CONE) {
#pragma unroll
                for (int c = 0; c < CONE_SAMPLES; ++c) bit |= ns[c] <= jf + d_range * rate[c] && rate[c] > 0.0f;
            } else {
                bit = ns[0] <= jf + d_range / ts;
            }
        }
        if (CONE) {
            // the probes update ns at every step: a probe crossing may lie
            // outside the main ray's window
#pragma unroll
            for (int c = 0; c < CONE_SAMPLES; ++c) {
                const float rows_u = crs[c] * jf + crb[c];
                const float cols_u = ccs[c] * jf + ccb[c];
                const float t_c = cts[c] * jf + ctb[c];
                if (rows_u >= -0.5f && rows_u <= rhi && cols_u >= -0.5f && cols_u <= chi && t_c > 0.0f) {
                    const float rows = snap(clampf(rows_u, 0.0f, rmax), subtexel);
                    const float cols = snap(clampf(cols_u, 0.0f, cmax), subtexel);
                    if (__ldg(sl + nearest_index(rows, cols, nr, nc)) >= 1) ns[c] = jf;
                }
            }
        }
        if (valid && (bit || !CONE)) {
            // the ray's own sample, snapped like the march's: it clears the
            // bit where opaque and, straight, sets ns where important
            const float rows = snap(clampf(rs * jf + rb, 0.0f, rmax), subtexel);
            const float cols = snap(clampf(cs * jf + cb, 0.0f, cmax), subtexel);
            const uint8_t level = __ldg(sl + nearest_index(rows, cols, nr, nc));
            bit = bit && level < 2;
            if (!CONE && level >= 1) ns[0] = jf;
        }
        emit(g, n_rays, j, bit, word);
    }
}

}  // namespace

// C entry for ctypes: launches the cone kernel when `cone_feats` is not
// NULL, else the straight one, on `stream`; returns cudaGetLastError().
extern "C" int lookahead_launch(const float* feats, const float* cone_feats, const uint8_t* levels,
                                uint32_t* gate, int height, int width, int n, int nr, int nc, int sign,
                                int subtexel, void* stream) {
    const dim3 block(TILE_X, TILE_Y);
    const dim3 grid((width + TILE_X - 1) / TILE_X, (height + TILE_Y - 1) / TILE_Y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cone_feats != nullptr) {
        lookahead_kernel<true><<<grid, block, 0, s>>>(feats, cone_feats, levels, gate, height, width, n, nr, nc,
                                                      sign, subtexel);
    } else {
        lookahead_kernel<false><<<grid, block, 0, s>>>(feats, nullptr, levels, gate, height, width, n, nr, nc,
                                                       sign, subtexel);
    }
    return (int)cudaGetLastError();
}
