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
// Bound: instructions.  A straight step is ~30 float operations and one
// gather where valid.  A cone step is the ray's range test and 8 probes,
// and a live ray sweeps every step, as the probes update ns outside the
// main ray's window.  Importance is sparse (the teapot's lobster has
// important texels in 52 of 256 slices, and they span 2.6% of such a
// slice's rows x columns on average), so the
// cone kernel first bounds, for each slice, the rows and columns its
// important texels span (important_bounds_kernel, one block a slice).  A
// step whose slice has none runs no probe (a branch the whole warp takes),
// and a probe a texel or more outside them takes no tap (its level is 0);
// the taps that remain are formed in integers (snapped_tap).  The main
// ray's own sample is read only where the bit is set.  A ray's eight
// directions stay on one thread: they are independent, so the thread has
// the parallelism, and the step's range test and bounds are formed once
// for all eight (spreading them over eight threads repeated that work in
// each and took twice the time).  Threads cover 16x16 pixel tiles, so that
// neighbouring threads gather neighbouring voxels.
//
// Numerics: built with --fmad=false, and sqrtf and '/' are correctly
// rounded without fast math, so norm_pos, m_end, j + d_range * rate and the
// snapped probe coordinates round as in PyTorch and on the TPU.

#include <cuda_runtime.h>
#include <limits.h>
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

// The nearest tap of a snapped coordinate c already clipped to [0, n_tex - 1]:
// nearest_index's floor(snap(c) + 0.5) in integers.  snap(c) is i / 2^bits
// with i = floor(c * 2^bits + 0.5) exact (c * 2^bits < 2^24), so
// floor(snap(c) + 0.5) = (i + 2^(bits-1)) >> bits, within [0, n_tex - 1].
__device__ __forceinline__ int snapped_tap(float c, int bits, int n_tex) {
    if (bits == 0) return clampi((int)floorf(c + 0.5f), 0, n_tex - 1);
    const int i = __float2int_rd(c * (float)(1 << bits) + 0.5f);
    return (i + (1 << (bits - 1))) >> bits;
}

// B7's first pass, one block a slice k: the rows and columns its important
// texels (level >= 1) span, bounds[k] = (row min, row max, column min,
// column max), or (INT_MAX, -1, INT_MAX, -1) when it has none
__global__ void __launch_bounds__(256) important_bounds_kernel(const uint8_t* __restrict__ levels, int nr, int nc,
                                                               int4* __restrict__ bounds) {
    __shared__ int s[4];
    if (threadIdx.x < 4) s[threadIdx.x] = (threadIdx.x & 1) ? -1 : INT_MAX;
    __syncthreads();
    const uint8_t* sl = levels + (size_t)blockIdx.x * nr * nc;
    int r0 = INT_MAX, r1 = -1, c0 = INT_MAX, c1 = -1;
    for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
        if (__ldg(sl + i) >= 1) {
            const int row = i / nc, col = i - row * nc;
            r0 = min(r0, row);
            r1 = max(r1, row);
            c0 = min(c0, col);
            c1 = max(c1, col);
        }
    }
    r0 = __reduce_min_sync(0xffffffffu, r0);
    r1 = __reduce_max_sync(0xffffffffu, r1);
    c0 = __reduce_min_sync(0xffffffffu, c0);
    c1 = __reduce_max_sync(0xffffffffu, c1);
    if ((threadIdx.x & 31) == 0) {
        atomicMin(s + 0, r0);
        atomicMax(s + 1, r1);
        atomicMin(s + 2, c0);
        atomicMax(s + 3, c1);
    }
    __syncthreads();
    if (threadIdx.x == 0) bounds[blockIdx.x] = make_int4(s[0], s[1], s[2], s[3]);
}

template <bool CONE>
__global__ void __launch_bounds__(TILE_X * TILE_Y) lookahead_kernel(
    const float* __restrict__ feats,   // (N_FEATURES, H, W)
    const float* __restrict__ cfeats,  // (CONE_SAMPLES * CF_STRIDE, H, W) when CONE
    const uint8_t* __restrict__ levels,  // (n, nr, nc)
    const int4* __restrict__ bounds,     // (n,) when CONE
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
            // outside the main ray's window; one a texel or more outside
            // its slice's important rows and columns reads level 0
            const int4 bd = __ldg(bounds + (sign > 0 ? j : n - 1 - j));
            if (bd.x <= bd.y) {
                const float br0 = (float)bd.x - 1.0f, br1 = (float)bd.y + 1.0f;
                const float bc0 = (float)bd.z - 1.0f, bc1 = (float)bd.w + 1.0f;
#pragma unroll
                for (int c = 0; c < CONE_SAMPLES; ++c) {
                    const float rows_u = crs[c] * jf + crb[c];
                    const float cols_u = ccs[c] * jf + ccb[c];
                    const float t_c = cts[c] * jf + ctb[c];
                    if (rows_u >= -0.5f && rows_u <= rhi && cols_u >= -0.5f && cols_u <= chi && t_c > 0.0f &&
                        rows_u >= br0 && rows_u <= br1 && cols_u >= bc0 && cols_u <= bc1) {
                        const int rr = snapped_tap(clampf(rows_u, 0.0f, rmax), subtexel, nr);
                        const int cc = snapped_tap(clampf(cols_u, 0.0f, cmax), subtexel, nc);
                        if (__ldg(sl + (size_t)rr * nc + cc) >= 1) ns[c] = jf;
                    }
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

// C entry for ctypes: launches the cone kernel (after its bounds pass into
// `scratch`) when `cone_feats` is not NULL, else the straight one, on
// `stream`; returns cudaGetLastError().
extern "C" int lookahead_launch(const float* feats, const float* cone_feats, const uint8_t* levels,
                                uint32_t* gate, int height, int width, int n, int nr, int nc, int sign,
                                int subtexel, void* stream, int* scratch) {
    const dim3 block(TILE_X, TILE_Y);
    const dim3 grid((width + TILE_X - 1) / TILE_X, (height + TILE_Y - 1) / TILE_Y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cone_feats != nullptr) {
        // the first pass, into `scratch` (n x 4 int32): each slice's
        // important rows and columns
        int4* bounds = reinterpret_cast<int4*>(scratch);
        important_bounds_kernel<<<n, 256, 0, s>>>(levels, nr, nc, bounds);
        lookahead_kernel<true><<<grid, block, 0, s>>>(feats, cone_feats, levels, bounds, gate, height, width, n, nr,
                                                      nc, sign, subtexel);
    } else {
        lookahead_kernel<false><<<grid, block, 0, s>>>(feats, nullptr, levels, nullptr, gate, height, width, n, nr,
                                                       nc, sign, subtexel);
    }
    return (int)cudaGetLastError();
}

// C entry for ctypes: the cone kernel's resident blocks per SM and threads
// a block (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1
extern "C" int lookahead_cone_occupancy(int* threads_per_block) {
    int blocks = 0;
    *threads_per_block = TILE_X * TILE_Y;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lookahead_kernel<true>, TILE_X * TILE_Y, 0) !=
        cudaSuccess) {
        return -1;
    }
    return blocks;
}
