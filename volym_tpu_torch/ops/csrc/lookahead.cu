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
// Bound: instructions (one thread issues ~40 a step when it does every
// test).  Importance is sparse (the teapot's lobster has important texels
// in 52 of 256 slices, and they span 2.6% of such a slice's rows x columns
// on average), so both kernels run after a first pass that bounds, for
// each slice, the rows and columns its important texels span
// (important_bounds_kernel, one block a slice), and take a tap only where
// it can read level >= 1: a step whose slice has none takes none, nor does
// a sample a texel or more outside them (the nearest tap lies within half
// a texel of the snap, and the snap within 2^-bits of the coordinate).
// The taps that remain are formed in integers (snapped_tap).
//
// Straight (B6): while ns is FAR the bit is FAR <= m_end, with m_end =
// j + (exit - norm_pos) / ts.  norm_pos >= 0 and rounded division and
// addition are monotone, so for ts > 0, m_end <= (n - 1) + max(exit, 0) /
// ts in the kernel's own rounding; where that bound lies below FAR (the
// per-ray proof), no step sets its bit while ns is FAR.  So a ray is in
// phase 1 until its first important tap: no range test (no norm_pos, no
// division), and a tap only at a step whose slice holds an important
// texel, within a texel of their span.  A block marks in shared memory
// the steps whose slice holds an important texel, and a ray in phase 1
// goes from one marked step to the next (most rays of the teapot visit 52
// of 256 steps and store 0 words).  Then, in phase 2, it runs the range
// test at every valid step and taps wherever the slice holds an important
// texel (the span test would cost about what it saves).  Where the proof
// fails (ts <= 0, a tiny ts, a NaN) the ray is in phase 2 from the start.
// Phase 2 stores each word after its 32 steps, so that the threads of a
// warp, which enter phase 2 at different steps, store together.  Both
// phases sweep only the ray's valid steps, one interval for 0 < ts < inf
// (t rounds monotone in j), found once a ray.
//
// Cone (B7): a step is the ray's range test and 8 probes, and a live ray
// sweeps every step, as the probes update ns outside the main ray's
// window.  A step whose slice has no important texel runs no probe, and a
// probe outside the slice's span takes no tap.  The main ray's own sample
// is read only where the bit is set.  A ray's eight directions stay on
// one thread: they are independent, so the thread has the parallelism,
// and the step's range test and bounds are formed once for all eight
// (spreading them over eight threads repeated that work in each and took
// twice the time).
//
// Threads cover 16x16 pixel tiles, so that neighbouring threads gather
// neighbouring voxels.
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

// The first pass, one block a slice k: the rows and columns its important
// texels (level >= 1) span, bounds[k] = (row min, row max, column min,
// column max), or (INT_MAX, -1, INT_MAX, -1) when it has none.  Where a row
// is a whole number of 16-byte chunks, a thread reads BOUNDS_CHUNKS chunks
// at once, so that the slice's bytes are in flight together, and looks
// into a chunk only where it is not all zero; otherwise it reads bytes.
constexpr int BOUNDS_THREADS = 256, BOUNDS_CHUNKS = 16;

__device__ __forceinline__ void span_add(int row, int col, int& r0, int& r1, int& c0, int& c1) {
    r0 = min(r0, row);
    r1 = max(r1, row);
    c0 = min(c0, col);
    c1 = max(c1, col);
}

__global__ void __launch_bounds__(BOUNDS_THREADS) important_bounds_kernel(const uint8_t* __restrict__ levels, int nr,
                                                                          int nc, int4* __restrict__ bounds) {
    __shared__ int s[4];
    if (threadIdx.x < 4) s[threadIdx.x] = (threadIdx.x & 1) ? -1 : INT_MAX;
    __syncthreads();
    const uint8_t* sl = levels + (size_t)blockIdx.x * nr * nc;
    int r0 = INT_MAX, r1 = -1, c0 = INT_MAX, c1 = -1;
    if (nc % 16 == 0 && reinterpret_cast<uintptr_t>(levels) % 16 == 0) {
        const uint4* chunks = reinterpret_cast<const uint4*>(sl);
        const int per_row = nc / 16, n_chunks = nr * per_row;
        for (int base = threadIdx.x; base < n_chunks; base += BOUNDS_THREADS * BOUNDS_CHUNKS) {
            uint4 v[BOUNDS_CHUNKS];
#pragma unroll
            for (int u = 0; u < BOUNDS_CHUNKS; ++u) {
                const int i = base + u * BOUNDS_THREADS;
                v[u] = i < n_chunks ? __ldg(chunks + i) : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int u = 0; u < BOUNDS_CHUNKS; ++u) {
                if ((v[u].x | v[u].y | v[u].z | v[u].w) != 0u) {
                    // the chunk's first and last nonzero byte (little endian)
                    const int i = base + u * BOUNDS_THREADS, row = i / per_row, col = (i - row * per_row) * 16;
                    const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
                    int first = 16, last = -1;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        if (w[q] != 0u) {
                            first = min(first, 4 * q + ((__ffs(w[q]) - 1) >> 3));
                            last = max(last, 4 * q + ((31 - __clz(w[q])) >> 3));
                        }
                    }
                    span_add(row, col + first, r0, r1, c0, c1);
                    c1 = max(c1, col + last);
                }
            }
        }
    } else {
        for (int i = threadIdx.x; i < nr * nc; i += BOUNDS_THREADS) {
            if (__ldg(sl + i) >= 1) span_add(i / nc, i % nc, r0, r1, c0, c1);
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

// the highest march step at or below j whose bit is set in `marked` (one
// bit a step, 32 to a word), or -1
__device__ __forceinline__ int marked_at_or_below(const uint32_t* marked, int j) {
    if (j < 0) return -1;
    int w = j >> 5;
    uint32_t m = marked[w] & (0xffffffffu >> (31 - (j & 31)));
    while (m == 0u) {
        if (--w < 0) return -1;
        m = marked[w];
    }
    return (w << 5) + 31 - __clz(m);
}

template <bool CONE>
__global__ void __launch_bounds__(TILE_X * TILE_Y) lookahead_kernel(
    const float* __restrict__ feats,   // (N_FEATURES, H, W)
    const float* __restrict__ cfeats,  // (CONE_SAMPLES * CF_STRIDE, H, W) when CONE
    const uint8_t* __restrict__ levels,  // (n, nr, nc)
    const int4* __restrict__ bounds,     // (n,): each slice's important rows and columns
    uint32_t* __restrict__ gate,       // (ceil(n / 32), H, W)
    int height, int width, int n, int nr, int nc, int sign, int subtexel) {
    // straight: bit j of `marked` is set where march step j's slice holds
    // an important texel (ceil(n / 32) words of dynamic shared memory)
    extern __shared__ uint32_t marked[];
    if constexpr (!CONE) {
        const int tid = threadIdx.y * TILE_X + threadIdx.x;
        for (int j = tid; j < ((n + 31) & ~31); j += TILE_X * TILE_Y) {
            const bool has = j < n && __ldg(&bounds[sign > 0 ? j : n - 1 - j].y) >= 0;
            const uint32_t word = __ballot_sync(0xffffffffu, has);
            if ((tid & 31) == 0) marked[j >> 5] = word;
        }
        __syncthreads();
    }
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
    uint32_t word = 0u;

    if constexpr (!CONE) {
        // The valid steps [a, b): for 0 < ts < inf and a finite tb, t = ts
        // * j + tb rounds monotone in j, so they form one interval; find
        // it from an estimate, moving each end with the exact expression.
        // Otherwise [0, n).  Every step still tests its own window.
        int a = 0, b = n;
        if (ts > 0.0f && isfinite(ts) && isfinite(tb)) {
            const float ea = __fdividef(entry - tb, ts), eb = __fdividef(exit_ - tb, ts);
            a = ea >= (float)n ? n : ea > 0.0f ? (int)ceilf(ea) : 0;
            b = eb >= (float)n ? n : eb > 0.0f ? (int)ceilf(eb) : 0;
            while (a > 0 && ts * (float)(a - 1) + tb >= entry) --a;
            while (a < n && !(ts * (float)a + tb >= entry)) ++a;
            while (b > 0 && !(ts * (float)(b - 1) + tb < exit_)) --b;
            while (b < n && ts * (float)b + tb < exit_) ++b;
        }
        float ns = FAR;
        int j = b - 1;
        // Phase 1, while ns is FAR and the header's proof holds: every bit
        // is 0, so no range test runs, and only a step whose slice holds
        // an important texel can tap.  Visit those steps alone; where one
        // is valid and its clamped coordinate lies within a texel of the
        // slice's important span, tap.  The first important tap sets ns.
        if (ts > 0.0f && (float)(n - 1) + fmaxf(exit_, 0.0f) / ts < FAR) {
            for (j = marked_at_or_below(marked, j); j >= a; j = marked_at_or_below(marked, j - 1)) {
                const float jf = (float)j;
                const float t = ts * jf + tb;
                if (!(t >= entry && t < exit_)) continue;
                const int k = sign > 0 ? j : n - 1 - j;
                const int4 bd = __ldg(bounds + k);
                const float rows_c = clampf(rs * jf + rb, 0.0f, rmax);
                const float cols_c = clampf(cs * jf + cb, 0.0f, cmax);
                if (rows_c >= (float)bd.x - 1.0f && rows_c <= (float)bd.y + 1.0f && cols_c >= (float)bd.z - 1.0f &&
                    cols_c <= (float)bd.w + 1.0f &&
                    __ldg(levels + (size_t)k * slice + snapped_tap(rows_c, subtexel, nr) * nc +
                          snapped_tap(cols_c, subtexel, nc)) >= 1) {
                    ns = jf;
                    break;
                }
            }
            if (j < a) {
                for (int w = 0; w < (n + 31) / 32; ++w) g[(size_t)w * n_rays] = 0u;
                return;
            }
            --j;  // phase 2 starts below the first important tap
        }
        // the words above step j are 0, and so are its word's bits above it
        for (int w = (n - 1) >> 5; w > (j >> 5); --w) g[(size_t)w * n_rays] = 0u;
        // Phase 2, every step from j down to the window's first (all of
        // them where the proof fails): the range test at every valid step
        // and the ray's own tap where its slice holds an important texel
        // (the span test would cost about what it saves), which clears the
        // bit where opaque and moves ns where important.  A word is stored
        // once its 32 steps are done, so that the threads of a warp, which
        // enter phase 2 at different steps, store together, and its marked
        // steps are read once.
        for (int w = j >> 5; w >= 0; --w) {
            const uint32_t m = marked[w];
            for (const int lo = max(w << 5, a); j >= lo; --j) {
                const float jf = (float)j;
                const float t = ts * jf + tb;
                bool bit = false;
                if (t >= entry && t < exit_) {
                    bit = ns <= jf + (exit_ - norm_pos(c2, cd, t)) / ts;
                    if ((m >> (j & 31)) & 1u) {
                        const float rows_c = clampf(rs * jf + rb, 0.0f, rmax);
                        const float cols_c = clampf(cs * jf + cb, 0.0f, cmax);
                        const uint8_t level =
                            __ldg(levels + (size_t)(sign > 0 ? j : n - 1 - j) * slice +
                                  snapped_tap(rows_c, subtexel, nr) * nc + snapped_tap(cols_c, subtexel, nc));
                        bit = bit && level < 2;
                        if (level >= 1) ns = jf;
                    }
                }
                word |= (uint32_t)bit << (j & 31);
            }
            g[(size_t)w * n_rays] = word;
            word = 0u;
        }
    } else {
        const float rhi = (float)nr - 0.5f, chi = (float)nc - 0.5f;
        // the cone directions' coefficients and next-important indices
        float crs[CONE_SAMPLES], crb[CONE_SAMPLES], ccs[CONE_SAMPLES], ccb[CONE_SAMPLES];
        float cts[CONE_SAMPLES], ctb[CONE_SAMPLES], rate[CONE_SAMPLES], ns[CONE_SAMPLES];
#pragma unroll
        for (int c = 0; c < CONE_SAMPLES; ++c) {
            ns[c] = FAR;
            const float* cf = cfeats + (size_t)c * CF_STRIDE * n_rays + r;
            crs[c] = cf[CF_RS * n_rays];
            crb[c] = cf[CF_RB * n_rays];
            ccs[c] = cf[CF_CS * n_rays];
            ccb[c] = cf[CF_CB * n_rays];
            cts[c] = cf[CF_TS * n_rays];
            ctb[c] = cf[CF_TB * n_rays];
            rate[c] = cf[CF_RATE * n_rays];
        }
        for (int j = n - 1; j >= 0; --j) {
            const float jf = (float)j;
            const float t = ts * jf + tb;
            const bool valid = t >= entry && t < exit_;
            const int k = sign > 0 ? j : n - 1 - j;
            const uint8_t* sl = levels + (size_t)k * slice;
            bool bit = false;
            if (valid) {
                const float d_range = exit_ - norm_pos(c2, cd, t);
#pragma unroll
                for (int c = 0; c < CONE_SAMPLES; ++c) bit |= ns[c] <= jf + d_range * rate[c] && rate[c] > 0.0f;
            }
            // the probes update ns at every step: a probe crossing may lie
            // outside the main ray's window; one a texel or more outside
            // its slice's important rows and columns reads level 0
            const int4 bd = __ldg(bounds + k);
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
            if (valid && bit) {
                // the ray's own sample, snapped like the march's: it clears
                // the bit where opaque
                const float rows = snap(clampf(rs * jf + rb, 0.0f, rmax), subtexel);
                const float cols = snap(clampf(cs * jf + cb, 0.0f, cmax), subtexel);
                bit = __ldg(sl + nearest_index(rows, cols, nr, nc)) < 2;
            }
            emit(g, n_rays, j, bit, word);
        }
    }
}

}  // namespace

// C entry for ctypes: the bounds pass into `scratch`, then the cone kernel
// when `cone_feats` is not NULL, else the straight one, on `stream`;
// returns cudaGetLastError().
extern "C" int lookahead_launch(const float* feats, const float* cone_feats, const uint8_t* levels,
                                uint32_t* gate, int height, int width, int n, int nr, int nc, int sign,
                                int subtexel, void* stream, int* scratch) {
    const dim3 block(TILE_X, TILE_Y);
    const dim3 grid((width + TILE_X - 1) / TILE_X, (height + TILE_Y - 1) / TILE_Y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // the first pass, into `scratch` (n x 4 int32): each slice's important
    // rows and columns
    int4* bounds = reinterpret_cast<int4*>(scratch);
    important_bounds_kernel<<<n, BOUNDS_THREADS, 0, s>>>(levels, nr, nc, bounds);
    if (cone_feats != nullptr) {
        lookahead_kernel<true><<<grid, block, 0, s>>>(feats, cone_feats, levels, bounds, gate, height, width, n, nr,
                                                      nc, sign, subtexel);
    } else {
        const size_t marked_bytes = (size_t)(n + 31) / 32 * sizeof(uint32_t);
        lookahead_kernel<false><<<grid, block, marked_bytes, s>>>(feats, nullptr, levels, bounds, gate, height, width,
                                                                  n, nr, nc, sign, subtexel);
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
