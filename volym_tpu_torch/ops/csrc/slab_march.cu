// Forward slab march for Hopper (sm_90a): a block marches a tile of rays,
// each batch of steps' slab window staged in shared memory.
//
// Replaces the TPU kernel volym_tpu/ops/slab_kernel.py::_march_kernel (step
// body _march_step_body, TF lookup _tf_lookup) in its base and Blinn-Phong
// shading modes, with nearest or bilinear sampling and the f32 or u8 density
// stream.  The TPU kernel turns every texel gather into hat-matrix products
// on the MXU; here each thread reads its texels.  The plain PyTorch
// version is volym_tpu_torch/render/slab.py::march_slabs, which evaluates
// every per-sample expression in the order written below.
//
// Design: a block marches a tile of MARCH_TILE_W x MARCH_TILE_H rays in
// lockstep batches of K steps (MARCH_BATCH_U8 on the u8 stream,
// MARCH_BATCH on f32: a u8 window holds a quarter of the bytes), each
// batch's slab window staged in shared memory by asynchronous copies
// (cp.async), the counterpart of the TPU kernel keeping the slab it marches
// in VMEM.  Per batch:
//   1. the plan: each ray not yet done takes the steps of the batch inside
//      the bounds of its t-window (floor((entry - tb) / ts) - 1 and
//      floor((exit - tb) / ts) + 1: t = ts*j+tb rounds within far less than
//      a step of the real line), and from the first and the last of them
//      the texel rows and columns its samples read: the coordinates
//      rs*j+rb, clipped and snapped, are monotone in j and tap_span gives
//      sample_at's own taps, so the two end steps bound the batch.  The
//      block's window is their min / max (warp reductions and shared
//      atomics).  Under SMOOTH the density window covers the plain rows the
//      sliding window takes, row j+3 at step j+3's coordinates; under
//      SHADING a second window covers the gradient field's three f32
//      channels at the step's own coordinates (the same window unsmoothed).
//   2. the copies: K slices of the window (and 3 x K of the gradient
//      window), rows in 16-byte chunks (the first column aligned down),
//      into one of two STAGE_BYTES buffers.  Batch b+1 is planned, and its
//      copies issued, before batch b composites, so the copies fly while it
//      does.  The plan of b+1 takes the rays not done at the start of b, a
//      superset of those that sample in b+1.
//   3. the samples, in step order as before: from the stage (the staged
//      route), or, where the window does not fit its buffer (sparse rays:
//      small images, zoomed-out views; rows not 16-byte aligned), from
//      global memory, the batch's K densities (plain rows j+3 under SMOOTH)
//      sampled first with all their taps in flight together (the direct
//      route).  The gradient field is read from the stage or from global
//      memory.
// A sample reads the same texels through either accessor with the same
// arithmetic, so both routes give the plain version's bits.  Two samples
// are skipped because they cannot pass the threshold (a bilinear or box
// sample is a convex combination of its taps, and so is the stencil of its
// rows): bilinear without the residual and smoothing, every sample of a
// staged slice whose texels all lie below it (the block scans each staged
// slice for its largest texel: one more __syncthreads a batch; a nearest
// sample of one tap is cheaper than the scan); under smoothing without the
// residual, the stencil of a step whose 7 rows all lie below it.  All
// threads go through every batch and every barrier; a ray that has ended
// stops compositing, and the block stops when none is left.  The first
// batch is the tile's least t-window bound.  The LUT lives in shared
// memory too.
//
// Bound: instructions.  The one-thread-a-ray kernel this replaces held 40
// to 48 registers unsmoothed and hid its L2 round trips behind 5-6 blocks
// an SM; the stage removes the round trips but adds the plan, the copies
// and the lockstep (a tile's finished warps go on through the batches of
// its longest ray), about 10 instructions a step.  The skips pay for that
// where samples are dear (bilinear, the 300-operation stencil) and not
// where they are cheap (nearest, unsmoothed, or every sample stored for
// the residual).

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
// not sampled at all.  A batch's steps lie in one word (K divides 32),
// loaded once a batch.  Without a gate (NULL) the word stays 0.  The t >= exit and
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
// registers (SmoothWindow), primed from global memory at the first step the
// ray reaches and then one new sample a step, three steps ahead of the
// composited one, from the batch's stage.
// The rows are sampled at the steps' clipped coordinates whatever the
// t-window, and rows beyond the sweep clamp to its end rows, as in the
// plain version.  The smoothed density takes the place of the sample in
// the threshold mask, the TF lookup and the residual's row 0; the gradient
// field is still sampled at the step's own coordinates.  A gated step
// still advances the window.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "slab_common.cuh"

namespace {

using namespace volym_slab;

// the tile of rays a block marches, the steps a batch (f32 and u8 streams:
// the u8 window is a quarter of the bytes) and the bytes of each of the two
// stage buffers (ops/slab_march.py holds the same values)
constexpr int MARCH_TILE_W = 16;
constexpr int MARCH_TILE_H = 16;
constexpr int MARCH_BATCH = 8;
constexpr int MARCH_BATCH_U8 = 16;
constexpr int STAGE_BYTES = 16384;
constexpr int THREADS = MARCH_TILE_W * MARCH_TILE_H;
constexpr int K_MAX = MARCH_BATCH > MARCH_BATCH_U8 ? MARCH_BATCH : MARCH_BATCH_U8;
constexpr unsigned FULL_MASK = 0xffffffffu;
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "a tile is whole warps");
static_assert(32 % MARCH_BATCH == 0 && 32 % MARCH_BATCH_U8 == 0, "a batch lies inside one gate word");
static_assert(STAGE_BYTES % 16 == 0, "the stage is 16-byte chunks");

// 16 bytes global -> shared, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// a snapped texel coordinate of march step j: the march's own expression
__device__ __forceinline__ float step_coord(float s, float b, int j, float hi, int subtexel) {
    return snap(clampf(s * (float)j + b, 0.0f, hi), subtexel);
}

// Inclusive texel rows r0..r1 and columns c0..c1; empty when r0 > r1.  In
// shared memory a box is 4 ints, reduced with atomicMin / atomicMax.
struct Box {
    int r0, r1, c0, c1;
};

__device__ __forceinline__ Box empty_box() { return Box{INT_MAX, -1, INT_MAX, -1}; }

// the texels a ray's samples at steps s_lo..s_hi read (the coordinates are
// monotone in the step and tap_span in the coordinate: the end steps bound)
template <bool BILINEAR>
__device__ __forceinline__ Box ray_box(int s_lo, int s_hi, float rs, float rb, float cs, float cb, int nr, int nc,
                                       int subtexel) {
    const float rmax = (float)(nr - 1), cmax = (float)(nc - 1);
    const int2 ra = tap_span<BILINEAR>(step_coord(rs, rb, s_lo, rmax, subtexel), nr);
    const int2 rz = tap_span<BILINEAR>(step_coord(rs, rb, s_hi, rmax, subtexel), nr);
    const int2 ca = tap_span<BILINEAR>(step_coord(cs, cb, s_lo, cmax, subtexel), nc);
    const int2 cz = tap_span<BILINEAR>(step_coord(cs, cb, s_hi, cmax, subtexel), nc);
    return Box{min(ra.x, rz.x), max(ra.y, rz.y), min(ca.x, cz.x), max(ca.y, cz.y)};
}

// the block's box: warp reductions, then one shared atomic a warp and bound
__device__ __forceinline__ void reduce_box(int* s, const Box& b) {
    const int r0 = __reduce_min_sync(FULL_MASK, b.r0), r1 = __reduce_max_sync(FULL_MASK, b.r1);
    const int c0 = __reduce_min_sync(FULL_MASK, b.c0), c1 = __reduce_max_sync(FULL_MASK, b.c1);
    if ((threadIdx.x & 31) == 0 && r0 <= r1) {
        atomicMin(s + 0, r0);
        atomicMax(s + 1, r1);
        atomicMin(s + 2, c0);
        atomicMax(s + 3, c1);
    }
}

__device__ __forceinline__ void clear_box(int* s) {
    s[0] = INT_MAX;
    s[1] = -1;
    s[2] = INT_MAX;
    s[3] = -1;
}

// A batch's window in a stage buffer: slices of `rows` rows from r0 and
// `chunks` 16-byte chunks from column c0 (the box's first column aligned
// down to 16 bytes), from byte `offset` of the buffer.  any: some ray reads
// it; staged: it is in the buffer, else the samples read global memory.
// Every thread forms the same window from the box; the block keeps it in
// shared memory while the batch composites.
struct Window {
    int r0, c0, rows, chunks, offset;
    bool any, staged;

    template <typename T>
    __device__ __forceinline__ int pitch() const { return chunks * 16 / (int)sizeof(T); }
    __device__ __forceinline__ int slice_bytes() const { return rows * chunks * 16; }
};

template <typename T>
__device__ __forceinline__ Window make_window(const int* s, int slices, int offset, bool can_stage) {
    Window w{};
    w.any = s[0] <= s[1];
    if (!w.any) return w;
    const int b0 = (s[2] * (int)sizeof(T)) & ~15, b1 = ((s[3] + 1) * (int)sizeof(T) + 15) & ~15;
    w.r0 = s[0];
    w.c0 = b0 / (int)sizeof(T);
    w.rows = s[1] - s[0] + 1;
    w.chunks = (b1 - b0) / 16;
    w.offset = offset;
    w.staged = can_stage && offset + slices * w.slice_bytes() <= STAGE_BYTES;
    return w;
}

// issue the copies of a window: slice ch * K + q holds channel ch of march
// step first + q (steps past the sweep are not copied)
template <int K, typename T>
__device__ __forceinline__ void stage_window(unsigned char* buf, const T* __restrict__ src, const Window& w,
                                             int channels, int first, int n, int nr, int nc, int sign) {
    const size_t slice = (size_t)nr * nc;
    // a thread a (slice, row), its chunks in turn
    for (int i = threadIdx.x; i < channels * K * w.rows; i += THREADS) {
        const int sl = i / w.rows, row = i - sl * w.rows;
        const int ch = sl / K, step = first + (sl - ch * K);
        if (step > n - 1) continue;
        const size_t k = (size_t)(sign > 0 ? step : n - 1 - step);
        const unsigned char* g =
            reinterpret_cast<const unsigned char*>(src + ((size_t)ch * n + k) * slice + (size_t)(w.r0 + row) * nc + w.c0);
        unsigned char* d = buf + w.offset + (sl * w.rows + row) * w.chunks * 16;
        for (int chunk = 0; chunk < w.chunks; ++chunk) cp_async16(d + chunk * 16, g + chunk * 16);
    }
}

// slice ch * K + q of a staged window
template <typename T>
__device__ __forceinline__ StagedTexels<T> staged_slice(const unsigned char* buf, const Window& w, int sl) {
    return StagedTexels<T>{reinterpret_cast<const T*>(buf + w.offset + sl * w.slice_bytes()), w.r0, w.c0,
                           w.pitch<T>()};
}

template <bool BILINEAR, bool U8, bool SHADING, bool EMIT, bool SMOOTH>
__global__ void __launch_bounds__(THREADS, SMOOTH ? 2 : 4) slab_march_kernel(
    const float* __restrict__ feats,  // (N_FEATURES, H, W)
    const void* __restrict__ vol_,    // (n, nr, nc) uint8 if U8 else float
    const float* __restrict__ grad,   // (3, n, nr, nc) when SHADING
    const float* __restrict__ lut,    // (ln, 4)
    float* __restrict__ out,          // (H, W, 4)
    float* __restrict__ dens,         // (n, SHADING ? 4 : 1, H, W) when EMIT, zero-filled
    const uint32_t* __restrict__ gate,  // (ceil(n / 32), H, W) packed gate bits, or NULL
    int height, int width, int n, int nr, int nc, int ln, int sign, int subtexel,
    float threshold, float early_alpha, float tf_scale, int can_stage) {
    using T = typename std::conditional<U8, uint8_t, float>::type;
    const T* __restrict__ vol = static_cast<const T*>(vol_);
    constexpr int K = U8 ? MARCH_BATCH_U8 : MARCH_BATCH;
    constexpr int HALO = SMOOTH ? SMOOTH_HALO : 0;  // the step the density window is for, ahead of j
    // a staged slice whose texels are all below the threshold is not sampled:
    // its samples are below it too (only bilinear, whose 4 taps are worth the
    // scan, without the residual, which stores every density, and without
    // smoothing, whose rows come from 3 batches)
    constexpr bool SKIP_EMPTY = BILINEAR && !EMIT && !SMOOTH;

    // dynamic shared memory: [stage 0 | stage 1 | K densities a thread | LUT]
    extern __shared__ __align__(16) unsigned char smem[];
    float* s_pre = reinterpret_cast<float*>(smem + 2 * STAGE_BYTES);
    float* s_lut = s_pre + K_MAX * THREADS;
    __shared__ int s_box[3][8];  // the boxes of three batches in turn (density, gradient)
    __shared__ int s_max[2][K];  // the largest texel of each staged slice (float bits, >= 0), two batches
    __shared__ Window s_win[2][2];  // the density and gradient windows of two batches
    __shared__ int s_first;

    const int tid = threadIdx.x;
    for (int i = tid; i < ln * 4; i += THREADS) s_lut[i] = lut[i];
    if (tid < 3 * 8) (&s_box[0][0])[tid] = (tid & 1) ? -1 : INT_MAX;
    if (tid < 2 * K) (&s_max[0][0])[tid] = 0;
    if (tid == 0) s_first = INT_MAX;

    const int x = blockIdx.x * MARCH_TILE_W + tid % MARCH_TILE_W;
    const int y = blockIdx.y * MARCH_TILE_H + tid / MARCH_TILE_W;
    const bool in_image = x < width && y < height;
    const size_t n_rays = (size_t)height * width;
    const size_t r = in_image ? (size_t)y * width + x : 0;
    const float* f = feats + r;

    float entry = 0.0f, exit_ = 0.0f;
    bool live = false;
    if (in_image) {
        entry = f[F_ENTRY * n_rays];
        exit_ = f[F_EXIT * n_rays];
        live = !(exit_ <= entry) && f[F_SIGNOK * n_rays] > 0.5f;
    }
    float rs = 0.0f, rb = 0.0f, cs = 0.0f, cb = 0.0f, ts = 0.0f, tb = 0.0f, aexp = 0.0f;
    float hx = 0.0f, hy = 0.0f, hz = 0.0f;
    // bounds of the ray's t-window in steps, [first, last]: (entry - tb) / ts
    // and (exit - tb) / ts floored, less and plus one step (t = ts * j + tb
    // rounds within far less than a step of the real line)
    int first = INT_MAX, last = -1;
    if (live) {
        rs = f[F_RS * n_rays];
        rb = f[F_RB * n_rays];
        cs = f[F_CS * n_rays];
        cb = f[F_CB * n_rays];
        ts = f[F_TS * n_rays];
        tb = f[F_TB * n_rays];
        aexp = f[F_AEXP * n_rays];
        if (SHADING) {
            hx = f[F_HX * n_rays];
            hy = f[F_HY * n_rays];
            hz = f[F_HZ * n_rays];
        }
        const float e = floorf((entry - tb) / ts) - 1.0f;
        first = e > 0.0f ? (e < (float)n ? (int)e : n) : 0;
        const float l = floorf((exit_ - tb) / ts) + 1.0f;
        last = l < (float)(n - 1) ? (l > -1.0f ? (int)l : -1) : n - 1;
    }
    const int block_first = __reduce_min_sync(FULL_MASK, first);
    __syncthreads();
    if ((tid & 31) == 0) atomicMin(&s_first, block_first);
    __syncthreads();
    const int b_first = s_first == INT_MAX ? INT_MAX : s_first / K;

    const size_t slice = (size_t)nr * nc;
    const float rmax = (float)(nr - 1), cmax = (float)(nc - 1), lmax = (float)(ln - 1);
    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
    bool done = !live;
    uint32_t word = 0u;  // the gate's word of the batch's steps
    SmoothWindow<BILINEAR, T> win;
    for (int b = b_first == INT_MAX ? n : b_first - 1; b * K < n; ++b) {
        // 1. plan batch b + 1 over the rays not done at the start of batch
        // b: the steps of their t-window bounds in the batch
        const int nb = b + 1;
        int* box = s_box[nb % 3];
        if (nb * K < n) {
            const int jlo = max(nb * K, first), jhi = min(min(nb * K + K, n) - 1, last);
            const bool reads = !done && jlo <= jhi;
            Box d = empty_box();
            if (reads && jlo + HALO <= n - 1) {
                d = ray_box<BILINEAR>(jlo + HALO, min(jhi + HALO, n - 1), rs, rb, cs, cb, nr, nc, subtexel);
            }
            reduce_box(box, d);
            if (SHADING && SMOOTH) {
                reduce_box(box + 4, reads ? ray_box<BILINEAR>(jlo, jhi, rs, rb, cs, cb, nr, nc, subtexel)
                                          : empty_box());
            }
        }
        if (tid == 0) {  // the boxes of batch nb + 1, planned in the next pass
            clear_box(s_box[(nb + 1) % 3]);
            clear_box(s_box[(nb + 1) % 3] + 4);
        }
        cp_async_wait_all();  // batch b's copies, issued in the previous pass
        if (!__syncthreads_or(!done)) break;

        // 2. batch b + 1's windows and copies
        {
            const Window nd = make_window<T>(box, K, 0, can_stage);
            Window ng{};
            if (SHADING) {
                ng = make_window<float>(SMOOTH ? box + 4 : box, 3 * K, nd.staged ? K * nd.slice_bytes() : 0,
                                        can_stage && (nd.staged || !nd.any));
            }
            unsigned char* next_buf = smem + (nb & 1) * STAGE_BYTES;
            if (nd.staged) stage_window<K, T>(next_buf, vol, nd, 1, nb * K + HALO, n, nr, nc, sign);
            if (SHADING && ng.staged) stage_window<K, float>(next_buf, grad, ng, 3, nb * K, n, nr, nc, sign);
            cp_async_commit();
            if (tid == 0) {
                s_win[nb & 1][0] = nd;
                s_win[nb & 1][1] = ng;
            }
        }

        const unsigned char* buf = smem + (b & 1) * STAGE_BYTES;
        const Window dw = s_win[b & 1][0];
        const Window gw = s_win[b & 1][1];
        int* slice_max = s_max[b & 1];
        if (SKIP_EMPTY && tid == 0) {  // the slices' maxima of batch b + 1, taken in the next pass
#pragma unroll
            for (int q = 0; q < K; ++q) s_max[(b + 1) & 1][q] = 0;
        }
        if (SKIP_EMPTY && dw.staged && b >= b_first) {
            // the largest texel of each staged slice of batch b
            const int per_slice = dw.slice_bytes() / 16;
            for (int i = tid; i < K * per_slice; i += THREADS) {
                const uint4 v = *reinterpret_cast<const uint4*>(buf + dw.offset + i * 16);
                float m;
                if (U8) {
                    const unsigned u = __vmaxu4(__vmaxu4(v.x, v.y), __vmaxu4(v.z, v.w));
                    m = (float)max(max(u & 0xffu, (u >> 8) & 0xffu), max((u >> 16) & 0xffu, u >> 24));
                } else {
                    m = fmaxf(fmaxf(__uint_as_float(v.x), __uint_as_float(v.y)),
                              fmaxf(__uint_as_float(v.z), __uint_as_float(v.w)));
                }
                atomicMax(slice_max + i / per_slice, __float_as_int(fmaxf(m, 0.0f)));
            }
            __syncthreads();
        }

        // 3. batch b
        if (b >= b_first && !done) {
            // a batch lies inside one word of the gate
            if (gate != nullptr) word = __ldg(gate + (size_t)((b * K) >> 5) * n_rays + r);
            if (dw.any && !dw.staged) {
                // direct: the K densities' (plain rows j + HALO) taps all in
                // flight from global memory, before any step composites
#pragma unroll
                for (int q = 0; q < K; ++q) {
                    const int j = b * K + q, s = j + HALO;
                    if (j >= first && j <= last && s <= n - 1) {
                        s_pre[q * THREADS + tid] = sample<BILINEAR>(
                            vol + (size_t)(sign > 0 ? s : n - 1 - s) * slice, step_coord(rs, rb, s, rmax, subtexel),
                            step_coord(cs, cb, s, cmax, subtexel), nr, nc);
                    }
                }
            }
            for (int q = 0; q < K; ++q) {
                const int j = b * K + q;
                if (j >= n) break;
                const float jf = (float)j;
                const float t = ts * jf + tb;
                if (t >= exit_ || acc_a >= early_alpha) {
                    done = true;
                    break;
                }
                if (!(t >= entry)) continue;
                if (SMOOTH) {
                    if (!win.primed) {
                        win.prime(vol, j, rs, rb, cs, cb, n, nr, nc, sign, subtexel);
                    } else if (j + HALO <= n - 1) {
                        const int s = j + HALO;
                        win.push(j, n, dw.staged ? sample_at<BILINEAR>(staged_slice<T>(buf, dw, q),
                                                                         step_coord(rs, rb, s, rmax, subtexel),
                                                                         step_coord(cs, cb, s, cmax, subtexel), nr, nc)
                                                 : s_pre[q * THREADS + tid]);
                    } else {
                        win.push(j, n, 0.0f);
                    }
                }
                if ((word >> (j & 31)) & 1u) continue;
                const float rows = step_coord(rs, rb, j, rmax, subtexel);
                const float cols = step_coord(cs, cb, j, cmax, subtexel);
                float density;
                if (SMOOTH) {
                    if (!EMIT) {
                        float m = win.d[0];
#pragma unroll
                        for (int o = 1; o < SMOOTH_ROWS; ++o) m = fmaxf(m, win.d[o]);
                        if (!(sample_bound(m) >= threshold)) continue;  // the stencil of rows below it is below it
                    }
                    density = smooth_density<BILINEAR>(win.d, j, rs, rb, cs, cb, ts, n, nr, nc);
                } else if (dw.staged) {
                    if (SKIP_EMPTY && !(sample_bound(__int_as_float(slice_max[q])) >= threshold)) continue;
                    density = sample_at<BILINEAR>(staged_slice<T>(buf, dw, q), rows, cols, nr, nc);
                } else {
                    density = s_pre[q * THREADS + tid];
                }
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
                    float gx, gy, gz;
                    if (gw.staged) {
                        gx = sample_at<BILINEAR>(staged_slice<float>(buf, gw, q), rows, cols, nr, nc);
                        gy = sample_at<BILINEAR>(staged_slice<float>(buf, gw, K + q), rows, cols, nr, nc);
                        gz = sample_at<BILINEAR>(staged_slice<float>(buf, gw, 2 * K + q), rows, cols, nr, nc);
                    } else {
                        const size_t k = (size_t)(sign > 0 ? j : n - 1 - j);
                        gx = sample<BILINEAR>(grad + k * slice, rows, cols, nr, nc);
                        gy = sample<BILINEAR>(grad + ((size_t)n + k) * slice, rows, cols, nr, nc);
                        gz = sample<BILINEAR>(grad + ((size_t)2 * n + k) * slice, rows, cols, nr, nc);
                    }
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
    }
    cp_async_wait_all();
    if (in_image) {
        reinterpret_cast<float4*>(out)[r] =
            exit_ <= entry ? make_float4(0.0f, 0.0f, 0.0f, 1.0f) : make_float4(acc_r, acc_g, acc_b, acc_a);
    }
}

// dynamic shared memory of a launch: the two stage buffers, the K densities
// of each thread and the LUT
size_t smem_bytes(int ln) {
    return (size_t)2 * STAGE_BYTES + (size_t)K_MAX * THREADS * 4 + (size_t)ln * 4 * sizeof(float);
}

template <bool BILINEAR, bool U8, bool SHADING, bool EMIT, bool SMOOTH>
int launch(const float* feats, const void* vol, const float* grad, const float* lut, float* out, float* dens,
           const uint32_t* gate, int height, int width, int n, int nr, int nc, int ln, int sign, int subtexel,
           float threshold, float early_alpha, float tf_scale, cudaStream_t stream) {
    auto kernel = slab_march_kernel<BILINEAR, U8, SHADING, EMIT, SMOOTH>;
    const size_t smem = smem_bytes(ln);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // the stage copies 16-byte chunks: every row of every slice must start
    // on 16 bytes
    const size_t elem = U8 ? 1 : 4;
    const bool can_stage = reinterpret_cast<uintptr_t>(vol) % 16 == 0 && (nc * elem) % 16 == 0 &&
                           (!SHADING || (reinterpret_cast<uintptr_t>(grad) % 16 == 0 && (nc * 4) % 16 == 0));
    const dim3 grid((width + MARCH_TILE_W - 1) / MARCH_TILE_W, (height + MARCH_TILE_H - 1) / MARCH_TILE_H);
    kernel<<<grid, THREADS, smem, stream>>>(feats, vol, grad, lut, out, dens, gate, height, width, n, nr, nc, ln,
                                            sign, subtexel, threshold, early_alpha, tf_scale, can_stage);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes: launches on `stream` and returns the CUDA error (0 on
// success).  `dens` is NULL unless `emit` is set; `gate` is NULL without
// look-ahead.
extern "C" int slab_march_launch(const float* feats, const void* vol, const float* grad,
                                 const float* lut, float* out, float* dens, const uint32_t* gate,
                                 int height, int width,
                                 int n, int nr, int nc, int ln, int sign, int subtexel,
                                 int bilinear, int u8, int shading, int emit, int smooth, float threshold,
                                 float early_alpha, float tf_scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOLYM_LAUNCH(B, U, S, E, G)                                                                          \
    return launch<B, U, S, E, G>(feats, vol, grad, lut, out, dens, gate, height, width, n, nr, nc, ln, sign, \
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
        case 0: VOLYM_LAUNCH_E(false, false, false);
        case 1: VOLYM_LAUNCH_E(false, false, true);
        case 2: VOLYM_LAUNCH_E(false, true, false);
        case 3: VOLYM_LAUNCH_E(false, true, true);
        case 4: VOLYM_LAUNCH_E(true, false, false);
        case 5: VOLYM_LAUNCH_E(true, false, true);
        case 6: VOLYM_LAUNCH_E(true, true, false);
        default: VOLYM_LAUNCH_E(true, true, true);
    }
    return 0;
#undef VOLYM_LAUNCH_E
#undef VOLYM_LAUNCH_G
#undef VOLYM_LAUNCH
}
