// The per-ray table and the cone look-ahead table for Hopper (sm_90a): one
// CUDA thread per ray, the camera's rays made in registers.
//
// Replaces no TPU kernel: the JAX package builds both tables with jnp ops
// (volym_tpu/ops/slab_kernel.py::features_from_rays and
// ::cone_features_from_rays), which XLA fuses.  The port built them with a
// chain of whole-frame PyTorch ops (volym_tpu_torch/render/rays.py
// ::rays_from_ndc and ::ray_box_intersection, then
// ops/slab_march.py::features_from_rays and ::cone_features_from_rays):
// about 140 launches for the per-ray table and 150 for the cone table, each
// a pass over the frame's rays, with the host enqueueing them while the card
// idles.  These kernels are one launch a table and keep every intermediate
// in registers.  The chain stays as their plain version: it builds the tables
// of CPU tensors, and the backward re-runs it for the camera's gradients.
//
// Input: the rays' NDC points (R, 2) and the camera's inverse_view_proj
// (4 x 4, row-major) and position (3), read from device memory.  Output:
// ray_table_kernel writes the (N_FEATURES, R) rows F_RS .. F_C2;
// cone_table_kernel writes the (CONE_SAMPLES * CF_STRIDE, R) rows, cone
// direction s's CF_* rows at s * CF_STRIDE.  Rays are fastest, so a warp's
// stores of one row are coalesced.
//
// Bound: bytes.  A ray reads 8 bytes and writes 60 (per-ray) or 224 (cone)
// bytes; a 1024x768 frame moves 53 MB and 182 MB, 0.016 and 0.054 ms at
// 3.35 TB/s.  The arithmetic is a few hundred float32 operations a ray.
//
// Numerics: the tables feed the subtexel snap, so each expression below is
// the chain's, in its order and rounding, and the tables are bit for bit the
// chain's on the card.  Built with --fmad=false, so no product is contracted
// into a sum, as PyTorch's separate elementwise ops round each; '/' is
// correctly rounded (no fast math), as PyTorch's tensor-by-tensor division
// is; rays.sqrt_rn (a float64 root rounded to float32) is __fsqrt_rn;
// rays.fma_rn is __fmaf_rn.  The chain's `1.0 / sqrt_rn(3)` divides a Python
// scalar by a tensor, which PyTorch evaluates as reciprocal(x) * 1.0:
// __frcp_rn.  The chain's Python-float constants (1e-12, the slab step, the
// cone offsets) become float32 when PyTorch applies them: TINY below is
// 1e-12's, and the wrapper passes the others as float32 arguments.  torch.minimum, maximum, amax, amin and
// clamp propagate NaN where fminf and fmaxf do not: a ray with a zero
// direction component through an origin coordinate of exactly 0 or 1 has
// t = 0/0 there and a NaN entry and exit in the chain; the helpers below
// keep that.

#include <cuda_runtime.h>
#include <math.h>

#include "slab_common.cuh"

using namespace volym_slab;

namespace {

constexpr int THREADS = 256;
// the guard of a tiny direction component (slab.py ray_affine) and of a
// vertical ray's right vector (golden.py cone_directions): float32 of 1e-12
constexpr float TINY = 1e-12f;

// the float32 constants of the chain, converted from its Python floats as
// PyTorch converts a scalar operand
struct TableConsts {
    int major, row, col;  // slab.py _AXIS_LAYOUT: the march axis and a slice's row / column components
    float sz;             // (1 / n_slabs) * sign: the t step of one plane
    float z0;             // the first plane's centre along the march axis
    float inv_slabs;      // 1 / n_slabs, aexp's numerator
    float n_rows;         // ray_affine's n: the permuted slice's rows (n_plane)
    float n_slabs;        // the cone rate's factor
    float sign;           // the march sign, +1 or -1
};

// the cone's offsets: cos and sin of direction s's angle, times CONE_ANGLE
struct ConeOffsets {
    float right[CONE_SAMPLES];
    float up[CONE_SAMPLES];
};

// torch.minimum / torch.maximum: a NaN operand is the result
__device__ __forceinline__ float minimum_nan(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float maximum_nan(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// torch.amax / torch.amin over the three components (NaN wins)
__device__ __forceinline__ float amax3(float a, float b, float c) {
    float m = a;
    m = (m != m || m > b) ? m : b;
    return (m != m || m > c) ? m : c;
}

__device__ __forceinline__ float amin3(float a, float b, float c) {
    float m = a;
    m = (m != m || m < b) ? m : b;
    return (m != m || m < c) ? m : c;
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
    return x != x ? x : fmaxf(x, lo);
}

// rays.norm3: the root of the squares summed in component order
__device__ __forceinline__ float norm3(float x, float y, float z) {
    return __fsqrt_rn(x * x + y * y + z * z);
}

// rays.rays_from_ndc for one NDC point: unproject_ndc's multiply-adds,
// the perspective division, the offset from the camera, normalised
__device__ __forceinline__ void ray_direction(const float* __restrict__ ivp, const float* __restrict__ pos, float x,
                                              float y, float d[3]) {
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        w[k] = x * ivp[4 * k + 0] + y * ivp[4 * k + 1] + ivp[4 * k + 3];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        d[k] = w[k] / w[3] - pos[k];
    }
    const float n = norm3(d[0], d[1], d[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        d[k] = d[k] / n;
    }
}

// component k of a 3-vector, by selects (an index into the array would put
// it in local memory)
__device__ __forceinline__ float component(const float v[3], int k) {
    return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

// slab.ray_affine for one direction: (rs, rb, cs, cb, ts, tb)
__device__ __forceinline__ void ray_affine(const TableConsts& c, const float o[3], const float d[3], float out[6]) {
    const float d_m = component(d, c.major);
    const float d_r = component(d, c.row), d_c = component(d, c.col);
    const float safe = fabsf(d_m) > TINY ? d_m : TINY;
    const float ts = c.sz / safe;
    const float tb = (c.z0 - component(o, c.major)) / safe;
    out[0] = ts * d_r * c.n_rows;
    out[1] = (component(o, c.row) + tb * d_r) * c.n_rows - 0.5f;
    out[2] = ts * d_c * c.n_rows;
    out[3] = (component(o, c.col) + tb * d_c) * c.n_rows - 0.5f;
    out[4] = ts;
    out[5] = tb;
}

__global__ void __launch_bounds__(THREADS) ray_table_kernel(const float* __restrict__ ndc,
                                                            const float* __restrict__ ivp,
                                                            const float* __restrict__ pos, float* __restrict__ out,
                                                            int rays, TableConsts c) {
    const int r = blockIdx.x * THREADS + threadIdx.x;
    if (r >= rays) return;
    const float o[3] = {pos[0], pos[1], pos[2]};
    float d[3];
    ray_direction(ivp, pos, ndc[2 * r], ndc[2 * r + 1], d);
    const size_t stride = (size_t)rays;
    float* row = out + r;

    // rays.ray_box_intersection against [0, 1]^3, clamped to >= 0
    float lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float t1 = (0.0f - o[k]) / d[k];
        const float t2 = (1.0f - o[k]) / d[k];
        lo[k] = minimum_nan(t1, t2);
        hi[k] = maximum_nan(t1, t2);
    }
    row[F_ENTRY * stride] = clamp_min_nan(amax3(lo[0], lo[1], lo[2]), 0.0f);
    row[F_EXIT * stride] = clamp_min_nan(amin3(hi[0], hi[1], hi[2]), 0.0f);

    float a[6];
    ray_affine(c, o, d, a);
    row[F_RS * stride] = a[0];
    row[F_RB * stride] = a[1];
    row[F_CS * stride] = a[2];
    row[F_CB * stride] = a[3];
    row[F_TS * stride] = a[4];
    row[F_TB * stride] = a[5];

    const float d_m = component(d, c.major);
    row[F_AEXP * stride] = c.inv_slabs / clamp_min_nan(fabsf(d_m), TINY) * 100.0f;
    row[F_SIGNOK * stride] = d_m * c.sign > 0.0f ? 1.0f : 0.0f;

    // the Blinn-Phong half vector, normalize(-dirs + 1/sqrt(3))
    const float light = __frcp_rn(__fsqrt_rn(3.0f));
    const float h0 = -d[0] + light, h1 = -d[1] + light, h2 = -d[2] + light;
    const float hn = norm3(h0, h1, h2);
    row[F_HX * stride] = h0 / hn;
    row[F_HY * stride] = h1 / hn;
    row[F_HZ * stride] = h2 / hn;

    // cam.dir as JAX's fused dot, and |cam|^2
    row[F_CD * stride] = __fmaf_rn(d[2], o[2], __fmaf_rn(d[1], o[1], d[0] * o[0]));
    row[F_C2 * stride] = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
}

__global__ void __launch_bounds__(THREADS) cone_table_kernel(const float* __restrict__ ndc,
                                                             const float* __restrict__ ivp,
                                                             const float* __restrict__ pos, float* __restrict__ out,
                                                             int rays, TableConsts c, ConeOffsets offs) {
    const int r = blockIdx.x * THREADS + threadIdx.x;
    if (r >= rays) return;
    const float o[3] = {pos[0], pos[1], pos[2]};
    float m[3];
    ray_direction(ivp, pos, ndc[2 * r], ndc[2 * r + 1], m);
    const size_t stride = (size_t)rays;
    float* row = out + r;

    // golden.cone_directions: right = normalize(cross(main, (0, 1, 0))),
    // guarded by 1e-12 for a vertical ray, and new_up = cross(main, right)
    float rt[3] = {m[1] * 0.0f - m[2] * 1.0f, m[2] * 0.0f - m[0] * 0.0f, m[0] * 1.0f - m[1] * 0.0f};
    const float rn = clamp_min_nan(norm3(rt[0], rt[1], rt[2]), TINY);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        rt[k] = rt[k] / rn;
    }
    const float up[3] = {m[1] * rt[2] - m[2] * rt[1], m[2] * rt[0] - m[0] * rt[2], m[0] * rt[1] - m[1] * rt[0]};

#pragma unroll
    for (int s = 0; s < CONE_SAMPLES; ++s) {
        float d[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            d[k] = m[k] + rt[k] * offs.right[s] + up[k] * offs.up[s];
        }
        const float n = norm3(d[0], d[1], d[2]);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            d[k] = d[k] / n;
        }
        float a[6];
        ray_affine(c, o, d, a);
        float* dst = row + (size_t)(s * CF_STRIDE) * stride;
        dst[CF_RS * stride] = a[0];
        dst[CF_RB * stride] = a[1];
        dst[CF_CS * stride] = a[2];
        dst[CF_CB * stride] = a[3];
        dst[CF_TS * stride] = a[4];
        dst[CF_TB * stride] = a[5];
        dst[CF_RATE * stride] = component(d, c.major) * c.n_slabs * c.sign;
    }
}

}  // namespace

// C entry for ctypes: one launch of the per-ray table (cone == 0) or of the
// cone table (cone != 0, `offsets` the host array of the CONE_SAMPLES
// right offsets then the CONE_SAMPLES up offsets) on `stream`; returns
// cudaGetLastError()
extern "C" int ray_table_launch(const float* ndc, const float* ivp, const float* pos, float* out, int rays, int cone,
                                int major, int row, int col, float sz, float z0, float inv_slabs, float n_rows,
                                float n_slabs, float sign, const float* offsets, void* stream) {
    if (rays <= 0) return 0;
    const TableConsts c{major, row, col, sz, z0, inv_slabs, n_rows, n_slabs, sign};
    const dim3 grid((rays + THREADS - 1) / THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cone) {
        ConeOffsets offs;
        for (int k = 0; k < CONE_SAMPLES; ++k) {
            offs.right[k] = offsets[k];
            offs.up[k] = offsets[CONE_SAMPLES + k];
        }
        cone_table_kernel<<<grid, THREADS, 0, s>>>(ndc, ivp, pos, out, rays, c, offs);
    } else {
        ray_table_kernel<<<grid, THREADS, 0, s>>>(ndc, ivp, pos, out, rays, c);
    }
    return (int)cudaGetLastError();
}
