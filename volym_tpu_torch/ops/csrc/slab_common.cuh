// Device helpers shared by the slab march (slab_march.cu), its replay
// backward (slab_replay.cu) and the look-ahead gate (lookahead.cu): the
// per-ray and cone tables' rows, the subtexel snap, the nearest tap, the
// clamp-to-edge slice sample and the TF texel lookup.  The kernels must
// evaluate these expressions identically, bit for bit (build with
// --fmad=false), so that the replay reproduces the forward's masks and the
// gate the march's samples.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace volym_slab {

// rows of the per-ray table (volym_tpu_torch/render/slab.py F_*, N_FEATURES)
constexpr int F_RS = 0, F_RB = 1, F_CS = 2, F_CB = 3, F_TS = 4, F_TB = 5;
constexpr int F_ENTRY = 6, F_EXIT = 7, F_AEXP = 8, F_SIGNOK = 9;
constexpr int F_HX = 10, F_HY = 11, F_HZ = 12;
constexpr int F_CD = 13, F_C2 = 14;
constexpr int N_FEATURES = 15;

// rows of the cone table, per cone direction (slab.py CF_*, CONE_SAMPLES)
constexpr int CF_RS = 0, CF_RB = 1, CF_CS = 2, CF_CB = 3, CF_TS = 4, CF_TB = 5, CF_RATE = 6;
constexpr int CF_STRIDE = 7;
constexpr int CONE_SAMPLES = 8;

// one thread per ray over 16x16 pixel tiles
constexpr int TILE_X = 16, TILE_Y = 16;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return min(max(x, lo), hi);
}

__device__ __forceinline__ float snap(float c, int bits) {
    if (bits == 0) return c;
    const float s = (float)(1 << bits);
    return floorf(c * s + 0.5f) * (1.0f / s);
}

// the texel index of a nearest sample: floor(c + 0.5) on each axis,
// clamp-to-edge.  This is the TPU's box hat, which takes index i where
// c - i lies in [-0.5, 0.5), at every coordinate but one: with subtexel_bits
// 0, c = 0.5 - 2^-25 rounds c + 0.5 up to 1.0 and picks 1 where the hat
// picks 0.  Snapped coordinates (subtexel_bits > 0) are exact.
__device__ __forceinline__ int nearest_index(float rows, float cols, int nr, int nc) {
    const int r = clampi((int)floorf(rows + 0.5f), 0, nr - 1);
    const int c = clampi((int)floorf(cols + 0.5f), 0, nc - 1);
    return r * nc + c;
}

template <typename T>
__device__ __forceinline__ float texel(const T* __restrict__ sl, int idx) {
    return (float)__ldg(sl + idx);
}

// one sample of an (nr, nc) slice at snapped texel coordinates, clamp-to-edge
template <bool BILINEAR, typename T>
__device__ __forceinline__ float sample(const T* __restrict__ sl, float rows, float cols, int nr, int nc) {
    if (BILINEAR) {
        const float r0f = floorf(rows), c0f = floorf(cols);
        const float tr = rows - r0f, tc = cols - c0f;
        const int r0 = clampi((int)r0f, 0, nr - 1), r1 = clampi((int)r0f + 1, 0, nr - 1);
        const int c0 = clampi((int)c0f, 0, nc - 1), c1 = clampi((int)c0f + 1, 0, nc - 1);
        const float v00 = texel(sl, r0 * nc + c0), v01 = texel(sl, r0 * nc + c1);
        const float v10 = texel(sl, r1 * nc + c0), v11 = texel(sl, r1 * nc + c1);
        const float ur = 1.0f - tr, uc = 1.0f - tc;
        return v00 * ur * uc + v01 * ur * tc + v10 * tr * uc + v11 * tr * tc;
    } else {
        return texel(sl, nearest_index(rows, cols, nr, nc));
    }
}

// the two LUT texels and weights of a linear TF lookup: texel centres at
// (i + 0.5) / ln, clamp-to-edge
struct TfTexels {
    int i0, i1;
    float fr, ufr;
};

__device__ __forceinline__ TfTexels tf_texels(float density, float tf_scale, float lmax, int ln) {
    const float c = clampf(density * tf_scale - 0.5f, 0.0f, lmax);
    const float i0f = floorf(c);
    TfTexels t;
    t.fr = c - i0f;
    t.ufr = 1.0f - t.fr;
    t.i0 = (int)i0f;
    t.i1 = min(t.i0 + 1, ln - 1);
    return t;
}

}  // namespace volym_slab
