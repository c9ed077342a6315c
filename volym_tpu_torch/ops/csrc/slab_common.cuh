// Device helpers shared by the slab march (slab_march.cu) and its replay
// backward (slab_replay.cu): the per-ray table's rows, the subtexel snap,
// the clamp-to-edge slice sample and the TF texel lookup.  Both kernels
// must evaluate these expressions identically, bit for bit (build with
// --fmad=false), so that the replay reproduces the forward's masks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace volym_slab {

// rows of the per-ray table (volym_tpu_torch/render/slab.py F_*)
constexpr int F_RS = 0, F_RB = 1, F_CS = 2, F_CB = 3, F_TS = 4, F_TB = 5;
constexpr int F_ENTRY = 6, F_EXIT = 7, F_AEXP = 8, F_SIGNOK = 9;
constexpr int F_HX = 10, F_HY = 11, F_HZ = 12;

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
        const int r = clampi((int)floorf(rows + 0.5f), 0, nr - 1);
        const int c = clampi((int)floorf(cols + 0.5f), 0, nc - 1);
        return texel(sl, r * nc + c);
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
