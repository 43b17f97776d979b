// Native host warp inner loops: trilinear / nearest gather.
//
// Reference: elektronn2/data/transformations.py::map_coordinates_linear,
// map_coordinates_nearest — numba @jit(nopython=True) inner loops in the
// reference; here a small C++ core (ctypes ABI, like malis_core.cpp) with
// the vectorised-numpy implementation as the always-available fallback and
// the semantics oracle. Semantics matched exactly:
//   linear:  c0 = clamp(floor(c), 0, max(dim-2, 0)); c1 = min(c0+1, dim-1);
//            frac = clamp(c - floor(c), 0, 1); float32 accumulation.
//   nearest: c = clamp(nearbyint(c), 0, dim-1)   (round-half-to-even, as
//            np.rint).
// Multi-threaded over output points (std::thread; the GIL is released
// around the ctypes call so data workers overlap).

#include <cfenv>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
    unsigned nt = std::thread::hardware_concurrency();
    if (nt <= 1 || n < 1 << 14) {
        fn((int64_t)0, n);
        return;
    }
    if (nt > 16) nt = 16;
    std::vector<std::thread> ts;
    int64_t chunk = (n + nt - 1) / nt;
    for (unsigned t = 0; t < nt; ++t) {
        int64_t a = t * chunk, b = std::min<int64_t>(n, a + chunk);
        if (a >= b) break;
        ts.emplace_back([=] { fn(a, b); });
    }
    for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// src: (F, Z, X, Y) float32 contiguous; coords: (3, N) float64 (row-major:
// z row then x row then y row — double, so floor/frac match the numpy
// oracle bit-for-bit even for out-of-bounds coords, where the border
// clamp makes frac/index rounding visible); out: (F, N) float32.
void warp_map_linear_f32(const float* src, int64_t F, int64_t Z, int64_t X,
                         int64_t Y, const double* coords, int64_t N,
                         float* out) {
    const double* cz = coords;
    const double* cx = coords + N;
    const double* cy = coords + 2 * N;
    const int64_t sz = X * Y, sf = Z * X * Y;
    parallel_for(N, [&](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; ++i) {
            double fz = std::floor(cz[i]), fx = std::floor(cx[i]),
                   fy = std::floor(cy[i]);
            int64_t z0 = clampi((int64_t)fz, 0, Z >= 2 ? Z - 2 : 0);
            int64_t x0 = clampi((int64_t)fx, 0, X >= 2 ? X - 2 : 0);
            int64_t y0 = clampi((int64_t)fy, 0, Y >= 2 ? Y - 2 : 0);
            int64_t z1 = std::min(z0 + 1, Z - 1);
            int64_t x1 = std::min(x0 + 1, X - 1);
            int64_t y1 = std::min(y0 + 1, Y - 1);
            float tz = (float)(cz[i] - fz), tx = (float)(cx[i] - fx),
                  ty = (float)(cy[i] - fy);
            tz = tz < 0.f ? 0.f : (tz > 1.f ? 1.f : tz);
            tx = tx < 0.f ? 0.f : (tx > 1.f ? 1.f : tx);
            ty = ty < 0.f ? 0.f : (ty > 1.f ? 1.f : ty);
            const float w000 = (1 - tz) * (1 - tx) * (1 - ty);
            const float w001 = (1 - tz) * (1 - tx) * ty;
            const float w010 = (1 - tz) * tx * (1 - ty);
            const float w011 = (1 - tz) * tx * ty;
            const float w100 = tz * (1 - tx) * (1 - ty);
            const float w101 = tz * (1 - tx) * ty;
            const float w110 = tz * tx * (1 - ty);
            const float w111 = tz * tx * ty;
            const int64_t b00 = z0 * sz + x0 * Y, b01 = z0 * sz + x1 * Y;
            const int64_t b10 = z1 * sz + x0 * Y, b11 = z1 * sz + x1 * Y;
            for (int64_t f = 0; f < F; ++f) {
                const float* s = src + f * sf;
                out[f * N + i] =
                    s[b00 + y0] * w000 + s[b00 + y1] * w001 +
                    s[b01 + y0] * w010 + s[b01 + y1] * w011 +
                    s[b10 + y0] * w100 + s[b10 + y1] * w101 +
                    s[b11 + y0] * w110 + s[b11 + y1] * w111;
            }
        }
    });
}

// nearest gather, int32 source (labels). Same coords layout.
void warp_map_nearest_i32(const int32_t* src, int64_t F, int64_t Z,
                          int64_t X, int64_t Y, const double* coords,
                          int64_t N, int32_t* out) {
    const double* cz = coords;
    const double* cx = coords + N;
    const double* cy = coords + 2 * N;
    const int64_t sz = X * Y, sf = Z * X * Y;
    parallel_for(N, [&](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; ++i) {
            // np.rint == round-half-to-even == nearbyint in the default
            // FE_TONEAREST mode
            int64_t z = clampi((int64_t)std::nearbyint(cz[i]), 0, Z - 1);
            int64_t x = clampi((int64_t)std::nearbyint(cx[i]), 0, X - 1);
            int64_t y = clampi((int64_t)std::nearbyint(cy[i]), 0, Y - 1);
            const int64_t off = z * sz + x * Y + y;
            for (int64_t f = 0; f < F; ++f)
                out[f * N + i] = src[f * sf + off];
        }
    });
}

}  // extern "C"
