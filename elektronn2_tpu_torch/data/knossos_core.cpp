// Native KNOSSOS cube loader: parallel raw-cube reads + cache-blocked
// (z,y,x) -> (z,x,y) transpose.
//
// Reference: elektronn2/data/knossos_array.py::KnossosArray uses forked
// worker processes to prefetch cubes; the per-cube work there is
// numpy fromfile + a strided transpose-copy. Here the whole per-cube path
// (pread + transpose) runs GIL-free in C++, so a thread pool scales with
// host cores and the transpose is cache-blocked instead of numpy's
// byte-strided copy. Python keeps ALL cache/LRU/placement logic
// (data/knossos_array.py) -- this core only fills a contiguous
// (n, e, e, e) cube buffer.
//
// Layout contract: a KNOSSOS .raw cube is x-fastest, i.e. (z, y, x) in C
// order. The framework's axis order is (z, x, y), so cube[z][x][y] =
// file[z][y][x]: one e*e 2D transpose per z-plane.
//
// Status codes per cube: 0 = loaded, 1 = file missing (output zero-filled,
// matching the Python path's missing-cube semantics), -1 = short read /
// size mismatch, -2 = open/read error other than ENOENT.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Cache-blocked in-place-free transpose of one z-plane:
// dst[x*e + y] = src[y*e + x], items of `isz` bytes.
template <typename T>
void transpose_plane(const T* src, T* dst, int64_t e) {
    constexpr int64_t B = 64;
    for (int64_t yb = 0; yb < e; yb += B) {
        int64_t ymax = yb + B < e ? yb + B : e;
        for (int64_t xb = 0; xb < e; xb += B) {
            int64_t xmax = xb + B < e ? xb + B : e;
            for (int64_t y = yb; y < ymax; ++y) {
                const T* s = src + y * e;
                for (int64_t x = xb; x < xmax; ++x)
                    dst[x * e + y] = s[x];
            }
        }
    }
}

template <typename T>
void load_one(const char* path, T* out, int64_t e, int32_t* status,
              std::vector<T>& scratch) {
    const int64_t n_items = e * e * e;
    FILE* f = std::fopen(path, "rb");
    if (!f) {
        std::memset(out, 0, n_items * sizeof(T));
        *status = (errno == ENOENT) ? 1 : -2;
        return;
    }
    size_t got = std::fread(scratch.data(), sizeof(T), (size_t)n_items, f);
    // a trailing byte means the file is LARGER than e^3 items -> mismatch
    int extra = std::fgetc(f);
    std::fclose(f);
    if (got != (size_t)n_items || extra != EOF) {
        std::memset(out, 0, n_items * sizeof(T));
        *status = -1;
        return;
    }
    for (int64_t z = 0; z < e; ++z)
        transpose_plane<T>(scratch.data() + z * e * e, out + z * e * e, e);
    *status = 0;
}

// outs[i] points at cube i's own e^3-item destination buffer (separately
// allocated on the Python side so the LRU cache can free cubes
// independently -- a single batch allocation would pin the whole batch
// for as long as any one cube stays cached).
template <typename T>
void load_cubes(const char** paths, int64_t n, int64_t e, T* const* outs,
                int32_t* status, int64_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<T> scratch((size_t)(e * e * e));
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            load_one<T>(paths[i], outs[i], e, status + i, scratch);
        }
    };
    if (n_threads == 1) {
        worker();
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve((size_t)n_threads);
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

// Direct sub-volume assembly: read cube i and write its (clipped)
// transposed content straight into the destination volume `out` of shape
// (Zo, Xo, Yo) in (z, x, y) C order. off[3*i..] = (dz, dx, dy) placement
// of the cube's origin relative to the request origin (may be negative or
// extend past the volume -- clipped). Missing cubes zero-fill their
// clipped region. This skips the per-cube Python buffer + numpy scatter
// pass entirely (one read + one transposed write per cube).
template <typename T>
void assemble_one(const char* path, T* out, int64_t Zo, int64_t Xo,
                  int64_t Yo, const int64_t* off, int64_t e,
                  int32_t* status, std::vector<T>& scratch,
                  std::vector<T>& plane) {
    int64_t dz = off[0], dx = off[1], dy = off[2];
    int64_t z0 = dz > 0 ? dz : 0, z1 = dz + e < Zo ? dz + e : Zo;
    int64_t x0 = dx > 0 ? dx : 0, x1 = dx + e < Xo ? dx + e : Xo;
    int64_t y0 = dy > 0 ? dy : 0, y1 = dy + e < Yo ? dy + e : Yo;
    if (z0 >= z1 || x0 >= x1 || y0 >= y1) { *status = 0; return; }

    FILE* f = std::fopen(path, "rb");
    bool ok = false;
    if (f) {
        size_t got = std::fread(scratch.data(), sizeof(T),
                                (size_t)(e * e * e), f);
        int extra = std::fgetc(f);
        std::fclose(f);
        if (got == (size_t)(e * e * e) && extra == EOF) {
            ok = true;
        } else {
            *status = -1;
            return;
        }
    } else if (errno != ENOENT) {
        *status = -2;
        return;
    }
    for (int64_t z = z0; z < z1; ++z) {
        T* dst_plane = out + z * Xo * Yo;
        if (!ok) {
            for (int64_t x = x0; x < x1; ++x)
                std::memset(dst_plane + x * Yo + y0, 0,
                            (size_t)(y1 - y0) * sizeof(T));
            continue;
        }
        // file plane z-dz is (y, x); transpose to (x, y) then memcpy rows
        transpose_plane<T>(scratch.data() + (z - dz) * e * e, plane.data(),
                           e);
        for (int64_t x = x0; x < x1; ++x)
            std::memcpy(dst_plane + x * Yo + y0,
                        plane.data() + (x - dx) * e + (y0 - dy),
                        (size_t)(y1 - y0) * sizeof(T));
    }
    *status = ok ? 0 : 1;
}

template <typename T>
void assemble(const char** paths, int64_t n, int64_t e, T* out,
              int64_t Zo, int64_t Xo, int64_t Yo, const int64_t* offs,
              int32_t* status, int64_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<T> scratch((size_t)(e * e * e));
        std::vector<T> plane((size_t)(e * e));
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            assemble_one<T>(paths[i], out, Zo, Xo, Yo, offs + 3 * i, e,
                            status + i, scratch, plane);
        }
    };
    if (n_threads == 1) {
        worker();
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve((size_t)n_threads);
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void knossos_load_cubes_u8(const char** paths, int64_t n, int64_t e,
                           uint8_t* const* outs, int32_t* status,
                           int64_t n_threads) {
    load_cubes<uint8_t>(paths, n, e, outs, status, n_threads);
}

void knossos_load_cubes_u16(const char** paths, int64_t n, int64_t e,
                            uint16_t* const* outs, int32_t* status,
                            int64_t n_threads) {
    load_cubes<uint16_t>(paths, n, e, outs, status, n_threads);
}

void knossos_load_cubes_f32(const char** paths, int64_t n, int64_t e,
                            float* const* outs, int32_t* status,
                            int64_t n_threads) {
    load_cubes<float>(paths, n, e, outs, status, n_threads);
}

void knossos_assemble_u8(const char** paths, int64_t n, int64_t e,
                         uint8_t* out, int64_t Zo, int64_t Xo, int64_t Yo,
                         const int64_t* offs, int32_t* status,
                         int64_t n_threads) {
    assemble<uint8_t>(paths, n, e, out, Zo, Xo, Yo, offs, status,
                      n_threads);
}

void knossos_assemble_u16(const char** paths, int64_t n, int64_t e,
                          uint16_t* out, int64_t Zo, int64_t Xo,
                          int64_t Yo, const int64_t* offs, int32_t* status,
                          int64_t n_threads) {
    assemble<uint16_t>(paths, n, e, out, Zo, Xo, Yo, offs, status,
                       n_threads);
}

void knossos_assemble_f32(const char** paths, int64_t n, int64_t e,
                          float* out, int64_t Zo, int64_t Xo, int64_t Yo,
                          const int64_t* offs, int32_t* status,
                          int64_t n_threads) {
    assemble<float>(paths, n, e, out, Zo, Xo, Yo, offs, status, n_threads);
}

}  // extern "C"
