// MALIS maximin pair counting — native core.
//
// Reference: elektronn2/malis/malis_core.cpp (Turaga et al. maximin
// affinity learning): Kruskal-style maximin spanning forest over the
// affinity graph; when an edge merges two components, every newly-connected
// voxel pair has this edge as its maximin edge — accumulate positive
// (same nonzero label) or negative (different nonzero labels) pair counts
// as the edge's loss weight.
//
// Exposed via a plain C ABI (loaded with ctypes — no pybind11 in this
// environment). Arrays are C-contiguous; affinity layout (E, Z, X, Y),
// segmentation (Z, X, Y), neighbourhood (E, 3) int32 offsets in (z, x, y).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <unordered_map>
#include <vector>

namespace {

struct UnionFind {
    std::vector<int64_t> parent;
    std::vector<int8_t> rank;
    // per-root histogram of nonzero ground-truth labels
    std::vector<std::unordered_map<int32_t, int64_t>> counts;

    explicit UnionFind(const int32_t* seg, int64_t n) {
        parent.resize(n);
        std::iota(parent.begin(), parent.end(), 0);
        rank.assign(n, 0);
        counts.resize(n);
        for (int64_t i = 0; i < n; ++i) {
            if (seg[i] != 0) counts[i][seg[i]] = 1;
        }
    }

    int64_t find(int64_t x) {
        int64_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int64_t next = parent[x];
            parent[x] = root;
            x = next;
        }
        return root;
    }

    // merge roots a and b; return (pos_pairs, neg_pairs) newly connected
    void unite(int64_t a, int64_t b, int64_t* pos, int64_t* neg) {
        auto& ca = counts[a];
        auto& cb = counts[b];
        const auto& small = ca.size() <= cb.size() ? ca : cb;
        const auto& big = ca.size() <= cb.size() ? cb : ca;
        int64_t p = 0;
        for (const auto& kv : small) {
            auto it = big.find(kv.first);
            if (it != big.end()) p += kv.second * it->second;
        }
        int64_t la = 0, lb = 0;
        for (const auto& kv : ca) la += kv.second;
        for (const auto& kv : cb) lb += kv.second;
        *pos = p;
        *neg = la * lb - p;
        if (rank[a] < rank[b]) std::swap(a, b);
        parent[b] = a;
        if (rank[a] == rank[b]) ++rank[a];
        auto& dst = counts[a];
        auto& src = counts[b];
        if (dst.size() < src.size()) dst.swap(src);
        for (const auto& kv : src) dst[kv.first] += kv.second;
        src.clear();
    }
};

}  // namespace

extern "C" {

// One maximin pass. out must be zero-initialised, same shape as aff.
void malis_pass(const float* aff, const int32_t* seg, const int32_t* nhood,
                int32_t n_edge_types, int32_t Z, int32_t X, int32_t Y,
                int32_t count_pos, float* out) {
    const int64_t n_vox = (int64_t)Z * X * Y;
    const int64_t s_z = (int64_t)X * Y;
    const int64_t s_x = Y;

    // enumerate valid edges; edge id = flat index into aff (E, Z, X, Y)
    std::vector<int64_t> edge_ids;
    std::vector<int64_t> edge_v, edge_u;
    edge_ids.reserve(n_vox * n_edge_types);
    edge_v.reserve(n_vox * n_edge_types);
    edge_u.reserve(n_vox * n_edge_types);
    for (int32_t e = 0; e < n_edge_types; ++e) {
        const int32_t oz = nhood[e * 3 + 0];
        const int32_t ox = nhood[e * 3 + 1];
        const int32_t oy = nhood[e * 3 + 2];
        for (int32_t z = 0; z < Z; ++z) {
            const int32_t uz = z + oz;
            if (uz < 0 || uz >= Z) continue;
            for (int32_t x = 0; x < X; ++x) {
                const int32_t ux = x + ox;
                if (ux < 0 || ux >= X) continue;
                for (int32_t y = 0; y < Y; ++y) {
                    const int32_t uy = y + oy;
                    if (uy < 0 || uy >= Y) continue;
                    const int64_t v = (int64_t)z * s_z + (int64_t)x * s_x + y;
                    const int64_t u = (int64_t)uz * s_z + (int64_t)ux * s_x
                                      + uy;
                    edge_ids.push_back((int64_t)e * n_vox + v);
                    edge_v.push_back(v);
                    edge_u.push_back(u);
                }
            }
        }
    }

    // sort by affinity descending; stable to match the numpy fallback
    std::vector<int64_t> order(edge_ids.size());
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                         return aff[edge_ids[a]] > aff[edge_ids[b]];
                     });

    UnionFind uf(seg, n_vox);
    for (int64_t k : order) {
        const int64_t ra = uf.find(edge_v[k]);
        const int64_t rb = uf.find(edge_u[k]);
        if (ra == rb) continue;
        int64_t pos = 0, neg = 0;
        uf.unite(ra, rb, &pos, &neg);
        out[edge_ids[k]] = (float)(count_pos ? pos : neg);
    }
}

}
