// Native loaders/builders for the path tracer's host side.
//
// The reference does its host-side heavy lifting in native code: assimp
// mesh import (mesh.cpp:53-120) and the recursive BVH build with parallel
// sorts (bvh.cpp:6-61). This module is the equivalent for the new
// framework: a fast OBJ parser and the uniform-leaf cluster-BVH build
// (median split on the centroid's longest axis — same layout as the numpy
// fallback in scene/bvh.py). Exposed through a plain C ABI for ctypes.
//
// Build: make -C hobbyraytracer_tpu/native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct MeshData {
    std::vector<float> verts;    // V*3
    std::vector<float> normals;  // V*3
    std::vector<float> uvs;      // V*2
    std::vector<int32_t> indices; // T*3
};

// fast float parse (strtof is fine; avoid iostream)
inline const char* skip_ws(const char* p) {
    while (*p == ' ' || *p == '\t') ++p;
    return p;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- OBJ parse

void* hrt_parse_obj(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::string buf(static_cast<size_t>(size), '\0');
    if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
        std::fclose(f);
        return nullptr;
    }
    std::fclose(f);

    std::vector<float> pos, nrm_in, uv_in;
    auto* mesh = new MeshData();
    // corner dedup: key = (v,vt,vn) packed
    std::unordered_map<uint64_t, int32_t> corner_map;
    corner_map.reserve(1 << 16);
    std::vector<int32_t> face_corners;

    const char* p = buf.data();
    const char* end = p + buf.size();
    while (p < end) {
        const char* line_end = static_cast<const char*>(
            std::memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        p = skip_ws(p);
        if (p[0] == 'v' && p[1] == ' ') {
            char* q = const_cast<char*>(p) + 2;
            float x = std::strtof(q, &q);
            float y = std::strtof(q, &q);
            float z = std::strtof(q, &q);
            pos.insert(pos.end(), {x, y, z});
        } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') {
            char* q = const_cast<char*>(p) + 3;
            float x = std::strtof(q, &q);
            float y = std::strtof(q, &q);
            float z = std::strtof(q, &q);
            nrm_in.insert(nrm_in.end(), {x, y, z});
        } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
            char* q = const_cast<char*>(p) + 3;
            float u = std::strtof(q, &q);
            float v = std::strtof(q, &q);
            // assimp FlipUVs equivalence (mesh.cpp:56 / objloader.py)
            uv_in.insert(uv_in.end(), {u, 1.0f - v});
        } else if (p[0] == 'f' && p[1] == ' ') {
            face_corners.clear();
            const char* q = p + 2;
            while (q < line_end) {
                q = skip_ws(q);
                if (q >= line_end || *q == '\r' || *q == '\n') break;
                long vi = std::strtol(q, const_cast<char**>(&q), 10);
                long ti = 0, ni = 0;
                bool has_t = false, has_n = false;
                if (*q == '/') {
                    ++q;
                    if (*q != '/') {
                        ti = std::strtol(q, const_cast<char**>(&q), 10);
                        has_t = true;
                    }
                    if (*q == '/') {
                        ++q;
                        ni = std::strtol(q, const_cast<char**>(&q), 10);
                        has_n = true;
                    }
                }
                auto resolve = [](long idx, size_t n) -> int64_t {
                    return idx > 0 ? idx - 1
                                   : static_cast<int64_t>(n) + idx;
                };
                int64_t v = resolve(vi, pos.size() / 3);
                int64_t t = has_t ? resolve(ti, uv_in.size() / 2) : -1;
                int64_t n = has_n ? resolve(ni, nrm_in.size() / 3) : -1;
                // 21-bit key packing: indices >= 2^21-1 would collide
                // (0x1FFFFF doubles as the missing-attribute sentinel) —
                // bail out so callers use the exact python parser instead
                if (v >= 0x1FFFFF || t >= 0x1FFFFF || n >= 0x1FFFFF ||
                    v < 0) {
                    delete mesh;
                    return nullptr;
                }
                uint64_t key = (static_cast<uint64_t>(v) & 0x1FFFFF)
                             | ((static_cast<uint64_t>(t) & 0x1FFFFF) << 21)
                             | ((static_cast<uint64_t>(n) & 0x1FFFFF) << 42);
                auto it = corner_map.find(key);
                int32_t cid;
                if (it != corner_map.end()) {
                    cid = it->second;
                } else {
                    cid = static_cast<int32_t>(mesh->verts.size() / 3);
                    mesh->verts.insert(mesh->verts.end(),
                                       {pos[v * 3], pos[v * 3 + 1],
                                        pos[v * 3 + 2]});
                    if (n >= 0)
                        mesh->normals.insert(mesh->normals.end(),
                                             {nrm_in[n * 3],
                                              nrm_in[n * 3 + 1],
                                              nrm_in[n * 3 + 2]});
                    else  // zero-fill like the reference (mesh.cpp:87-99)
                        mesh->normals.insert(mesh->normals.end(),
                                             {0.f, 0.f, 0.f});
                    if (t >= 0)
                        mesh->uvs.insert(mesh->uvs.end(),
                                         {uv_in[t * 2], uv_in[t * 2 + 1]});
                    else
                        mesh->uvs.insert(mesh->uvs.end(), {0.f, 0.f});
                    corner_map.emplace(key, cid);
                }
                face_corners.push_back(cid);
            }
            // fan triangulation (assimp aiProcess_Triangulate equivalent)
            for (size_t i = 1; i + 1 < face_corners.size(); ++i) {
                mesh->indices.insert(mesh->indices.end(),
                                     {face_corners[0], face_corners[i],
                                      face_corners[i + 1]});
            }
        }
        p = line_end + 1;
    }
    if (mesh->indices.empty()) {
        delete mesh;
        return nullptr;
    }
    return mesh;
}

void hrt_mesh_counts(void* h, int32_t* n_verts, int32_t* n_tris) {
    auto* m = static_cast<MeshData*>(h);
    *n_verts = static_cast<int32_t>(m->verts.size() / 3);
    *n_tris = static_cast<int32_t>(m->indices.size() / 3);
}

void hrt_mesh_copy(void* h, float* verts, float* normals, float* uvs,
                   int32_t* indices) {
    auto* m = static_cast<MeshData*>(h);
    std::memcpy(verts, m->verts.data(), m->verts.size() * sizeof(float));
    std::memcpy(normals, m->normals.data(),
                m->normals.size() * sizeof(float));
    std::memcpy(uvs, m->uvs.data(), m->uvs.size() * sizeof(float));
    std::memcpy(indices, m->indices.data(),
                m->indices.size() * sizeof(int32_t));
}

void hrt_mesh_free(void* h) { delete static_cast<MeshData*>(h); }

// ------------------------------------------------------------ cluster BVH

// Median split on centroid's longest axis until <= leaf_size, uniform
// padded leaves (mirror of scene/bvh.py::build_clusters; reference build:
// bvh.cpp:6-61). Returns K (number of clusters) or -1 if max_k too small.
int32_t hrt_build_clusters(const float* verts, int32_t n_verts,
                           const int32_t* indices, int32_t n_tris,
                           int32_t leaf_size, int32_t max_k,
                           int32_t* tri_id /* max_k*leaf_size */,
                           float* bmin /* max_k*3 */,
                           float* bmax /* max_k*3 */) {
    (void)n_verts;
    std::vector<float> cx(n_tris), cy(n_tris), cz(n_tris);
    for (int32_t t = 0; t < n_tris; ++t) {
        const int32_t* tri = indices + 3 * t;
        float sx = 0, sy = 0, sz = 0;
        for (int k = 0; k < 3; ++k) {
            const float* v = verts + 3 * tri[k];
            sx += v[0]; sy += v[1]; sz += v[2];
        }
        cx[t] = sx / 3; cy[t] = sy / 3; cz[t] = sz / 3;
    }
    const float* cents[3] = {cx.data(), cy.data(), cz.data()};

    std::vector<int32_t> order(n_tris);
    std::iota(order.begin(), order.end(), 0);
    int32_t k_out = 0;

    // iterative stack of [begin, end) ranges
    std::vector<std::pair<int32_t, int32_t>> stack{{0, n_tris}};
    while (!stack.empty()) {
        auto [b, e] = stack.back();
        stack.pop_back();
        int32_t n = e - b;
        if (n <= leaf_size) {
            if (k_out >= max_k) return -1;
            int32_t* ids = tri_id + static_cast<int64_t>(k_out) * leaf_size;
            float lo[3] = {1e30f, 1e30f, 1e30f};
            float hi[3] = {-1e30f, -1e30f, -1e30f};
            for (int32_t i = 0; i < leaf_size; ++i) {
                if (i < n) {
                    int32_t t = order[b + i];
                    ids[i] = t;
                    for (int c = 0; c < 3; ++c) {
                        const int32_t* tri = indices + 3 * t;
                        for (int ax = 0; ax < 3; ++ax) {
                            float v = verts[3 * tri[c] + ax];
                            lo[ax] = std::min(lo[ax], v);
                            hi[ax] = std::max(hi[ax], v);
                        }
                    }
                } else {
                    ids[i] = -1;
                }
            }
            for (int ax = 0; ax < 3; ++ax) {
                bmin[3 * k_out + ax] = lo[ax] - 1e-4f;
                bmax[3 * k_out + ax] = hi[ax] + 1e-4f;
            }
            ++k_out;
            continue;
        }
        // longest centroid axis
        float lo[3] = {1e30f, 1e30f, 1e30f};
        float hi[3] = {-1e30f, -1e30f, -1e30f};
        for (int32_t i = b; i < e; ++i) {
            for (int ax = 0; ax < 3; ++ax) {
                float v = cents[ax][order[i]];
                lo[ax] = std::min(lo[ax], v);
                hi[ax] = std::max(hi[ax], v);
            }
        }
        int axis = 0;
        float ext = hi[0] - lo[0];
        for (int ax = 1; ax < 3; ++ax) {
            if (hi[ax] - lo[ax] > ext) { ext = hi[ax] - lo[ax]; axis = ax; }
        }
        int32_t mid = b + n / 2;
        const float* cc = cents[axis];
        std::nth_element(order.begin() + b, order.begin() + mid,
                         order.begin() + e,
                         [cc](int32_t a, int32_t b2) { return cc[a] < cc[b2]; });
        stack.emplace_back(mid, e);
        stack.emplace_back(b, mid);
    }
    return k_out;
}

// Constrained surface-area-heuristic build (mirror of
// scene/bvh.py::sah_split_order): each node picks BOTH the split axis
// AND the cut position — restricted to multiples of leaf_size so leaves
// stay full — minimizing SA(left)*n_left + SA(right)*n_right over
// prefix/suffix boxes of the axis-sorted range. Same uniform padded
// leaf layout as hrt_build_clusters. Returns K or -1 if max_k too small.
int32_t hrt_build_clusters_sah(const float* verts, int32_t n_verts,
                               const int32_t* indices, int32_t n_tris,
                               int32_t leaf_size, int32_t max_k,
                               int32_t* tri_id, float* bmin, float* bmax) {
    (void)n_verts;
    // per-triangle centroid + bbox, computed once
    std::vector<float> cent(static_cast<size_t>(n_tris) * 3);
    std::vector<float> tlo(static_cast<size_t>(n_tris) * 3);
    std::vector<float> thi(static_cast<size_t>(n_tris) * 3);
    for (int32_t t = 0; t < n_tris; ++t) {
        const int32_t* tri = indices + 3 * t;
        float lo[3] = {1e30f, 1e30f, 1e30f};
        float hi[3] = {-1e30f, -1e30f, -1e30f};
        float s[3] = {0, 0, 0};
        for (int c = 0; c < 3; ++c) {
            const float* v = verts + 3 * tri[c];
            for (int ax = 0; ax < 3; ++ax) {
                lo[ax] = std::min(lo[ax], v[ax]);
                hi[ax] = std::max(hi[ax], v[ax]);
                s[ax] += v[ax];
            }
        }
        for (int ax = 0; ax < 3; ++ax) {
            cent[3 * t + ax] = s[ax] / 3;
            tlo[3 * t + ax] = lo[ax];
            thi[3 * t + ax] = hi[ax];
        }
    }

    std::vector<int32_t> order(n_tris);
    std::iota(order.begin(), order.end(), 0);
    std::vector<int32_t> scratch(n_tris), best_order(n_tris);
    // prefix/suffix surface areas for the current node's sorted range
    std::vector<float> sa_l(n_tris), sa_r(n_tris);

    auto surface = [](const float lo[3], const float hi[3]) {
        float e0 = hi[0] - lo[0], e1 = hi[1] - lo[1], e2 = hi[2] - lo[2];
        return 2.0f * (e0 * e1 + e1 * e2 + e0 * e2);
    };

    int32_t k_out = 0;
    std::vector<std::pair<int32_t, int32_t>> stack{{0, n_tris}};
    while (!stack.empty()) {
        auto [b, e] = stack.back();
        stack.pop_back();
        int32_t n = e - b;
        if (n <= leaf_size) {
            if (k_out >= max_k) return -1;
            int32_t* ids = tri_id + static_cast<int64_t>(k_out) * leaf_size;
            float lo[3] = {1e30f, 1e30f, 1e30f};
            float hi[3] = {-1e30f, -1e30f, -1e30f};
            for (int32_t i = 0; i < leaf_size; ++i) {
                if (i < n) {
                    int32_t t = order[b + i];
                    ids[i] = t;
                    for (int ax = 0; ax < 3; ++ax) {
                        lo[ax] = std::min(lo[ax], tlo[3 * t + ax]);
                        hi[ax] = std::max(hi[ax], thi[3 * t + ax]);
                    }
                } else {
                    ids[i] = -1;
                }
            }
            for (int ax = 0; ax < 3; ++ax) {
                bmin[3 * k_out + ax] = lo[ax] - 1e-4f;
                bmax[3 * k_out + ax] = hi[ax] + 1e-4f;
            }
            ++k_out;
            continue;
        }
        float best_cost = 1e38f;
        int32_t best_cut = b + n / 2;
        for (int ax = 0; ax < 3; ++ax) {
            std::copy(order.begin() + b, order.begin() + e,
                      scratch.begin());
            const float* cc = cent.data();
            std::sort(scratch.begin(), scratch.begin() + n,
                      [cc, ax](int32_t a, int32_t b2) {
                          return cc[3 * a + ax] < cc[3 * b2 + ax];
                      });
            float lo[3] = {1e30f, 1e30f, 1e30f};
            float hi[3] = {-1e30f, -1e30f, -1e30f};
            for (int32_t i = 0; i < n; ++i) {
                int32_t t = scratch[i];
                for (int a2 = 0; a2 < 3; ++a2) {
                    lo[a2] = std::min(lo[a2], tlo[3 * t + a2]);
                    hi[a2] = std::max(hi[a2], thi[3 * t + a2]);
                }
                sa_l[i] = surface(lo, hi);
            }
            float rlo[3] = {1e30f, 1e30f, 1e30f};
            float rhi[3] = {-1e30f, -1e30f, -1e30f};
            for (int32_t i = n - 1; i >= 0; --i) {
                int32_t t = scratch[i];
                for (int a2 = 0; a2 < 3; ++a2) {
                    rlo[a2] = std::min(rlo[a2], tlo[3 * t + a2]);
                    rhi[a2] = std::max(rhi[a2], thi[3 * t + a2]);
                }
                sa_r[i] = surface(rlo, rhi);
            }
            for (int32_t c = leaf_size; c < n; c += leaf_size) {
                float cost = sa_l[c - 1] * c + sa_r[c] * (n - c);
                if (cost < best_cost) {
                    best_cost = cost;
                    best_cut = b + c;
                    std::copy(scratch.begin(), scratch.begin() + n,
                              best_order.begin() + b);
                }
            }
        }
        std::copy(best_order.begin() + b, best_order.begin() + e,
                  order.begin() + b);
        stack.emplace_back(best_cut, e);
        stack.emplace_back(b, best_cut);
    }
    return k_out;
}

}  // extern "C"
