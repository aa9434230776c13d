// Native geometry kernels: iso-surface extraction + software rasterizer.
//
// Role parity with the reference's native deps (SURVEY §2.3):
//   * PyMCubes ``marching_cubes`` (C++)      -> extract_isosurface()
//   * pytorch3d MeshRasterizer (CUDA)        -> rasterize_mesh()
//   * pyrender OffscreenRenderer (C/OpenGL)  -> rasterize_mesh() + host
//     shading in python (normal-map renders)
//
// Iso-surface, two extractors behind the same buffer protocol:
//   * extract_isosurface_mc() — classic Lorensen-Cline marching cubes
//     topology (one vertex per sign-crossing cell edge, one polygon fan
//     per surface loop in each cell), built constructively: per cell the
//     cut edges are paired on each cube face (asymptotic decider on the
//     ambiguous 4-cut faces, so adjacent cells always agree and the mesh
//     is crack-free), the pairs are walked into closed loops, and each
//     loop is fan-triangulated with outward (decreasing-field) winding.
//     Vertex set and positions are exactly PyMCubes' marching_cubes
//     (``extract_thuman_mesh.py:164``): the same cut edges with the same
//     linear interpolation.  No copied case tables — the 256 cases fall
//     out of the face-pairing walk.
//   * extract_isosurface() — marching tetrahedra over the 5-tet
//     decomposition; denser triangulation of the same surface, kept as
//     the verifiable-by-construction fallback.
//
// Rasterizer: painter-free z-buffer scanline with barycentric output —
// enough for pix_to_face + interpolated attributes (the pytorch3d calls
// at lib/mesh_animation_renderer.py:241-257) and normal shading
// (render_thuman_mesh.py:80-146).
//
// The port's copy of native/mesh_native.cpp (host code, no CUDA).  Built at
// first use by mpsnerf_torch/native/bindings.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread mesh_native.cpp
// into build/mpsnerf_torch/ at the root of the checkout.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// iso-surface extraction
// ---------------------------------------------------------------------------

namespace {

struct V3 { float x, y, z; };

// 5-tetrahedra decomposition of a unit cube (indices into cube corners).
// Corner numbering: bit 0 -> +x, bit 1 -> +y, bit 2 -> +z.
// Cells alternate between this table and its mirror (corner ^ 7) in a
// checkerboard so the face diagonals of adjacent cells coincide — the
// surface is crack-free across cell boundaries.
static const int TETS[5][4] = {
    {0, 1, 2, 4}, {1, 2, 3, 7}, {1, 4, 5, 7}, {2, 4, 6, 7}, {1, 2, 4, 7},
};

static const int CUBE_OFF[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

struct EdgeKey {
    uint64_t a, b;
    bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};
struct EdgeKeyHash {
    size_t operator()(const EdgeKey& k) const {
        return std::hash<uint64_t>()(k.a * 1000003ull ^ k.b);
    }
};

}  // namespace

// grid: nx*ny*nz floats, index = (x*ny + y)*nz + z  (xyz-major like the
// numpy grid the extractor builds).  Returns 0 on success, -1 on overflow.
int extract_isosurface(
    const float* grid, int nx, int ny, int nz, float iso,
    float* out_verts, int max_verts,   // (max_verts, 3)
    int* out_tris, int max_tris,       // (max_tris, 3)
    int* n_verts_out, int* n_tris_out) {

    auto val = [&](int x, int y, int z) -> float {
        return grid[((size_t)x * ny + y) * nz + z];
    };
    auto gid = [&](int x, int y, int z) -> uint64_t {
        return ((uint64_t)x * ny + y) * nz + z;
    };

    std::unordered_map<EdgeKey, int, EdgeKeyHash> edge_verts;
    int nv = 0, nt = 0;

    // emit (or reuse) the interpolated vertex on edge (c0, c1)
    auto edge_vertex = [&](uint64_t g0, uint64_t g1, const V3& p0,
                           const V3& p1, float v0, float v1) -> int {
        EdgeKey key = g0 < g1 ? EdgeKey{g0, g1} : EdgeKey{g1, g0};
        auto it = edge_verts.find(key);
        if (it != edge_verts.end()) return it->second;
        float t = (iso - v0) / (v1 - v0 + 1e-20f);
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        if (nv >= max_verts) return -1;
        out_verts[3 * nv + 0] = p0.x + t * (p1.x - p0.x);
        out_verts[3 * nv + 1] = p0.y + t * (p1.y - p0.y);
        out_verts[3 * nv + 2] = p0.z + t * (p1.z - p0.z);
        edge_verts.emplace(key, nv);
        return nv++;
    };

    for (int x = 0; x + 1 < nx; ++x)
    for (int y = 0; y + 1 < ny; ++y)
    for (int z = 0; z + 1 < nz; ++z) {
        float cv[8];
        V3 cp[8];
        uint64_t cg[8];
        for (int c = 0; c < 8; ++c) {
            int cx = x + CUBE_OFF[c][0];
            int cy = y + CUBE_OFF[c][1];
            int cz = z + CUBE_OFF[c][2];
            cv[c] = val(cx, cy, cz);
            cp[c] = V3{(float)cx, (float)cy, (float)cz};
            cg[c] = gid(cx, cy, cz);
        }
        const int flip = (x ^ y ^ z) & 1 ? 7 : 0;
        for (int t = 0; t < 5; ++t) {
            int tet[4];
            for (int k = 0; k < 4; ++k) tet[k] = TETS[t][k] ^ flip;
            int inside = 0;
            for (int k = 0; k < 4; ++k)
                if (cv[tet[k]] > iso) inside |= (1 << k);
            if (inside == 0 || inside == 15) continue;

            // collect crossing edges of this tet (pairs with opposite sign)
            int tri_idx[4], cnt = 0;
            static const int TET_EDGES[6][2] = {
                {0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
            for (int e = 0; e < 6 && cnt < 4; ++e) {
                int a = tet[TET_EDGES[e][0]], b = tet[TET_EDGES[e][1]];
                bool ia = cv[a] > iso, ib = cv[b] > iso;
                if (ia == ib) continue;
                int vid = edge_vertex(cg[a], cg[b], cp[a], cp[b], cv[a], cv[b]);
                if (vid < 0) return -1;
                tri_idx[cnt++] = vid;
            }
            // one-inside/one-outside -> triangle; two-two -> quad (2 tris)
            if (cnt == 3) {
                if (nt >= max_tris) return -1;
                out_tris[3 * nt + 0] = tri_idx[0];
                out_tris[3 * nt + 1] = tri_idx[1];
                out_tris[3 * nt + 2] = tri_idx[2];
                ++nt;
            } else if (cnt == 4) {
                if (nt + 1 >= max_tris) return -1;
                // crossing-edge enumeration order for the 2-in/2-out cases
                // yields the quad strip (0,1,3,2) — split along (0,3)
                out_tris[3 * nt + 0] = tri_idx[0];
                out_tris[3 * nt + 1] = tri_idx[1];
                out_tris[3 * nt + 2] = tri_idx[3];
                ++nt;
                out_tris[3 * nt + 0] = tri_idx[0];
                out_tris[3 * nt + 1] = tri_idx[3];
                out_tris[3 * nt + 2] = tri_idx[2];
                ++nt;
            }
        }
    }
    *n_verts_out = nv;
    *n_tris_out = nt;
    return 0;
}

// Classic marching-cubes topology, constructed per cell (no case tables).
// Same grid layout / buffer protocol as extract_isosurface().
int extract_isosurface_mc(
    const float* grid, int nx, int ny, int nz, float iso,
    float* out_verts, int max_verts,
    int* out_tris, int max_tris,
    int* n_verts_out, int* n_tris_out) {

    // cube corner c = (bit0, bit1, bit2) -> offset (+x, +y, +z)
    // 12 cube edges as corner pairs: 0-3 along x, 4-7 along y, 8-11 along z
    static const int EDGE_C[12][2] = {
        {0, 1}, {2, 3}, {4, 5}, {6, 7},
        {0, 2}, {1, 3}, {4, 6}, {5, 7},
        {0, 4}, {1, 5}, {2, 6}, {3, 7},
    };
    // 6 faces, corners in perimeter-cyclic order
    static const int FACE_C[6][4] = {
        {0, 2, 6, 4},  // x = 0
        {1, 3, 7, 5},  // x = 1
        {0, 1, 5, 4},  // y = 0
        {2, 3, 7, 6},  // y = 1
        {0, 1, 3, 2},  // z = 0
        {4, 5, 7, 6},  // z = 1
    };
    // edge index for each face's perimeter side (FACE_C[f][i] -> [i+1])
    static const int FACE_E[6][4] = {
        {4, 10, 6, 8},   // (0,2)(2,6)(6,4)... (6,4) is edge {4,6}=6, (4,0)={0,4}=8
        {5, 11, 7, 9},
        {0, 9, 2, 8},
        {1, 11, 3, 10},
        {0, 5, 1, 4},
        {2, 7, 3, 6},
    };

    auto val = [&](int x, int y, int z) -> float {
        return grid[((size_t)x * ny + y) * nz + z];
    };
    auto gid = [&](int x, int y, int z) -> uint64_t {
        return ((uint64_t)x * ny + y) * nz + z;
    };

    std::unordered_map<EdgeKey, int, EdgeKeyHash> edge_verts;
    int nv = 0, nt = 0;

    auto edge_vertex = [&](uint64_t g0, uint64_t g1, const V3& p0,
                           const V3& p1, float v0, float v1) -> int {
        EdgeKey key = g0 < g1 ? EdgeKey{g0, g1} : EdgeKey{g1, g0};
        auto it = edge_verts.find(key);
        if (it != edge_verts.end()) return it->second;
        float t = (iso - v0) / (v1 - v0 + 1e-20f);
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        if (nv >= max_verts) return -1;
        out_verts[3 * nv + 0] = p0.x + t * (p1.x - p0.x);
        out_verts[3 * nv + 1] = p0.y + t * (p1.y - p0.y);
        out_verts[3 * nv + 2] = p0.z + t * (p1.z - p0.z);
        edge_verts.emplace(key, nv);
        return nv++;
    };

    for (int x = 0; x + 1 < nx; ++x)
    for (int y = 0; y + 1 < ny; ++y)
    for (int z = 0; z + 1 < nz; ++z) {
        float cv[8];
        V3 cp[8];
        uint64_t cg[8];
        int config = 0;
        for (int c = 0; c < 8; ++c) {
            int cx = x + CUBE_OFF[c][0];
            int cy = y + CUBE_OFF[c][1];
            int cz = z + CUBE_OFF[c][2];
            cv[c] = val(cx, cy, cz);
            cp[c] = V3{(float)cx, (float)cy, (float)cz};
            cg[c] = gid(cx, cy, cz);
            if (cv[c] > iso) config |= (1 << c);
        }
        if (config == 0 || config == 255) continue;

        // vertex id per cut cube edge (-1 = not cut)
        int evid[12];
        for (int e = 0; e < 12; ++e) {
            int a = EDGE_C[e][0], b = EDGE_C[e][1];
            bool ia = (config >> a) & 1, ib = (config >> b) & 1;
            evid[e] = -1;
            if (ia != ib) {
                evid[e] = edge_vertex(cg[a], cg[b], cp[a], cp[b],
                                      cv[a], cv[b]);
                if (evid[e] < 0) return -1;
            }
        }

        // pair cut edges on each face; every cut edge lies on exactly two
        // faces, so it receives exactly two links -> disjoint closed loops
        int link[12][2];
        int nlink[12] = {0};
        auto add_link = [&](int e0, int e1) {
            link[e0][nlink[e0]++] = e1;
            link[e1][nlink[e1]++] = e0;
        };
        for (int f = 0; f < 6; ++f) {
            int cut[4], ncut = 0;
            for (int i = 0; i < 4; ++i)
                if (evid[FACE_E[f][i]] >= 0) cut[ncut++] = i;
            if (ncut == 2) {
                add_link(FACE_E[f][cut[0]], FACE_E[f][cut[1]]);
            } else if (ncut == 4) {
                // ambiguous face: corners alternate in/out around the
                // perimeter.  Asymptotic decider (Nielson-Hamann): the
                // bilinear saddle value picks which diagonal pair is
                // connected — both adjacent cells see the same four
                // values, so the choice is consistent and crack-free.
                float va = cv[FACE_C[f][0]] - iso, vb = cv[FACE_C[f][1]] - iso;
                float vc = cv[FACE_C[f][2]] - iso, vd = cv[FACE_C[f][3]] - iso;
                float denom = va + vc - vb - vd;
                float saddle = (denom != 0.f)
                    ? (va * vc - vb * vd) / denom
                    : -va;  // degenerate saddle: separate corner 0's pair
                bool corner0_connected = (saddle > 0.f) == (va > 0.f);
                if (corner0_connected) {
                    // diagonal (0,2) joined: loops wrap corners 1 and 3
                    add_link(FACE_E[f][0], FACE_E[f][1]);
                    add_link(FACE_E[f][2], FACE_E[f][3]);
                } else {
                    add_link(FACE_E[f][3], FACE_E[f][0]);
                    add_link(FACE_E[f][1], FACE_E[f][2]);
                }
            }
        }

        // walk the links into loops, orient, fan-triangulate
        bool used[12] = {false};
        for (int e0 = 0; e0 < 12; ++e0) {
            if (evid[e0] < 0 || used[e0]) continue;
            int loop[12], n = 0;
            int prev = -1, cur = e0;
            do {
                used[cur] = true;
                loop[n++] = cur;
                int nxt = (link[cur][0] == prev) ? link[cur][1]
                                                 : link[cur][0];
                prev = cur;
                cur = nxt;
            } while (cur != e0 && n < 12);
            if (n < 3) continue;

            // loop centroid + Newell normal in grid coordinates
            float cx = 0.f, cy2 = 0.f, cz2 = 0.f;
            float nxl = 0.f, nyl = 0.f, nzl = 0.f;
            for (int i = 0; i < n; ++i) {
                const float* p = &out_verts[3 * evid[loop[i]]];
                const float* q = &out_verts[3 * evid[loop[(i + 1) % n]]];
                cx += p[0]; cy2 += p[1]; cz2 += p[2];
                nxl += (p[1] - q[1]) * (p[2] + q[2]);
                nyl += (p[2] - q[2]) * (p[0] + q[0]);
                nzl += (p[0] - q[0]) * (p[1] + q[1]);
            }
            cx /= n; cy2 /= n; cz2 /= n;
            // field gradient of the trilinear interpolant at the centroid
            float u = cx - x, v = cy2 - y, w = cz2 - z;
            float gx = 0.f, gy = 0.f, gz = 0.f;
            for (int c = 0; c < 8; ++c) {
                float wu = CUBE_OFF[c][0] ? u : 1.f - u;
                float wv = CUBE_OFF[c][1] ? v : 1.f - v;
                float ww = CUBE_OFF[c][2] ? w : 1.f - w;
                float su = CUBE_OFF[c][0] ? 1.f : -1.f;
                float sv = CUBE_OFF[c][1] ? 1.f : -1.f;
                float sw = CUBE_OFF[c][2] ? 1.f : -1.f;
                gx += su * wv * ww * cv[c];
                gy += sv * wu * ww * cv[c];
                gz += sw * wu * wv * cv[c];
            }
            // outward winding: normal opposes the gradient (points from
            // the >iso side to the <iso side, i.e. out of the body)
            bool flip = (nxl * gx + nyl * gy + nzl * gz) > 0.f;
            for (int i = 1; i + 1 < n; ++i) {
                if (nt >= max_tris) return -1;
                int a = evid[loop[0]];
                int b = evid[loop[flip ? i + 1 : i]];
                int c = evid[loop[flip ? i : i + 1]];
                out_tris[3 * nt + 0] = a;
                out_tris[3 * nt + 1] = b;
                out_tris[3 * nt + 2] = c;
                ++nt;
            }
        }
    }
    *n_verts_out = nv;
    *n_tris_out = nt;
    return 0;
}

// ---------------------------------------------------------------------------
// z-buffer rasterizer with barycentric output
// ---------------------------------------------------------------------------

// verts_screen: (n_verts, 3) = (x_pix, y_pix, depth); tris: (n_tris, 3).
// Outputs per pixel: pix_to_face (H*W, init -1), bary (H*W*3), zbuf (H*W).
void rasterize_mesh(
    const float* verts, int n_verts,
    const int* tris, int n_tris,
    int height, int width,
    int* pix_to_face, float* bary, float* zbuf) {

    for (int i = 0; i < height * width; ++i) {
        pix_to_face[i] = -1;
        zbuf[i] = 1e30f;
        bary[3 * i] = bary[3 * i + 1] = bary[3 * i + 2] = 0.f;
    }

    for (int f = 0; f < n_tris; ++f) {
        const int i0 = tris[3 * f], i1 = tris[3 * f + 1], i2 = tris[3 * f + 2];
        const float x0 = verts[3 * i0], y0 = verts[3 * i0 + 1], z0 = verts[3 * i0 + 2];
        const float x1 = verts[3 * i1], y1 = verts[3 * i1 + 1], z1 = verts[3 * i1 + 2];
        const float x2 = verts[3 * i2], y2 = verts[3 * i2 + 1], z2 = verts[3 * i2 + 2];
        if (z0 <= 0.f || z1 <= 0.f || z2 <= 0.f) continue;  // behind camera

        const float denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
        if (std::fabs(denom) < 1e-12f) continue;  // degenerate

        int xmin = (int)std::floor(std::fmin(x0, std::fmin(x1, x2)));
        int xmax = (int)std::ceil(std::fmax(x0, std::fmax(x1, x2)));
        int ymin = (int)std::floor(std::fmin(y0, std::fmin(y1, y2)));
        int ymax = (int)std::ceil(std::fmax(y0, std::fmax(y1, y2)));
        if (xmin < 0) xmin = 0;
        if (ymin < 0) ymin = 0;
        if (xmax >= width) xmax = width - 1;
        if (ymax >= height) ymax = height - 1;

        for (int py = ymin; py <= ymax; ++py)
        for (int px = xmin; px <= xmax; ++px) {
            const float fx = px + 0.5f, fy = py + 0.5f;
            float w0 = ((y1 - y2) * (fx - x2) + (x2 - x1) * (fy - y2)) / denom;
            float w1 = ((y2 - y0) * (fx - x2) + (x0 - x2) * (fy - y2)) / denom;
            float w2 = 1.f - w0 - w1;
            if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
            // perspective-correct depth: interpolate 1/z
            float inv_z = w0 / z0 + w1 / z1 + w2 / z2;
            float z = 1.f / inv_z;
            int idx = py * width + px;
            if (z < zbuf[idx]) {
                zbuf[idx] = z;
                pix_to_face[idx] = f;
                // perspective-correct barycentrics
                bary[3 * idx + 0] = (w0 / z0) * z;
                bary[3 * idx + 1] = (w1 / z1) * z;
                bary[3 * idx + 2] = (w2 / z2) * z;
            }
        }
    }
}

}  // extern "C"
