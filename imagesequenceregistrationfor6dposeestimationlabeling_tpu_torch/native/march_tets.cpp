// Marching tetrahedra isosurface extraction (host-side native kernel).
//
// Plays the role PyMCubes' C++ marching cubes plays in the reference
// (nerf.py:699-703): the density grid is computed on the card; topology
// extraction is host work and runs here.  Same algorithm and case table as
// ops/mcubes.py (the numpy fallback): the vertex sets and the triangle
// topology agree, the vertex order need not.
//
// Build (native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 march_tets.cpp -o libmarchtets.so

#include <cstdint>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

const int TETS[6][4] = {
    {0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
    {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6},
};

const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// Case table: triangles as tet-edge triples per inside-mask; -1 pads.
const int CASES[16][2][3] = {
    {{-1, -1, -1}, {-1, -1, -1}},  // 0
    {{0, 1, 2}, {-1, -1, -1}},     // 1
    {{0, 4, 3}, {-1, -1, -1}},     // 2
    {{1, 3, 4}, {1, 4, 2}},        // 3
    {{1, 3, 5}, {-1, -1, -1}},     // 4
    {{0, 3, 5}, {0, 5, 2}},        // 5
    {{0, 5, 4}, {0, 1, 5}},        // 6
    {{2, 4, 5}, {-1, -1, -1}},     // 7
    {{2, 5, 4}, {-1, -1, -1}},     // 8
    {{0, 4, 5}, {0, 5, 1}},        // 9
    {{0, 5, 3}, {0, 2, 5}},        // 10
    {{1, 5, 3}, {-1, -1, -1}},     // 11
    {{1, 4, 3}, {1, 2, 4}},        // 12
    {{0, 3, 4}, {-1, -1, -1}},     // 13
    {{0, 2, 1}, {-1, -1, -1}},     // 14
    {{-1, -1, -1}, {-1, -1, -1}},  // 15
};

inline int64_t point_id(int x, int y, int z, int R) {
    return ((int64_t)x * R + y) * R + z;
}

}  // namespace

extern "C" int64_t march_tets(
    const float* density,  // R*R*R, D[x][y][z]
    int R,
    float threshold,
    float* out_verts,      // cap_v * 3
    int64_t* out_tris,     // cap_t * 3
    int64_t cap_v,
    int64_t cap_t,
    int64_t* n_verts_out   // written on success
) {
    // returns number of triangles on success, -1 if capacity exceeded
    std::unordered_map<uint64_t, int64_t> edge_to_vert;
    edge_to_vert.reserve(1 << 18);
    int64_t nv = 0, nt = 0;

    auto D = [&](int x, int y, int z) -> float {
        return density[((int64_t)x * R + y) * R + z];
    };

    float vals[8];
    double pos[8][3];
    for (int cx = 0; cx < R - 1; ++cx) {
        for (int cy = 0; cy < R - 1; ++cy) {
            for (int cz = 0; cz < R - 1; ++cz) {
                int inside_ct = 0;
                for (int c = 0; c < 8; ++c) {
                    int px = cx + CORNERS[c][0], py = cy + CORNERS[c][1], pz = cz + CORNERS[c][2];
                    vals[c] = D(px, py, pz);
                    pos[c][0] = px; pos[c][1] = py; pos[c][2] = pz;
                    if (vals[c] > threshold) ++inside_ct;
                }
                if (inside_ct == 0 || inside_ct == 8) continue;

                for (int t = 0; t < 6; ++t) {
                    const int* tet = TETS[t];
                    int mask = 0;
                    for (int v = 0; v < 4; ++v)
                        if (vals[tet[v]] > threshold) mask |= 1 << v;
                    if (mask == 0 || mask == 15) continue;

                    // inside centroid for winding orientation
                    double icx = 0, icy = 0, icz = 0; int ic = 0;
                    for (int v = 0; v < 4; ++v) {
                        if (mask & (1 << v)) {
                            icx += pos[tet[v]][0]; icy += pos[tet[v]][1]; icz += pos[tet[v]][2];
                            ++ic;
                        }
                    }
                    icx /= ic; icy /= ic; icz /= ic;

                    for (int k = 0; k < 2; ++k) {
                        if (CASES[mask][k][0] < 0) continue;
                        int64_t tri_ids[3];
                        double tri_pos[3][3];
                        for (int e = 0; e < 3; ++e) {
                            int edge = CASES[mask][k][e];
                            int a = tet[TET_EDGES[edge][0]];
                            int b = tet[TET_EDGES[edge][1]];
                            int64_t ida = point_id((int)pos[a][0], (int)pos[a][1], (int)pos[a][2], R);
                            int64_t idb = point_id((int)pos[b][0], (int)pos[b][1], (int)pos[b][2], R);
                            uint64_t key = ida < idb
                                ? ((uint64_t)ida << 32) | (uint64_t)idb
                                : ((uint64_t)idb << 32) | (uint64_t)ida;
                            auto it = edge_to_vert.find(key);
                            double va = vals[a], vb = vals[b];
                            double denom = vb - va;
                            if (std::fabs(denom) < 1e-12) denom = 1e-12;
                            double tt = (threshold - va) / denom;
                            if (tt < 0) tt = 0; if (tt > 1) tt = 1;
                            double px = pos[a][0] + tt * (pos[b][0] - pos[a][0]);
                            double py = pos[a][1] + tt * (pos[b][1] - pos[a][1]);
                            double pz = pos[a][2] + tt * (pos[b][2] - pos[a][2]);
                            int64_t vid;
                            if (it == edge_to_vert.end()) {
                                if (nv >= cap_v) return -1;
                                vid = nv++;
                                edge_to_vert.emplace(key, vid);
                                out_verts[vid * 3 + 0] = (float)px;
                                out_verts[vid * 3 + 1] = (float)py;
                                out_verts[vid * 3 + 2] = (float)pz;
                            } else {
                                vid = it->second;
                            }
                            tri_ids[e] = vid;
                            tri_pos[e][0] = px; tri_pos[e][1] = py; tri_pos[e][2] = pz;
                        }
                        if (tri_ids[0] == tri_ids[1] || tri_ids[1] == tri_ids[2] ||
                            tri_ids[0] == tri_ids[2])
                            continue;
                        // orient away from the inside centroid
                        double e1x = tri_pos[1][0] - tri_pos[0][0], e1y = tri_pos[1][1] - tri_pos[0][1], e1z = tri_pos[1][2] - tri_pos[0][2];
                        double e2x = tri_pos[2][0] - tri_pos[0][0], e2y = tri_pos[2][1] - tri_pos[0][1], e2z = tri_pos[2][2] - tri_pos[0][2];
                        double nx = e1y * e2z - e1z * e2y;
                        double ny = e1z * e2x - e1x * e2z;
                        double nz = e1x * e2y - e1y * e2x;
                        double gx = (tri_pos[0][0] + tri_pos[1][0] + tri_pos[2][0]) / 3 - icx;
                        double gy = (tri_pos[0][1] + tri_pos[1][1] + tri_pos[2][1]) / 3 - icy;
                        double gz = (tri_pos[0][2] + tri_pos[1][2] + tri_pos[2][2]) / 3 - icz;
                        bool flip = nx * gx + ny * gy + nz * gz < 0;
                        if (nt >= cap_t) return -1;
                        out_tris[nt * 3 + 0] = tri_ids[0];
                        out_tris[nt * 3 + 1] = flip ? tri_ids[2] : tri_ids[1];
                        out_tris[nt * 3 + 2] = flip ? tri_ids[1] : tri_ids[2];
                        ++nt;
                    }
                }
            }
        }
    }
    *n_verts_out = nv;
    return nt;
}
