// Exact surface voxelization: mark every grid cell whose axis-aligned box
// intersects any triangle of the mesh (separating-axis test, the standard
// 13-axis triangle/AABB overlap of Akenine-Moller).
//
// Counterpart of the reference pipeline's trimesh.voxelized() shell
// voxelization (util/mesh_metrics.py:13-21). The round-1 implementation
// approximated this by dense surface sampling, which misses cells the
// surface only grazes (~12% of shell cells for a sphere at pitch 1.1875);
// this kernel is exact, so compute_iou matches an exact voxelizer's output.

#include <cstdint>
#include <cmath>
#include <algorithm>

namespace {

inline void cross3(const float a[3], const float b[3], float out[3]) {
    out[0] = a[1] * b[2] - a[2] * b[1];
    out[1] = a[2] * b[0] - a[0] * b[2];
    out[2] = a[0] * b[1] - a[1] * b[0];
}

inline float dot3(const float a[3], const float b[3]) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Triangle/box overlap with box centered at origin, half-extents h.
// v0,v1,v2 are triangle vertices relative to the box center.
bool tri_box_overlap(const float v0[3], const float v1[3], const float v2[3],
                     const float h[3]) {
    float e0[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
    float e1[3] = {v2[0] - v1[0], v2[1] - v1[1], v2[2] - v1[2]};
    float e2[3] = {v0[0] - v2[0], v0[1] - v2[1], v0[2] - v2[2]};

    // 1) box axes
    for (int i = 0; i < 3; ++i) {
        float mn = std::min(v0[i], std::min(v1[i], v2[i]));
        float mx = std::max(v0[i], std::max(v1[i], v2[i]));
        if (mn > h[i] || mx < -h[i]) return false;
    }
    // 2) triangle normal axis (plane/box test)
    float n[3];
    cross3(e0, e1, n);
    float r = h[0] * std::fabs(n[0]) + h[1] * std::fabs(n[1]) + h[2] * std::fabs(n[2]);
    float d = dot3(n, v0);
    if (d > r || d < -r) return false;

    // 3) nine cross-product axes: a = unit(i) x edge(j)
    const float* edges[3] = {e0, e1, e2};
    for (int j = 0; j < 3; ++j) {
        const float* e = edges[j];
        // axis = X x e = (0, -e[2], e[1])
        {
            float p0 = -e[2] * v0[1] + e[1] * v0[2];
            float p1 = -e[2] * v1[1] + e[1] * v1[2];
            float p2 = -e[2] * v2[1] + e[1] * v2[2];
            float mn = std::min(p0, std::min(p1, p2)), mx = std::max(p0, std::max(p1, p2));
            float rad = h[1] * std::fabs(e[2]) + h[2] * std::fabs(e[1]);
            if (mn > rad || mx < -rad) return false;
        }
        // axis = Y x e = (e[2], 0, -e[0])
        {
            float p0 = e[2] * v0[0] - e[0] * v0[2];
            float p1 = e[2] * v1[0] - e[0] * v1[2];
            float p2 = e[2] * v2[0] - e[0] * v2[2];
            float mn = std::min(p0, std::min(p1, p2)), mx = std::max(p0, std::max(p1, p2));
            float rad = h[0] * std::fabs(e[2]) + h[2] * std::fabs(e[0]);
            if (mn > rad || mx < -rad) return false;
        }
        // axis = Z x e = (-e[1], e[0], 0)
        {
            float p0 = -e[1] * v0[0] + e[0] * v0[1];
            float p1 = -e[1] * v1[0] + e[0] * v1[1];
            float p2 = -e[1] * v2[0] + e[0] * v2[1];
            float mn = std::min(p0, std::min(p1, p2)), mx = std::max(p0, std::max(p1, p2));
            float rad = h[0] * std::fabs(e[1]) + h[1] * std::fabs(e[0]);
            if (mn > rad || mx < -rad) return false;
        }
    }
    return true;
}

}  // namespace

extern "C" {

// verts: (V, 3) f32 already divided by pitch and shifted so the grid origin
// is cell (0,0,0); tris: (T, 3) i32; grid: (nx, ny, nz) uint8, C-order,
// zero-initialized by the caller. Marks grid[c]=1 for every cell whose unit
// box [c, c+1)^3 intersects a triangle.
void voxelize_mesh(const float* verts, int64_t n_verts,
                   const int32_t* tris, int64_t n_tris,
                   uint8_t* grid, int64_t nx, int64_t ny, int64_t nz) {
    const float h[3] = {0.5f, 0.5f, 0.5f};
    for (int64_t t = 0; t < n_tris; ++t) {
        const float* a = verts + 3 * (int64_t)tris[3 * t + 0];
        const float* b = verts + 3 * (int64_t)tris[3 * t + 1];
        const float* c = verts + 3 * (int64_t)tris[3 * t + 2];
        float lo[3], hi[3];
        for (int i = 0; i < 3; ++i) {
            lo[i] = std::min(a[i], std::min(b[i], c[i]));
            hi[i] = std::max(a[i], std::max(b[i], c[i]));
        }
        int64_t c0[3], c1[3];
        const int64_t dims[3] = {nx, ny, nz};
        bool skip = false;
        for (int i = 0; i < 3; ++i) {
            c0[i] = std::max<int64_t>(0, (int64_t)std::floor(lo[i]));
            c1[i] = std::min<int64_t>(dims[i] - 1, (int64_t)std::floor(hi[i]));
            if (c0[i] > c1[i]) skip = true;
        }
        if (skip) continue;
        for (int64_t x = c0[0]; x <= c1[0]; ++x)
            for (int64_t y = c0[1]; y <= c1[1]; ++y)
                for (int64_t z = c0[2]; z <= c1[2]; ++z) {
                    uint8_t* cell = grid + (x * ny + y) * nz + z;
                    if (*cell) continue;
                    float cx = (float)x + 0.5f, cy = (float)y + 0.5f, cz = (float)z + 0.5f;
                    float v0[3] = {a[0] - cx, a[1] - cy, a[2] - cz};
                    float v1[3] = {b[0] - cx, b[1] - cy, b[2] - cz};
                    float v2[3] = {c[0] - cx, c[1] - cy, c[2] - cz};
                    if (tri_box_overlap(v0, v1, v2, h)) *cell = 1;
                }
    }
}

}  // extern "C"
