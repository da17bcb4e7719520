// Native isosurface extraction for TSDF volumes.
//
// TPU-native-framework counterpart of the reference's `marching_cubes` C++
// extension (used via util/visualization.py:35-38 for all mesh dumps). The
// extraction runs on host over numpy grids; implementation is marching
// tetrahedra (each cell split into 6 tets), which produces the same
// isosurface as classic marching cubes without the 256-case lookup tables,
// with shared vertices deduplicated on cell edges.
//
// C ABI for ctypes binding (no pybind11 in this image).

#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// key identifying an interpolated vertex by its (sorted) grid-point pair
static inline uint64_t edge_key(uint32_t a, uint32_t b) {
  if (a > b) std::swap(a, b);
  return (static_cast<uint64_t>(a) << 32) | b;
}

struct MeshBuilder {
  std::vector<float> verts;  // xyz triplets
  std::vector<int32_t> tris; // index triplets
  std::unordered_map<uint64_t, int32_t> edge_to_vertex;

  int32_t vertex_on_edge(uint32_t ga, uint32_t gb, const V3 &pa, const V3 &pb,
                         float va, float vb, float level) {
    const uint64_t key = edge_key(ga, gb);
    auto it = edge_to_vertex.find(key);
    if (it != edge_to_vertex.end()) return it->second;
    float t = (level - va) / (vb - va);
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    const int32_t idx = static_cast<int32_t>(verts.size() / 3);
    verts.push_back(pa.x + t * (pb.x - pa.x));
    verts.push_back(pa.y + t * (pb.y - pa.y));
    verts.push_back(pa.z + t * (pb.z - pa.z));
    edge_to_vertex.emplace(key, idx);
    return idx;
  }

  void add_tri(int32_t a, int32_t b, int32_t c) {
    if (a == b || b == c || a == c) return;
    tris.push_back(a);
    tris.push_back(b);
    tris.push_back(c);
  }
};

// The 6-tetrahedron decomposition of a cell (corner indices 0..7 with
// corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1)) ). All six tets
// share the main diagonal 0-7, guaranteeing crack-free faces between cells.
static const int TETS[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

// triangulate one tetrahedron against the level set; corners inside when
// value < level (the mesh bounds the region where the TSDF is below level).
static void do_tet(MeshBuilder &mb, const uint32_t g[4], const V3 p[4],
                   const float v[4], float level) {
  int inside_mask = 0;
  for (int i = 0; i < 4; ++i)
    if (v[i] < level) inside_mask |= (1 << i);
  if (inside_mask == 0 || inside_mask == 15) return;

  // collect the 3 or 4 crossing edges in a consistent order per case.
  // cases with one corner isolated (inside or outside) give one triangle;
  // two-and-two gives a quad (two triangles).
  auto vert = [&](int a, int b) {
    return mb.vertex_on_edge(g[a], g[b], p[a], p[b], v[a], v[b], level);
  };
  // orientation: triangles wound counter-clockwise seen from the inside
  // corner(s), flipped below where needed so normals point outward
  // (towards v >= level).
  switch (inside_mask) {
    case 1:  mb.add_tri(vert(0, 1), vert(0, 2), vert(0, 3)); break;
    case 14: mb.add_tri(vert(0, 1), vert(0, 3), vert(0, 2)); break;
    case 2:  mb.add_tri(vert(1, 0), vert(1, 3), vert(1, 2)); break;
    case 13: mb.add_tri(vert(1, 0), vert(1, 2), vert(1, 3)); break;
    case 4:  mb.add_tri(vert(2, 0), vert(2, 1), vert(2, 3)); break;
    case 11: mb.add_tri(vert(2, 0), vert(2, 3), vert(2, 1)); break;
    case 8:  mb.add_tri(vert(3, 0), vert(3, 2), vert(3, 1)); break;
    case 7:  mb.add_tri(vert(3, 0), vert(3, 1), vert(3, 2)); break;
    case 3: {  // 0,1 inside
      int32_t a = vert(0, 2), b = vert(0, 3), c = vert(1, 3), d = vert(1, 2);
      mb.add_tri(a, b, c); mb.add_tri(a, c, d); break;
    }
    case 12: { // 2,3 inside (complement of 3)
      int32_t a = vert(0, 2), b = vert(0, 3), c = vert(1, 3), d = vert(1, 2);
      mb.add_tri(a, c, b); mb.add_tri(a, d, c); break;
    }
    case 5: {  // 0,2 inside
      int32_t a = vert(0, 1), b = vert(0, 3), c = vert(2, 3), d = vert(2, 1);
      mb.add_tri(a, c, b); mb.add_tri(a, d, c); break;
    }
    case 10: { // 1,3 inside (complement of 5)
      int32_t a = vert(0, 1), b = vert(0, 3), c = vert(2, 3), d = vert(2, 1);
      mb.add_tri(a, b, c); mb.add_tri(a, c, d); break;
    }
    case 6: {  // 1,2 inside
      int32_t a = vert(1, 0), b = vert(1, 3), c = vert(2, 3), d = vert(2, 0);
      mb.add_tri(a, b, c); mb.add_tri(a, c, d); break;
    }
    case 9: {  // 0,3 inside (complement of 6)
      int32_t a = vert(1, 0), b = vert(1, 3), c = vert(2, 3), d = vert(2, 0);
      mb.add_tri(a, c, b); mb.add_tri(a, d, c); break;
    }
    default: break;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Classic marching cubes (one polygon fan per edge loop — the lookup-table
// algorithm of the reference's `marching_cubes` extension,
// util/visualization.py:35-38). Instead of transcribing the public 256-case
// tables, the table is DERIVED at first use by tracing iso-contour edge
// loops around each corner-sign configuration:
//   * on every cell face, crossed face-edges are paired by marching-squares
//     with a fixed ambiguity rule (each segment cuts off one inside corner).
//     The rule depends only on the face's own corner signs, which both cells
//     sharing the face see identically -> crack-free across cells by
//     construction;
//   * each crossed cell edge lies on exactly two faces, so the segments form
//     disjoint closed loops; each loop is fan-triangulated (len-2 triangles,
//     the classic tables' triangle counts);
//   * loop winding is fixed at build time so triangle normals point toward
//     v >= level (outward), matching the tetrahedra extractor above.
// Same dedup (one vertex per crossed grid edge) -> watertight surface.

namespace {

// cell corners use the same numbering as the tet path:
// corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1))
static const int EDGES[12][2] = {
    {0, 1}, {2, 3}, {4, 5}, {6, 7},   // x-axis edges
    {0, 2}, {1, 3}, {4, 6}, {5, 7},   // y-axis edges
    {0, 4}, {1, 5}, {2, 6}, {3, 7},   // z-axis edges
};

// faces as 4 corners in cyclic order (edge i joins corner i and i+1 mod 4)
static const int FACES[6][4] = {
    {0, 2, 6, 4}, {1, 3, 7, 5},   // x = 0, x = 1
    {0, 1, 5, 4}, {2, 3, 7, 6},   // y = 0, y = 1
    {0, 1, 3, 2}, {4, 5, 7, 6},   // z = 0, z = 1
};

struct MCCase {
  std::vector<std::array<int8_t, 3>> tris;  // cell-edge ids per triangle
};

static int edge_id_of(int a, int b) {
  for (int e = 0; e < 12; ++e)
    if ((EDGES[e][0] == a && EDGES[e][1] == b) ||
        (EDGES[e][0] == b && EDGES[e][1] == a))
      return e;
  return -1;
}

static const std::array<MCCase, 256> &mc_table() {
  static const std::array<MCCase, 256> table = [] {
    std::array<MCCase, 256> t{};
    for (int config = 1; config < 255; ++config) {
      bool inside[8];
      for (int c = 0; c < 8; ++c) inside[c] = (config >> c) & 1;

      // segment partners per crossed cell edge (exactly 2 when crossed);
      // `unpaired_on_ambiguous` marks pairs of crossed edges that share an
      // ambiguous (4-crossing) face WITHOUT being paired there — a chord
      // between them would lie in that face's plane and coincide with the
      // neighboring cell's geometry (non-manifold contact), so the loop
      // triangulation below must avoid such chords
      int partner[12][2];
      int n_partner[12] = {0};
      bool unpaired_on_ambiguous[12][12] = {{false}};
      auto add_segment = [&](int ea, int eb) {
        partner[ea][n_partner[ea]++] = eb;
        partner[eb][n_partner[eb]++] = ea;
      };
      for (const auto &f : FACES) {
        int crossed[4], nc = 0;
        for (int i = 0; i < 4; ++i)
          if (inside[f[i]] != inside[f[(i + 1) % 4]]) crossed[nc++] = i;
        if (nc == 2) {
          add_segment(edge_id_of(f[crossed[0]], f[(crossed[0] + 1) % 4]),
                      edge_id_of(f[crossed[1]], f[(crossed[1] + 1) % 4]));
        } else if (nc == 4) {
          // ambiguous face: each segment cuts off one inside corner —
          // corner i's adjacent face-edges are (i-1, i) and (i, i+1)
          int eids[4];
          for (int i = 0; i < 4; ++i)
            eids[i] = edge_id_of(f[i], f[(i + 1) % 4]);
          for (int i = 0; i < 4; ++i) {
            if (!inside[f[i]]) continue;
            add_segment(eids[(i + 3) % 4], eids[i]);
          }
          // the two diagonally-unpaired combinations on this face
          for (int i = 0; i < 4; ++i) {
            const int a = eids[i], b = eids[(i + 2) % 4];  // opposite edges
            unpaired_on_ambiguous[a][b] = unpaired_on_ambiguous[b][a] = true;
          }
          for (int i = 0; i < 4; ++i) {
            if (inside[f[i]]) continue;  // adjacent edges around an OUTSIDE
            const int a = eids[(i + 3) % 4], b = eids[i];  // corner: unpaired
            unpaired_on_ambiguous[a][b] = unpaired_on_ambiguous[b][a] = true;
          }
        }
      }

      // canonical embedding for winding: crossings at edge midpoints
      V3 mid[12], dir[12];  // dir: inside endpoint -> outside endpoint
      for (int e = 0; e < 12; ++e) {
        const int a = EDGES[e][0], b = EDGES[e][1];
        const V3 pa{(float)(a & 1), (float)((a >> 1) & 1), (float)((a >> 2) & 1)};
        const V3 pb{(float)(b & 1), (float)((b >> 1) & 1), (float)((b >> 2) & 1)};
        mid[e] = V3{0.5f * (pa.x + pb.x), 0.5f * (pa.y + pb.y), 0.5f * (pa.z + pb.z)};
        const float s = inside[a] ? 1.f : -1.f;  // flip so dir points outward
        dir[e] = V3{s * (pb.x - pa.x), s * (pb.y - pa.y), s * (pb.z - pa.z)};
      }

      // trace disjoint loops over the crossed edges
      bool used[12] = {false};
      for (int e0 = 0; e0 < 12; ++e0) {
        if (n_partner[e0] == 0 || used[e0]) continue;
        std::vector<int> loop;
        int prev = -1, cur = e0;
        do {
          loop.push_back(cur);
          used[cur] = true;
          const int nxt = (partner[cur][0] == prev && n_partner[cur] > 1)
                              ? partner[cur][1]
                              : (partner[cur][0] != prev ? partner[cur][0]
                                                         : partner[cur][1]);
          prev = cur;
          cur = nxt;
        } while (cur != e0);

        // orient: Newell normal vs mean outward direction
        V3 nrm{0, 0, 0}, out{0, 0, 0};
        const size_t n = loop.size();
        for (size_t i = 0; i < n; ++i) {
          const V3 &p = mid[loop[i]];
          const V3 &q = mid[loop[(i + 1) % n]];
          nrm.x += (p.y - q.y) * (p.z + q.z);
          nrm.y += (p.z - q.z) * (p.x + q.x);
          nrm.z += (p.x - q.x) * (p.y + q.y);
          out.x += dir[loop[i]].x;
          out.y += dir[loop[i]].y;
          out.z += dir[loop[i]].z;
        }
        if (nrm.x * out.x + nrm.y * out.y + nrm.z * out.z < 0.f)
          for (size_t i = 1; i < (n + 1) / 2; ++i) std::swap(loop[i], loop[n - i]);

        // triangulate the loop minimizing chords between UNPAIRED edges of a
        // shared ambiguous face (such a chord lies in the face plane and
        // would touch the neighbor cell's surface non-manifoldly). Interval
        // DP over the polygon; n <= 12 so cost is negligible, and for every
        // configuration a zero-penalty triangulation exists (asserted by
        // tests/test_mesh_deviation.py's all-configs manifold test).
        const int m = (int)n;
        int cost[12][12] = {{0}};
        int split[12][12] = {{0}};
        auto chord_penalty = [&](int i, int j) -> int {
          if (j == i + 1 || (i == 0 && j == m - 1)) return 0;  // polygon side
          return unpaired_on_ambiguous[loop[i]][loop[j]] ? 1 : 0;
        };
        for (int len = 2; len < m; ++len) {
          for (int i = 0; i + len < m; ++i) {
            const int j = i + len;
            int best = 1 << 20, arg = i + 1;
            for (int kk = i + 1; kk < j; ++kk) {
              const int c = cost[i][kk] + cost[kk][j] + chord_penalty(i, kk) +
                            chord_penalty(kk, j);
              if (c < best) { best = c; arg = kk; }
            }
            cost[i][j] = best;
            split[i][j] = arg;
          }
        }
        // emit triangles by recursing on the split table (iterative stack)
        int stack[24][2];
        int sp = 0;
        stack[sp][0] = 0; stack[sp][1] = m - 1; ++sp;
        while (sp > 0) {
          --sp;
          const int i = stack[sp][0], j = stack[sp][1];
          if (j - i < 2) continue;
          const int kk = split[i][j];
          t[config].tris.push_back({(int8_t)loop[i], (int8_t)loop[kk],
                                    (int8_t)loop[j]});
          stack[sp][0] = i; stack[sp][1] = kk; ++sp;
          stack[sp][0] = kk; stack[sp][1] = j; ++sp;
        }
      }
    }
    return t;
  }();
  return table;
}

}  // namespace

extern "C" {

// Extract the level-set surface of a (nx, ny, nz) C-order float grid.
// Returns 0 on success; caller must free with mc_free. Vertex coordinates
// are in voxel units (grid index space), matching the reference extension's
// convention so downstream OBJ/metric code agrees.
int mc_extract(const float *sdf, int nx, int ny, int nz, float level,
               float **out_verts, int *n_verts, int32_t **out_tris, int *n_tris) {
  if (!sdf || nx < 2 || ny < 2 || nz < 2) return 1;
  MeshBuilder mb;
  const int64_t sy = nz;        // stride of y in elements
  const int64_t sx = (int64_t)ny * nz;
  auto gid = [&](int x, int y, int z) -> uint32_t {
    return static_cast<uint32_t>(x * sx + y * sy + z);
  };
  for (int x = 0; x < nx - 1; ++x) {
    for (int y = 0; y < ny - 1; ++y) {
      for (int z = 0; z < nz - 1; ++z) {
        float cv[8];
        V3 cp[8];
        uint32_t cg[8];
        bool all_in = true, all_out = true;
        for (int c = 0; c < 8; ++c) {
          const int cx = x + (c & 1), cy = y + ((c >> 1) & 1), cz = z + ((c >> 2) & 1);
          cg[c] = gid(cx, cy, cz);
          cv[c] = sdf[cg[c]];
          cp[c] = V3{(float)cx, (float)cy, (float)cz};
          if (cv[c] < level) all_out = false; else all_in = false;
        }
        if (all_in || all_out) continue;
        for (int t = 0; t < 6; ++t) {
          uint32_t g[4];
          V3 p[4];
          float v[4];
          for (int i = 0; i < 4; ++i) {
            const int c = TETS[t][i];
            g[i] = cg[c]; p[i] = cp[c]; v[i] = cv[c];
          }
          do_tet(mb, g, p, v, level);
        }
      }
    }
  }
  *n_verts = static_cast<int>(mb.verts.size() / 3);
  *n_tris = static_cast<int>(mb.tris.size() / 3);
  *out_verts = static_cast<float *>(std::malloc(mb.verts.size() * sizeof(float)));
  *out_tris = static_cast<int32_t *>(std::malloc(mb.tris.size() * sizeof(int32_t)));
  if ((!*out_verts && !mb.verts.empty()) || (!*out_tris && !mb.tris.empty())) return 2;
  if (!mb.verts.empty()) std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
  if (!mb.tris.empty()) std::memcpy(*out_tris, mb.tris.data(), mb.tris.size() * sizeof(int32_t));
  return 0;
}

// Classic marching-cubes extraction (lookup-table triangulation — the
// reference extension's algorithm; ~half the triangles of the tetrahedra
// path for the same isosurface). Same conventions as mc_extract: C-order
// grid, vertices in voxel-index units, inside when value < level.
int mc_extract_classic(const float *sdf, int nx, int ny, int nz, float level,
                       float **out_verts, int *n_verts, int32_t **out_tris,
                       int *n_tris) {
  if (!sdf || nx < 2 || ny < 2 || nz < 2) return 1;
  const auto &table = mc_table();
  MeshBuilder mb;
  const int64_t sy = nz;
  const int64_t sx = (int64_t)ny * nz;
  auto gid = [&](int x, int y, int z) -> uint32_t {
    return static_cast<uint32_t>(x * sx + y * sy + z);
  };
  for (int x = 0; x < nx - 1; ++x) {
    for (int y = 0; y < ny - 1; ++y) {
      for (int z = 0; z < nz - 1; ++z) {
        float cv[8];
        V3 cp[8];
        uint32_t cg[8];
        int config = 0;
        for (int c = 0; c < 8; ++c) {
          const int cx = x + (c & 1), cy = y + ((c >> 1) & 1),
                    cz = z + ((c >> 2) & 1);
          cg[c] = gid(cx, cy, cz);
          cv[c] = sdf[cg[c]];
          cp[c] = V3{(float)cx, (float)cy, (float)cz};
          if (cv[c] < level) config |= (1 << c);
        }
        if (config == 0 || config == 255) continue;
        for (const auto &tri : table[config].tris) {
          int32_t vid[3];
          for (int i = 0; i < 3; ++i) {
            const int a = EDGES[tri[i]][0], b = EDGES[tri[i]][1];
            vid[i] = mb.vertex_on_edge(cg[a], cg[b], cp[a], cp[b], cv[a],
                                       cv[b], level);
          }
          mb.add_tri(vid[0], vid[1], vid[2]);
        }
      }
    }
  }
  *n_verts = static_cast<int>(mb.verts.size() / 3);
  *n_tris = static_cast<int>(mb.tris.size() / 3);
  *out_verts = static_cast<float *>(std::malloc(mb.verts.size() * sizeof(float)));
  *out_tris = static_cast<int32_t *>(std::malloc(mb.tris.size() * sizeof(int32_t)));
  if ((!*out_verts && !mb.verts.empty()) || (!*out_tris && !mb.tris.empty())) return 2;
  if (!mb.verts.empty()) std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
  if (!mb.tris.empty()) std::memcpy(*out_tris, mb.tris.data(), mb.tris.size() * sizeof(int32_t));
  return 0;
}

void mc_free(float *verts, int32_t *tris) {
  std::free(verts);
  std::free(tris);
}

}  // extern "C"
