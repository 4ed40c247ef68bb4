// Native mesh operations of lgm_tpu_torch: the port's own copy of
// lgm_tpu's native/meshops.cpp (same algorithms, same C interface, so the
// outputs are the same bit for bit), built at first use by
// lgm_tpu_torch/ops/_build.py::build_host and bound in lgm_tpu_torch/native.py.
//
// They replace the reference's external C++ mesh deps:
// PyMCubes marching cubes (ref: convert.py:13,288) and
// pymeshlab-based clean/decimate via kiui.mesh_utils
// (ref: convert.py:294-296,338-340; SURVEY.md §2b N5/N11).
//
// Isosurface extraction uses marching tetrahedra (6-tet cube split along
// the 0-6 diagonal): the case tables are derived in code instead of the
// 256-entry marching-cubes tri-table, which makes the implementation
// self-contained and verifiable; triangle count is ~2x MC, which the
// decimator then reduces. Vertices on shared edges are welded during
// extraction via an edge-key hash map.
//
// Decimation is uniform-grid vertex clustering: vertices are pooled to
// their cluster centroid and degenerate faces dropped — O(n), adequate
// for the 5e4-face target the reference uses.
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

// The 6 tetrahedra sharing the 0-6 main diagonal of a unit cube.
// Cube corner numbering: bit0 = x, bit1 = y, bit2 = z.
static const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

inline void corner_offset(int corner, int* dx, int* dy, int* dz) {
  // Corners ordered as the usual MC ring: 0:(0,0,0) 1:(1,0,0) 2:(1,1,0)
  // 3:(0,1,0) 4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
  static const int off[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                                {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
  *dx = off[corner][0];
  *dy = off[corner][1];
  *dz = off[corner][2];
}

struct Extractor {
  const float* grid;
  int nx, ny, nz;
  float iso;
  std::vector<float> verts;
  std::vector<int> faces;
  std::unordered_map<uint64_t, int> edge_to_vert;

  inline float sample(int x, int y, int z) const {
    return grid[(size_t)x * ny * nz + (size_t)y * nz + z];
  }

  inline uint64_t node_id(int x, int y, int z) const {
    return ((uint64_t)x * (ny + 1) + y) * (nz + 1) + z;
  }

  // Vertex on the edge between grid nodes a and b, interpolated to iso.
  int edge_vertex(int ax, int ay, int az, int bx, int by, int bz) {
    uint64_t ka = node_id(ax, ay, az), kb = node_id(bx, by, bz);
    uint64_t key = ka < kb ? (ka << 32 | kb) : (kb << 32 | ka);
    auto it = edge_to_vert.find(key);
    if (it != edge_to_vert.end()) return it->second;
    float va = sample(ax, ay, az), vb = sample(bx, by, bz);
    float t = (iso - va) / (vb - va + 1e-12f);
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    int idx = (int)(verts.size() / 3);
    verts.push_back(ax + t * (bx - ax));
    verts.push_back(ay + t * (by - ay));
    verts.push_back(az + t * (bz - az));
    edge_to_vert.emplace(key, idx);
    return idx;
  }

  // Emit with winding enforced against ``dir`` (inside -> outside):
  // the hand-derived tet case table had ~8% flipped faces (measured as
  // inward normals on a sphere), which fragmented chart growth and
  // corrupted the normal-consistency loss; checking the actual triangle
  // normal at emission is orientation-correct by construction.
  void emit_tri_oriented(int a, int b, int c, const float dir[3]) {
    const float* A = &verts[3 * a];
    const float* B = &verts[3 * b];
    const float* C = &verts[3 * c];
    float e1x = B[0] - A[0], e1y = B[1] - A[1], e1z = B[2] - A[2];
    float e2x = C[0] - A[0], e2y = C[1] - A[1], e2z = C[2] - A[2];
    float nx = e1y * e2z - e1z * e2y;
    float ny = e1z * e2x - e1x * e2z;
    float nz = e1x * e2y - e1y * e2x;
    if (nx * dir[0] + ny * dir[1] + nz * dir[2] < 0) std::swap(b, c);
    emit_tri(a, b, c);
  }

  void emit_tri(int a, int b, int c) {
    if (a == b || b == c || a == c) return;
    faces.push_back(a);
    faces.push_back(b);
    faces.push_back(c);
  }

  void process_tet(const int cx[4], const int cy[4], const int cz[4],
                   const float v[4]) {
    int mask = 0;
    for (int i = 0; i < 4; i++)
      if (v[i] > iso) mask |= 1 << i;
    if (mask == 0 || mask == 15) return;

    auto ev = [&](int i, int j) {
      return edge_vertex(cx[i], cy[i], cz[i], cx[j], cy[j], cz[j]);
    };

    // Outward direction: centroid of outside corners minus centroid of
    // inside corners (inside = value > iso).
    float ci[3] = {0, 0, 0}, co[3] = {0, 0, 0};
    int ni = 0, no = 0;
    for (int i = 0; i < 4; i++) {
      if (v[i] > iso) {
        ci[0] += cx[i]; ci[1] += cy[i]; ci[2] += cz[i]; ni++;
      } else {
        co[0] += cx[i]; co[1] += cy[i]; co[2] += cz[i]; no++;
      }
    }
    float dir[3] = {co[0] / no - ci[0] / ni, co[1] / no - ci[1] / ni,
                    co[2] / no - ci[2] / ni};
    auto emit = [&](int a, int b, int c) { emit_tri_oriented(a, b, c, dir); };

    // Canonical per-case emission; orientation kept consistent with the
    // gradient (inside = value > iso).
    switch (mask) {
      case 1:  emit(ev(0, 1), ev(0, 2), ev(0, 3)); break;
      case 14: emit(ev(0, 1), ev(0, 3), ev(0, 2)); break;
      case 2:  emit(ev(1, 0), ev(1, 3), ev(1, 2)); break;
      case 13: emit(ev(1, 0), ev(1, 2), ev(1, 3)); break;
      case 4:  emit(ev(2, 0), ev(2, 1), ev(2, 3)); break;
      case 11: emit(ev(2, 0), ev(2, 3), ev(2, 1)); break;
      case 8:  emit(ev(3, 0), ev(3, 2), ev(3, 1)); break;
      case 7:  emit(ev(3, 0), ev(3, 1), ev(3, 2)); break;
      case 3:  // 0,1 inside
        emit(ev(0, 2), ev(0, 3), ev(1, 3));
        emit(ev(0, 2), ev(1, 3), ev(1, 2));
        break;
      case 12:
        emit(ev(0, 2), ev(1, 3), ev(0, 3));
        emit(ev(0, 2), ev(1, 2), ev(1, 3));
        break;
      case 5:  // 0,2 inside
        emit(ev(0, 1), ev(2, 3), ev(0, 3));
        emit(ev(0, 1), ev(2, 1), ev(2, 3));
        break;
      case 10:
        emit(ev(0, 1), ev(0, 3), ev(2, 3));
        emit(ev(0, 1), ev(2, 3), ev(2, 1));
        break;
      case 6:  // 1,2 inside
        emit(ev(1, 0), ev(2, 0), ev(2, 3));
        emit(ev(1, 0), ev(2, 3), ev(1, 3));
        break;
      case 9:
        emit(ev(1, 0), ev(2, 3), ev(2, 0));
        emit(ev(1, 0), ev(1, 3), ev(2, 3));
        break;
    }
  }

  void run() {
    int cx[4], cy[4], cz[4];
    float v[4];
    for (int x = 0; x < nx - 1; x++)
      for (int y = 0; y < ny - 1; y++)
        for (int z = 0; z < nz - 1; z++) {
          // Quick reject: all 8 corners on one side.
          bool any_in = false, any_out = false;
          float cv[8];
          for (int c = 0; c < 8; c++) {
            int dx, dy, dz;
            corner_offset(c, &dx, &dy, &dz);
            cv[c] = sample(x + dx, y + dy, z + dz);
            (cv[c] > iso ? any_in : any_out) = true;
          }
          if (!any_in || !any_out) continue;
          for (int t = 0; t < 6; t++) {
            for (int i = 0; i < 4; i++) {
              int c = kTets[t][i], dx, dy, dz;
              corner_offset(c, &dx, &dy, &dz);
              cx[i] = x + dx;
              cy[i] = y + dy;
              cz[i] = z + dz;
              v[i] = cv[c];
            }
            process_tet(cx, cy, cz, v);
          }
        }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success; outputs are allocated by the caller with
// capacities max_verts/max_faces (counts written regardless, so callers
// can retry with larger buffers when the return is 1).
int lgm_marching_tetrahedra(const float* grid, int nx, int ny, int nz,
                            float iso, float* out_verts, int max_verts,
                            int* out_faces, int max_faces, int* n_verts,
                            int* n_faces) {
  Extractor ex;
  ex.grid = grid;
  ex.nx = nx;
  ex.ny = ny;
  ex.nz = nz;
  ex.iso = iso;
  ex.run();
  *n_verts = (int)(ex.verts.size() / 3);
  *n_faces = (int)(ex.faces.size() / 3);
  if (*n_verts > max_verts || *n_faces > max_faces) return 1;
  memcpy(out_verts, ex.verts.data(), ex.verts.size() * sizeof(float));
  memcpy(out_faces, ex.faces.data(), ex.faces.size() * sizeof(int));
  return 0;
}

// Uniform-grid vertex clustering decimation. cell > 0 in mesh units.
int lgm_decimate_cluster(const float* verts, int nv, const int* faces,
                         int nf, float cell, float* out_verts,
                         int* out_faces, int* n_verts, int* n_faces) {
  std::unordered_map<uint64_t, int> cluster_of;
  std::vector<int> vmap(nv);
  std::vector<float> acc;
  std::vector<int> cnt;
  for (int i = 0; i < nv; i++) {
    int64_t gx = (int64_t)std::floor(verts[3 * i + 0] / cell);
    int64_t gy = (int64_t)std::floor(verts[3 * i + 1] / cell);
    int64_t gz = (int64_t)std::floor(verts[3 * i + 2] / cell);
    uint64_t key = ((uint64_t)(gx & 0x1FFFFF) << 42) |
                   ((uint64_t)(gy & 0x1FFFFF) << 21) |
                   (uint64_t)(gz & 0x1FFFFF);
    auto it = cluster_of.find(key);
    int c;
    if (it == cluster_of.end()) {
      c = (int)cnt.size();
      cluster_of.emplace(key, c);
      acc.insert(acc.end(), {0.f, 0.f, 0.f});
      cnt.push_back(0);
    } else {
      c = it->second;
    }
    vmap[i] = c;
    acc[3 * c + 0] += verts[3 * i + 0];
    acc[3 * c + 1] += verts[3 * i + 1];
    acc[3 * c + 2] += verts[3 * i + 2];
    cnt[c]++;
  }
  int ncl = (int)cnt.size();
  for (int c = 0; c < ncl; c++) {
    out_verts[3 * c + 0] = acc[3 * c + 0] / cnt[c];
    out_verts[3 * c + 1] = acc[3 * c + 1] / cnt[c];
    out_verts[3 * c + 2] = acc[3 * c + 2] / cnt[c];
  }
  int m = 0;
  for (int f = 0; f < nf; f++) {
    int a = vmap[faces[3 * f]], b = vmap[faces[3 * f + 1]],
        c = vmap[faces[3 * f + 2]];
    if (a == b || b == c || a == c) continue;
    out_faces[3 * m] = a;
    out_faces[3 * m + 1] = b;
    out_faces[3 * m + 2] = c;
    m++;
  }
  *n_verts = ncl;
  *n_faces = m;
  return 0;
}

// Weld duplicate vertices within eps (hash on quantized position) and
// drop degenerate faces + unreferenced vertices.
int lgm_weld_and_clean(const float* verts, int nv, const int* faces, int nf,
                       float eps, float* out_verts, int* out_faces,
                       int* n_verts, int* n_faces) {
  std::unordered_map<uint64_t, int> seen;
  std::vector<int> vmap(nv);
  std::vector<float> vkeep;
  float inv = eps > 0 ? 1.0f / eps : 1e6f;
  for (int i = 0; i < nv; i++) {
    int64_t gx = (int64_t)std::llround(verts[3 * i + 0] * inv);
    int64_t gy = (int64_t)std::llround(verts[3 * i + 1] * inv);
    int64_t gz = (int64_t)std::llround(verts[3 * i + 2] * inv);
    uint64_t key = ((uint64_t)(gx & 0x1FFFFF) << 42) |
                   ((uint64_t)(gy & 0x1FFFFF) << 21) |
                   (uint64_t)(gz & 0x1FFFFF);
    auto it = seen.find(key);
    if (it == seen.end()) {
      int idx = (int)(vkeep.size() / 3);
      seen.emplace(key, idx);
      vkeep.insert(vkeep.end(),
                   {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]});
      vmap[i] = idx;
    } else {
      vmap[i] = it->second;
    }
  }
  // Faces with welded indices; drop degenerates.
  std::vector<int> fkeep;
  for (int f = 0; f < nf; f++) {
    int a = vmap[faces[3 * f]], b = vmap[faces[3 * f + 1]],
        c = vmap[faces[3 * f + 2]];
    if (a == b || b == c || a == c) continue;
    fkeep.insert(fkeep.end(), {a, b, c});
  }
  // Remove unreferenced vertices.
  int nv2 = (int)(vkeep.size() / 3);
  std::vector<int> used(nv2, -1);
  int nkeep = 0;
  for (int idx : fkeep)
    if (used[idx] < 0) used[idx] = nkeep++;
  for (int v = 0; v < nv2; v++) {
    if (used[v] < 0) continue;
    out_verts[3 * used[v] + 0] = vkeep[3 * v + 0];
    out_verts[3 * used[v] + 1] = vkeep[3 * v + 1];
    out_verts[3 * used[v] + 2] = vkeep[3 * v + 2];
  }
  for (size_t f = 0; f < fkeep.size(); f++) out_faces[f] = used[fkeep[f]];
  *n_verts = nkeep;
  *n_faces = (int)(fkeep.size() / 3);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Chart-based UV unwrap (replaces the box-projection atlas; quality class
// of xatlas for the meshes this pipeline produces, ref: convert.py:370-372).
//
// 1. Chart growing: BFS over face adjacency; a face joins the chart while
//    its normal stays within cos_thresh of the chart's area-weighted mean
//    normal. Charts follow surface regions, so concave meshes do not get
//    the cross-chart bleeding/stretch of a 6-way box projection.
// 2. Parameterization: each chart projects onto its mean-normal plane
//    (normal deviation is bounded by cos_thresh, bounding stretch to
//    1/cos_thresh per axis).
// 3. Packing: shelf packer over chart rects at uniform texel density
//    (chart UV spans keep world scale before normalization).
// Vertices on chart boundaries are duplicated per chart.

namespace {

inline Vec3 v3(const float* p) { return {p[0], p[1], p[2]}; }
inline Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float dot3(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline float norm3(Vec3 a) { return std::sqrt(dot3(a, a)); }
inline Vec3 scale3(Vec3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

}  // namespace

extern "C" {

int lgm_chart_unwrap(const float* verts, int nv, const int* faces, int nf,
                     float cos_thresh, float margin, float* out_verts,
                     int max_verts, float* out_uv, int* out_faces,
                     int* n_verts, int* n_charts) {
  (void)nv;
  // Face normals (area-weighted) and adjacency over shared edges.
  std::vector<Vec3> fnorm(nf);
  std::vector<float> farea(nf);
  for (int f = 0; f < nf; f++) {
    Vec3 a = v3(verts + 3 * faces[3 * f]);
    Vec3 b = v3(verts + 3 * faces[3 * f + 1]);
    Vec3 c = v3(verts + 3 * faces[3 * f + 2]);
    Vec3 n = cross(sub(b, a), sub(c, a));
    float l = norm3(n);
    farea[f] = 0.5f * l;
    fnorm[f] = l > 1e-12f ? scale3(n, 1.0f / l) : Vec3{0, 0, 1};
  }
  std::unordered_map<uint64_t, std::pair<int, int>> edge_faces;
  edge_faces.reserve(nf * 3);
  auto ekey = [](int a, int b) {
    if (a > b) std::swap(a, b);
    return ((uint64_t)(uint32_t)a << 32) | (uint32_t)b;
  };
  for (int f = 0; f < nf; f++) {
    for (int e = 0; e < 3; e++) {
      uint64_t k =
          ekey(faces[3 * f + e], faces[3 * f + (e + 1) % 3]);
      auto it = edge_faces.find(k);
      if (it == edge_faces.end())
        edge_faces.emplace(k, std::make_pair(f, -1));
      else if (it->second.second < 0)
        it->second.second = f;
      // non-manifold extra faces: ignored for adjacency
    }
  }

  // Chart growing.
  std::vector<int> chart_of(nf, -1);
  std::vector<int> order;  // faces in chart-grouped order
  std::vector<int> chart_begin;
  std::vector<Vec3> chart_normal;
  order.reserve(nf);
  std::vector<int> queue;
  for (int seed = 0; seed < nf; seed++) {
    if (chart_of[seed] >= 0) continue;
    int c = (int)chart_begin.size();
    chart_begin.push_back((int)order.size());
    Vec3 acc = scale3(fnorm[seed], farea[seed] + 1e-12f);
    chart_of[seed] = c;
    order.push_back(seed);
    queue.clear();
    queue.push_back(seed);
    while (!queue.empty()) {
      int f = queue.back();
      queue.pop_back();
      float al = norm3(acc);
      Vec3 mean = al > 1e-12f ? scale3(acc, 1.0f / al) : fnorm[f];
      for (int e = 0; e < 3; e++) {
        uint64_t k = ekey(faces[3 * f + e], faces[3 * f + (e + 1) % 3]);
        auto it = edge_faces.find(k);
        if (it == edge_faces.end()) continue;
        int g = it->second.first == f ? it->second.second
                                      : it->second.first;
        if (g < 0 || chart_of[g] >= 0) continue;
        if (dot3(fnorm[g], mean) < cos_thresh) continue;
        chart_of[g] = c;
        order.push_back(g);
        queue.push_back(g);
        acc.x += fnorm[g].x * (farea[g] + 1e-12f);
        acc.y += fnorm[g].y * (farea[g] + 1e-12f);
        acc.z += fnorm[g].z * (farea[g] + 1e-12f);
      }
    }
    chart_normal.push_back(acc);
  }
  int nc0 = (int)chart_begin.size();
  chart_begin.push_back((int)order.size());

  // Merge pass: growth leaves fragments (faces rejected by one chart
  // re-seed their own; marching-tet meshes have noisy normals). Fold
  // charts smaller than min_faces into the most normal-similar adjacent
  // chart that is not facing away (dot > 0.2 keeps plane projection
  // from folding). Iterate to a fixed point.
  const int min_faces = 16;
  std::vector<int> chart_size(nc0, 0);
  for (int f = 0; f < nf; f++) chart_size[chart_of[f]]++;
  for (int pass = 0; pass < 8; pass++) {
    bool changed = false;
    for (int f = 0; f < nf; f++) {
      int c = chart_of[f];
      if (chart_size[c] >= min_faces) continue;
      // best adjacent chart for this face's chart
      int best = -1;
      float best_dot = 0.2f;
      Vec3 cn = chart_normal[c];
      float cl = norm3(cn);
      if (cl > 1e-12f) cn = scale3(cn, 1.0f / cl);
      for (int e = 0; e < 3; e++) {
        uint64_t k = ekey(faces[3 * f + e], faces[3 * f + (e + 1) % 3]);
        auto it = edge_faces.find(k);
        if (it == edge_faces.end()) continue;
        int g = it->second.first == f ? it->second.second
                                      : it->second.first;
        if (g < 0) continue;
        int cg = chart_of[g];
        if (cg == c || chart_size[cg] < chart_size[c]) continue;
        Vec3 gn = chart_normal[cg];
        float gl = norm3(gn);
        if (gl > 1e-12f) gn = scale3(gn, 1.0f / gl);
        float d = dot3(cn, gn);
        if (d > best_dot) {
          best_dot = d;
          best = cg;
        }
      }
      if (best >= 0) {
        // move the whole fragment chart into `best`
        for (int f2 = 0; f2 < nf; f2++)
          if (chart_of[f2] == c) chart_of[f2] = best;
        chart_size[best] += chart_size[c];
        chart_normal[best].x += chart_normal[c].x;
        chart_normal[best].y += chart_normal[c].y;
        chart_normal[best].z += chart_normal[c].z;
        chart_size[c] = 0;
        changed = true;
      }
    }
    if (!changed) break;
  }

  // Reassignment pass: faces admitted early (before the chart mean
  // drifted) or absorbed by merging can end up >90 deg from their
  // chart's plane — they FOLD under plane projection and overlap other
  // triangles in UV. Move any face that is a poor fit to the adjacent
  // chart that fits it best.
  for (int pass = 0; pass < 4; pass++) {
    bool changed = false;
    for (int f = 0; f < nf; f++) {
      int c = chart_of[f];
      Vec3 cn = chart_normal[c];
      float cl = norm3(cn);
      if (cl > 1e-12f) cn = scale3(cn, 1.0f / cl);
      float dc = dot3(fnorm[f], cn);
      if (dc >= 0.1f) continue;
      int best = -1;
      float best_d = dc + 0.05f;
      for (int e = 0; e < 3; e++) {
        uint64_t k = ekey(faces[3 * f + e], faces[3 * f + (e + 1) % 3]);
        auto it = edge_faces.find(k);
        if (it == edge_faces.end()) continue;
        int g = it->second.first == f ? it->second.second
                                      : it->second.first;
        if (g < 0 || chart_of[g] == c) continue;
        int cg = chart_of[g];
        Vec3 gn = chart_normal[cg];
        float gl = norm3(gn);
        if (gl > 1e-12f) gn = scale3(gn, 1.0f / gl);
        float d = dot3(fnorm[f], gn);
        if (d > best_d) {
          best_d = d;
          best = cg;
        }
      }
      if (best >= 0) {
        chart_size[chart_of[f]]--;
        chart_of[f] = best;
        chart_size[best]++;
        changed = true;
      }
    }
    if (!changed) break;
  }
  // (empty charts are dropped by the compaction below)

  // Compact surviving chart ids and rebuild chart-grouped face order.
  std::vector<int> newid(nc0, -1);
  int nc = 0;
  for (int c = 0; c < nc0; c++)
    if (chart_size[c] > 0) newid[c] = nc++;
  std::vector<Vec3> cn2(nc);
  for (int c = 0; c < nc0; c++)
    if (newid[c] >= 0) cn2[newid[c]] = chart_normal[c];
  chart_normal.swap(cn2);
  for (int f = 0; f < nf; f++) chart_of[f] = newid[chart_of[f]];
  std::vector<int> bucket_n(nc + 1, 0);
  for (int f = 0; f < nf; f++) bucket_n[chart_of[f] + 1]++;
  for (int c = 0; c < nc; c++) bucket_n[c + 1] += bucket_n[c];
  chart_begin.assign(bucket_n.begin(), bucket_n.end());
  std::vector<int> cursor(chart_begin.begin(), chart_begin.end() - 1);
  order.assign(nf, 0);
  for (int f = 0; f < nf; f++) order[cursor[chart_of[f]]++] = f;

  // Per-chart plane projection + rect extents (world scale).
  std::vector<float> cu0(nc), cv0(nc), cw(nc), ch(nc);
  std::vector<Vec3> cu(nc), cv(nc);
  std::vector<std::unordered_map<int, int>> remap(nc);
  int nvo = 0;
  for (int c = 0; c < nc; c++) {
    Vec3 n = chart_normal[c];
    float l = norm3(n);
    n = l > 1e-12f ? scale3(n, 1.0f / l) : Vec3{0, 0, 1};
    Vec3 e = std::fabs(n.x) < 0.9f ? Vec3{1, 0, 0} : Vec3{0, 1, 0};
    Vec3 u = cross(n, e);
    u = scale3(u, 1.0f / std::max(norm3(u), 1e-12f));
    Vec3 v = cross(n, u);
    cu[c] = u;
    cv[c] = v;
    float u0 = 1e30f, u1 = -1e30f, v0 = 1e30f, v1 = -1e30f;
    for (int i = chart_begin[c]; i < chart_begin[c + 1]; i++) {
      int f = order[i];
      for (int e2 = 0; e2 < 3; e2++) {
        int vid = faces[3 * f + e2];
        if (remap[c].emplace(vid, nvo).second) nvo++;
        Vec3 p = v3(verts + 3 * vid);
        float pu = dot3(p, u), pv = dot3(p, v);
        u0 = std::min(u0, pu);
        u1 = std::max(u1, pu);
        v0 = std::min(v0, pv);
        v1 = std::max(v1, pv);
      }
    }
    cu0[c] = u0;
    cv0[c] = v0;
    cw[c] = std::max(u1 - u0, 1e-6f);
    ch[c] = std::max(v1 - v0, 1e-6f);
  }
  if (nvo > max_verts) {
    *n_verts = nvo;
    return -1;
  }

  // Shelf packing (charts sorted by height, world-uniform texel scale).
  std::vector<int> cidx(nc);
  for (int c = 0; c < nc; c++) cidx[c] = c;
  std::sort(cidx.begin(), cidx.end(),
            [&](int a, int b) { return ch[a] > ch[b]; });
  float total = 0;
  for (int c = 0; c < nc; c++) total += cw[c] * ch[c];
  float gap = margin * std::sqrt(total);
  float strip_w = std::sqrt(total) * 1.25f + gap;
  std::vector<float> px(nc), py(nc);
  float x = gap, y = gap, shelf_h = 0, used_w = strip_w, used_h = 0;
  for (int ci : cidx) {
    if (x + cw[ci] + gap > strip_w && x > gap) {
      x = gap;
      y += shelf_h + gap;
      shelf_h = 0;
    }
    px[ci] = x;
    py[ci] = y;
    x += cw[ci] + gap;
    shelf_h = std::max(shelf_h, ch[ci]);
    used_h = std::max(used_h, y + shelf_h + gap);
  }
  float atlas = std::max(used_w, used_h);

  // Emit duplicated vertices + uvs + remapped faces.
  for (int c = 0; c < nc; c++) {
    for (auto& kv : remap[c]) {
      int vid = kv.first, out = kv.second;
      Vec3 p = v3(verts + 3 * vid);
      out_verts[3 * out + 0] = p.x;
      out_verts[3 * out + 1] = p.y;
      out_verts[3 * out + 2] = p.z;
      out_uv[2 * out + 0] =
          (px[c] + dot3(p, cu[c]) - cu0[c]) / atlas;
      out_uv[2 * out + 1] =
          (py[c] + dot3(p, cv[c]) - cv0[c]) / atlas;
    }
  }
  for (int f = 0; f < nf; f++) {
    int c = chart_of[f];
    for (int e = 0; e < 3; e++)
      out_faces[3 * f + e] = remap[c][faces[3 * f + e]];
  }
  *n_verts = nvo;
  *n_charts = nc;
  return 0;
}

}  // extern "C"
