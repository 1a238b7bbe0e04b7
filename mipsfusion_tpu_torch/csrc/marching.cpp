// Host iso-surface extraction with TSDF truncation semantics: the port's
// copy of native/marching_cubes/marching.cpp (the JAX package's, which
// stays untouched), built by mipsfusion_tpu_torch/ops/_build.py with the
// host C++ compiler and bound with ctypes by mesher/marching.py.
//
// TSDF sampling with invalid-voxel rejection (|d| >= truncation or
// non-finite), iso-surface triangulation, vertex welding via a sparse
// spatial hash, and degenerate-face removal. Triangulation uses marching
// tetrahedra (each cube split into the six tetrahedra sharing the 0-7 main
// diagonal): table-free and watertight within a cube.
//
// Exposed as a C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// Cube corners indexed by bits: bit0 -> +x, bit1 -> +y, bit2 -> +z.
// Six tetrahedra sharing the 0-7 main diagonal.
static const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

struct Vec3 {
  double x, y, z;
};

struct Key {
  int64_t a, b, c;
  bool operator==(const Key& o) const {
    return a == o.a && b == o.b && c == o.c;
  }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    // spatial hash: large-prime mix of quantized coordinates
    return static_cast<size_t>(k.a * 73856093LL ^ k.b * 19349669LL ^
                               k.c * 83492791LL);
  }
};

struct Mesh {
  std::vector<double> verts;   // xyz triples (grid coordinates)
  std::vector<int64_t> faces;  // index triples
  std::unordered_map<Key, int64_t, KeyHash> weld;

  int64_t add_vertex(const Vec3& p) {
    // weld vertices closer than 1e-5 voxels
    const double q = 1e5;
    Key k{static_cast<int64_t>(std::llround(p.x * q)),
          static_cast<int64_t>(std::llround(p.y * q)),
          static_cast<int64_t>(std::llround(p.z * q))};
    auto it = weld.find(k);
    if (it != weld.end()) return it->second;
    int64_t id = static_cast<int64_t>(verts.size() / 3);
    verts.push_back(p.x);
    verts.push_back(p.y);
    verts.push_back(p.z);
    weld.emplace(k, id);
    return id;
  }

  void add_tri(int64_t i, int64_t j, int64_t k) {
    if (i == j || j == k || i == k) return;  // degenerate face removal
    faces.push_back(i);
    faces.push_back(j);
    faces.push_back(k);
  }
};

inline Vec3 lerp_edge(const Vec3& pa, const Vec3& pb, double va, double vb,
                      double iso) {
  double denom = vb - va;
  double t = (std::fabs(denom) < 1e-12) ? 0.5 : (iso - va) / denom;
  if (t < 0.0) t = 0.0;
  if (t > 1.0) t = 1.0;
  return Vec3{pa.x + t * (pb.x - pa.x), pa.y + t * (pb.y - pa.y),
              pa.z + t * (pb.z - pa.z)};
}

void triangulate_tet(Mesh& mesh, const Vec3 p[4], const double v[4],
                     double iso) {
  int inside_mask = 0;
  for (int i = 0; i < 4; ++i)
    if (v[i] < iso) inside_mask |= (1 << i);
  if (inside_mask == 0 || inside_mask == 15) return;

  // collect crossing edges
  static const int kEdges[6][2] = {{0, 1}, {0, 2}, {0, 3},
                                   {1, 2}, {1, 3}, {2, 3}};
  int lone;  // the vertex separated from the other three (1-vs-3 cases)
  int n_in = __builtin_popcount(static_cast<unsigned>(inside_mask));

  if (n_in == 1 || n_in == 3) {
    int target = (n_in == 1) ? inside_mask : (~inside_mask & 15);
    lone = __builtin_ctz(static_cast<unsigned>(target));
    int others[3], no = 0;
    for (int i = 0; i < 4; ++i)
      if (i != lone) others[no++] = i;
    int64_t a = mesh.add_vertex(
        lerp_edge(p[lone], p[others[0]], v[lone], v[others[0]], iso));
    int64_t b = mesh.add_vertex(
        lerp_edge(p[lone], p[others[1]], v[lone], v[others[1]], iso));
    int64_t c = mesh.add_vertex(
        lerp_edge(p[lone], p[others[2]], v[lone], v[others[2]], iso));
    mesh.add_tri(a, b, c);
  } else {  // 2-vs-2: quad from the four crossing edges
    int in[2], out[2], ni = 0, no = 0;
    for (int i = 0; i < 4; ++i) {
      if (inside_mask & (1 << i)) in[ni++] = i;
      else out[no++] = i;
    }
    int64_t q0 = mesh.add_vertex(
        lerp_edge(p[in[0]], p[out[0]], v[in[0]], v[out[0]], iso));
    int64_t q1 = mesh.add_vertex(
        lerp_edge(p[in[0]], p[out[1]], v[in[0]], v[out[1]], iso));
    int64_t q2 = mesh.add_vertex(
        lerp_edge(p[in[1]], p[out[1]], v[in[1]], v[out[1]], iso));
    int64_t q3 = mesh.add_vertex(
        lerp_edge(p[in[1]], p[out[0]], v[in[1]], v[out[0]], iso));
    mesh.add_tri(q0, q1, q2);
    mesh.add_tri(q0, q2, q3);
  }
  (void)kEdges;
  (void)lone;
}

}  // namespace

extern "C" {

// Extract the iso-surface of a TSDF volume [nx, ny, nz] (C-contiguous,
// z minor). Voxels with |value| >= truncation or non-finite value are
// invalid; cubes touching an invalid corner are skipped. Vertices are
// returned in grid (voxel-index) coordinates.
//
// Returns 0 on success. Caller frees *out_verts / *out_faces via mc_free.
int mc_extract(const float* tsdf, int64_t nx, int64_t ny, int64_t nz,
               float isovalue, float truncation, double** out_verts,
               int64_t* out_nverts, int64_t** out_faces,
               int64_t* out_nfaces) {
  Mesh mesh;
  const int64_t sx = ny * nz, sy = nz, sz = 1;

  auto value = [&](int64_t x, int64_t y, int64_t z) -> double {
    return static_cast<double>(tsdf[x * sx + y * sy + z * sz]);
  };
  auto valid = [&](double v) -> bool {
    return std::isfinite(v) && std::fabs(v) < truncation;
  };

  for (int64_t x = 0; x + 1 < nx; ++x) {
    for (int64_t y = 0; y + 1 < ny; ++y) {
      for (int64_t z = 0; z + 1 < nz; ++z) {
        double cv[8];
        Vec3 cp[8];
        bool ok = true;
        for (int c = 0; c < 8; ++c) {
          int64_t cx = x + (c & 1), cy = y + ((c >> 1) & 1),
                  cz = z + ((c >> 2) & 1);
          cv[c] = value(cx, cy, cz);
          cp[c] = Vec3{static_cast<double>(cx), static_cast<double>(cy),
                       static_cast<double>(cz)};
          if (!valid(cv[c])) {
            ok = false;
            break;
          }
        }
        if (!ok) continue;
        // fast reject: all same side
        bool any_in = false, any_out = false;
        for (int c = 0; c < 8; ++c) {
          if (cv[c] < isovalue) any_in = true;
          else any_out = true;
        }
        if (!any_in || !any_out) continue;

        for (const auto& tet : kTets) {
          Vec3 tp[4];
          double tv[4];
          for (int i = 0; i < 4; ++i) {
            tp[i] = cp[tet[i]];
            tv[i] = cv[tet[i]];
          }
          triangulate_tet(mesh, tp, tv, static_cast<double>(isovalue));
        }
      }
    }
  }

  *out_nverts = static_cast<int64_t>(mesh.verts.size() / 3);
  *out_nfaces = static_cast<int64_t>(mesh.faces.size() / 3);
  *out_verts = static_cast<double*>(malloc(mesh.verts.size() * sizeof(double)));
  *out_faces =
      static_cast<int64_t*>(malloc(mesh.faces.size() * sizeof(int64_t)));
  if ((!*out_verts && !mesh.verts.empty()) ||
      (!*out_faces && !mesh.faces.empty()))
    return 1;
  std::memcpy(*out_verts, mesh.verts.data(),
              mesh.verts.size() * sizeof(double));
  std::memcpy(*out_faces, mesh.faces.data(),
              mesh.faces.size() * sizeof(int64_t));
  return 0;
}

void mc_free(void* p) { free(p); }

}  // extern "C"
