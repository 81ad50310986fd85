// fastmesh: the host-side mesh engine of dolfinx_materials_tpu_torch.
//
// Host code, not a device kernel: structured quad/hex generation and the
// unique-edge/unique-face extraction that degree-2 dofmaps need, O(ncells)
// integer work that numpy does several times slower. The same algorithms and
// numbering as dolfinx_materials_tpu/native/fastmesh.cpp (first-seen entity
// order, lattice vertex order), so both packages build identical meshes and
// dofmaps. Exposed as a plain C ABI for ctypes.
//
// Build (native/__init__.py does this at first use, into build/native/):
//   g++ -O3 -shared -fPIC fastmesh.cpp -o libfastmesh.so

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {

// Structured quad grid on [p0x,p1x] x [p0y,p1y] with nx*ny cells.
// points_out: (nx+1)*(ny+1)*2 doubles; cells_out: nx*ny*4 int32 (CCW).
void structured_quad_mesh(int64_t nx, int64_t ny, const double* bounds,
                          double* points_out, int32_t* cells_out) {
  const double p0x = bounds[0], p0y = bounds[1], p1x = bounds[2], p1y = bounds[3];
  const double hx = (p1x - p0x) / nx, hy = (p1y - p0y) / ny;
  for (int64_t i = 0; i <= nx; ++i) {
    for (int64_t j = 0; j <= ny; ++j) {
      const int64_t v = i * (ny + 1) + j;
      points_out[2 * v] = p0x + hx * i;
      points_out[2 * v + 1] = p0y + hy * j;
    }
  }
  int64_t c = 0;
  for (int64_t i = 0; i < nx; ++i) {
    for (int64_t j = 0; j < ny; ++j) {
      const int32_t v00 = (int32_t)(i * (ny + 1) + j);
      const int32_t v10 = (int32_t)((i + 1) * (ny + 1) + j);
      cells_out[4 * c] = v00;
      cells_out[4 * c + 1] = v10;
      cells_out[4 * c + 2] = v10 + 1;
      cells_out[4 * c + 3] = v00 + 1;
      ++c;
    }
  }
}

// Structured hex grid with nx*ny*nz cells; z-fastest vertex numbering matching
// fem/mesh.py. points_out: (nx+1)(ny+1)(nz+1)*3; cells_out: ncells*8.
void structured_hex_mesh(int64_t nx, int64_t ny, int64_t nz, const double* bounds,
                         double* points_out, int32_t* cells_out) {
  const double p0x = bounds[0], p0y = bounds[1], p0z = bounds[2];
  const double p1x = bounds[3], p1y = bounds[4], p1z = bounds[5];
  const double hx = (p1x - p0x) / nx, hy = (p1y - p0y) / ny, hz = (p1z - p0z) / nz;
  const int64_t sy = nz + 1, sx = (ny + 1) * (nz + 1);
  for (int64_t i = 0; i <= nx; ++i)
    for (int64_t j = 0; j <= ny; ++j)
      for (int64_t k = 0; k <= nz; ++k) {
        const int64_t v = i * sx + j * sy + k;
        points_out[3 * v] = p0x + hx * i;
        points_out[3 * v + 1] = p0y + hy * j;
        points_out[3 * v + 2] = p0z + hz * k;
      }
  int64_t c = 0;
  for (int64_t i = 0; i < nx; ++i)
    for (int64_t j = 0; j < ny; ++j)
      for (int64_t k = 0; k < nz; ++k) {
        const int64_t v = i * sx + j * sy + k;
        int32_t* cc = cells_out + 8 * c;
        cc[0] = (int32_t)v;
        cc[1] = (int32_t)(v + sx);
        cc[2] = (int32_t)(v + sx + sy);
        cc[3] = (int32_t)(v + sy);
        cc[4] = (int32_t)(v + 1);
        cc[5] = (int32_t)(v + sx + 1);
        cc[6] = (int32_t)(v + sx + sy + 1);
        cc[7] = (int32_t)(v + sy + 1);
        ++c;
      }
}

// Unique-edge extraction.
// In:  ev (ncells*nle*2 int32) per-cell edge vertex pairs (any order).
// Out: cell_edges (ncells*nle int32) edge ids; edge_verts_out (cap*2) unique
//      sorted pairs. Returns the number of unique edges (or -1 if cap too small;
//      call once with cap=ncells*nle which always suffices).
int64_t unique_edges(int64_t ncells, int64_t nle, const int32_t* ev,
                     int32_t* cell_edges, int32_t* edge_verts_out, int64_t cap) {
  std::unordered_map<uint64_t, int32_t> seen;
  seen.reserve((size_t)(ncells * nle));
  int64_t nedges = 0;
  for (int64_t e = 0; e < ncells * nle; ++e) {
    int32_t a = ev[2 * e], b = ev[2 * e + 1];
    if (a > b) { int32_t t = a; a = b; b = t; }
    const uint64_t key = ((uint64_t)(uint32_t)a << 32) | (uint32_t)b;
    auto it = seen.find(key);
    if (it == seen.end()) {
      if (nedges >= cap) return -1;
      seen.emplace(key, (int32_t)nedges);
      edge_verts_out[2 * nedges] = a;
      edge_verts_out[2 * nedges + 1] = b;
      cell_edges[e] = (int32_t)nedges;
      ++nedges;
    } else {
      cell_edges[e] = it->second;
    }
  }
  return nedges;
}

// Unique-face extraction (3D cells; nfv = 3 or 4 vertices per face).
// In:  fv (ncells*nlf*nfv int32) per-cell face vertex tuples (any order).
// Out: cell_faces (ncells*nlf int32) face ids; face_verts_out (cap*nfv) unique
//      SORTED tuples, first-seen order. Returns the unique count (-1: cap).
int64_t unique_faces(int64_t ncells, int64_t nlf, int64_t nfv, const int32_t* fv,
                     int32_t* cell_faces, int32_t* face_verts_out, int64_t cap) {
  struct KeyHash {
    size_t operator()(const std::vector<int32_t>& k) const {
      size_t h = 1469598103934665603ull;
      for (int32_t v : k) {
        h ^= (size_t)(uint32_t)v;
        h *= 1099511628211ull;
      }
      return h;
    }
  };
  std::unordered_map<std::vector<int32_t>, int32_t, KeyHash> seen;
  seen.reserve((size_t)(ncells * nlf));
  std::vector<int32_t> key((size_t)nfv);
  int64_t nfaces = 0;
  for (int64_t f = 0; f < ncells * nlf; ++f) {
    for (int64_t j = 0; j < nfv; ++j) key[(size_t)j] = fv[nfv * f + j];
    // insertion-sort the <=4 vertices
    for (int64_t a = 1; a < nfv; ++a)
      for (int64_t b = a; b > 0 && key[(size_t)b - 1] > key[(size_t)b]; --b) {
        int32_t t = key[(size_t)b];
        key[(size_t)b] = key[(size_t)b - 1];
        key[(size_t)b - 1] = t;
      }
    auto it = seen.find(key);
    if (it == seen.end()) {
      if (nfaces >= cap) return -1;
      seen.emplace(key, (int32_t)nfaces);
      for (int64_t j = 0; j < nfv; ++j)
        face_verts_out[nfv * nfaces + j] = key[(size_t)j];
      cell_faces[f] = (int32_t)nfaces;
      ++nfaces;
    } else {
      cell_faces[f] = it->second;
    }
  }
  return nfaces;
}

}  // extern "C"
