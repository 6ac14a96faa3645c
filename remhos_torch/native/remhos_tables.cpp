// Native setup tables and the MFEM mesh parser of remhos_torch: the port's
// own copy of the JAX package's remhos_tables.cpp, built with g++ at first
// use into remhos_torch/_build/ (native/tables.py).
//
// The reference's setup phase (mesh loading, DofInfo table construction,
// neighbor topology — remhos_tools.cpp:356-734, mfem Mesh IO) is C++; this
// file builds the static index tables of a structured grid at C speed and
// parses MFEM .mesh files (the inline and the v1.0 formats, with vertices
// or per-element L2 nodes), so that the reference's data files and the
// files `vis.py` writes load directly.
//
// Plain C ABI (no pybind11); Python binds it with ctypes (tables.py).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Element face-neighbor table for a structured grid.
// shape[dim]: elements per axis; periodic[dim]: wrap flags.
// out[E * 2*dim], MFEM local-face order (see mesh.py FACES_*),
// -1 marks a physical boundary.
// ---------------------------------------------------------------------
int build_neighbor_table(int dim, const int64_t* shape,
                         const uint8_t* periodic, int32_t* out) {
  static const int F1[2][2] = {{0, 0}, {0, 1}};
  static const int F2[4][2] = {{1, 0}, {0, 1}, {1, 1}, {0, 0}};
  static const int F3[6][2] = {{2, 0}, {1, 0}, {0, 1}, {1, 1}, {0, 0}, {2, 1}};
  const int(*faces)[2] = dim == 1 ? F1 : (dim == 2 ? F2 : F3);
  const int nf = 2 * dim;

  int64_t E = 1, strides[3] = {1, 1, 1};
  for (int d = 0; d < dim; d++) {
    strides[d] = E;
    E *= shape[d];
  }
  std::vector<int64_t> idx(dim, 0);
  for (int64_t e = 0; e < E; e++) {
    for (int f = 0; f < nf; f++) {
      const int axis = faces[f][0], side = faces[f][1];
      int64_t t = idx[axis] + (side == 1 ? 1 : -1);
      int32_t nbr;
      if (t < 0 || t >= shape[axis]) {
        if (periodic[axis]) {
          t = (t + shape[axis]) % shape[axis];
          nbr = (int32_t)(e + (t - idx[axis]) * strides[axis]);
        } else {
          nbr = -1;
        }
      } else {
        nbr = (int32_t)(e + (t - idx[axis]) * strides[axis]);
      }
      out[e * nf + f] = nbr;
    }
    // advance multi-index (x fastest)
    for (int d = 0; d < dim; d++) {
      if (++idx[d] < shape[d]) break;
      idx[d] = 0;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// Global CG (shared-node) index table: out[E * (q+1)^dim] node ids,
// lexicographic dofs (x fastest), used by the overlap-bounds stencil.
// ---------------------------------------------------------------------
int build_cg_index(int dim, const int64_t* shape, const uint8_t* periodic,
                   int q, int32_t* out) {
  int64_t E = 1;
  int64_t gshape[3], gstrides[3] = {1, 1, 1};
  for (int d = 0; d < dim; d++) {
    E *= shape[d];
    gshape[d] = periodic[d] ? q * shape[d] : q * shape[d] + 1;
  }
  for (int d = 1; d < dim; d++) gstrides[d] = gstrides[d - 1] * gshape[d - 1];

  const int n1 = q + 1;
  int64_t nd = 1;
  for (int d = 0; d < dim; d++) nd *= n1;

  std::vector<int64_t> idx(dim, 0);
  for (int64_t e = 0; e < E; e++) {
    for (int64_t j = 0; j < nd; j++) {
      int64_t jj = j, gid = 0;
      for (int d = 0; d < dim; d++) {
        int64_t k = jj % n1;
        jj /= n1;
        int64_t g = q * idx[d] + k;
        if (periodic[d]) g %= gshape[d];
        gid += g * gstrides[d];
      }
      out[e * nd + j] = (int32_t)gid;
    }
    for (int d = 0; d < dim; d++) {
      if (++idx[d] < shape[d]) break;
      idx[d] = 0;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// MFEM mesh parsing.
// Supports "MFEM INLINE mesh v1.0" (type=quad/hex/segment, nx/ny/nz,
// sx/sy/sz) and "MFEM mesh v1.0" with vertices / per-element L2 nodes.
// Two-call protocol: first query sizes, then fill buffers.
// ---------------------------------------------------------------------

struct ParsedMesh {
  int dim = 0;
  int64_t n_elems = 0;
  int64_t n_verts = 0;
  int verts_per_elem = 0;
  std::vector<int64_t> elem_verts;  // [n_elems * verts_per_elem]
  std::vector<double> verts;        // [n_verts * dim]
  int has_l2_nodes = 0;             // per-element nodes present (periodic)
  int l2_order = 0;
  std::vector<double> l2_nodes;     // [n_elems * (order+1)^dim * dim]
  // inline format:
  int is_inline = 0;
  int64_t inline_n[3] = {0, 0, 0};
  double inline_s[3] = {0, 0, 0};
};

static ParsedMesh* g_last = nullptr;

static bool next_token(FILE* f, std::string& tok) {
  tok.clear();
  int c;
  while ((c = fgetc(f)) != EOF) {
    if (c == '#') {  // comment to end of line
      while ((c = fgetc(f)) != EOF && c != '\n') {
      }
      continue;
    }
    if (isspace(c)) {
      if (!tok.empty()) return true;
      continue;
    }
    tok.push_back((char)c);
  }
  return !tok.empty();
}

int parse_mfem_mesh(const char* path, int64_t* dims_out) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  delete g_last;
  g_last = new ParsedMesh();
  ParsedMesh& M = *g_last;

  // header line
  char header[256];
  if (!fgets(header, sizeof header, f)) {
    fclose(f);
    return -2;
  }
  std::string tok;
  if (strstr(header, "INLINE")) {
    M.is_inline = 1;
    std::string type;
    while (next_token(f, tok)) {
      if (tok == "type") {
        next_token(f, tok);  // '='
        if (tok == "=") next_token(f, tok);
        type = tok;
      } else if (tok == "nx" || tok == "ny" || tok == "nz" || tok == "sx" ||
                 tok == "sy" || tok == "sz") {
        std::string key = tok;
        next_token(f, tok);
        if (tok == "=") next_token(f, tok);
        double v = atof(tok.c_str());
        int a = key[1] - 'x';
        if (key[0] == 'n')
          M.inline_n[a] = (int64_t)v;
        else
          M.inline_s[a] = v;
      }
    }
    M.dim = type == "hex" ? 3 : (type == "quad" ? 2 : 1);
  } else {
    int section = 0;  // 1 elements, 2 vertices, 3 nodes
    int64_t remaining = 0;
    std::vector<double> vert_flat;
    int vdim_nodes = 0;
    while (next_token(f, tok)) {
      if (tok == "dimension") {
        next_token(f, tok);
        M.dim = atoi(tok.c_str());
      } else if (tok == "elements") {
        next_token(f, tok);
        M.n_elems = atoll(tok.c_str());
        // rows: attr geom v0 v1 ...
        for (int64_t e = 0; e < M.n_elems; e++) {
          next_token(f, tok);  // attr
          next_token(f, tok);  // geom type
          int geom = atoi(tok.c_str());
          int nv = geom == 5 ? 8 : (geom == 3 ? 4 : (geom == 1 ? 2 : 0));
          if (nv == 0) {
            fclose(f);
            return -3;  // unsupported geometry
          }
          if (M.verts_per_elem != 0 && nv != M.verts_per_elem) {
            fclose(f);
            return -4;  // mixed element geometries
          }
          M.verts_per_elem = nv;
          for (int v = 0; v < nv; v++) {
            next_token(f, tok);
            M.elem_verts.push_back(atoll(tok.c_str()));
          }
        }
      } else if (tok == "boundary") {
        next_token(f, tok);
        int64_t nb = atoll(tok.c_str());
        for (int64_t b = 0; b < nb; b++) {
          next_token(f, tok);  // attr
          next_token(f, tok);  // geom
          int geom = atoi(tok.c_str());
          int nv = geom == 3 ? 4 : (geom == 1 ? 2 : (geom == 0 ? 1 : 0));
          for (int v = 0; v < nv; v++) next_token(f, tok);
        }
      } else if (tok == "vertices") {
        next_token(f, tok);
        M.n_verts = atoll(tok.c_str());
        // next token is either the vdim (then coords follow) or a section
        long pos = ftell(f);
        if (next_token(f, tok)) {
          bool numeric = !tok.empty() &&
                         (isdigit(tok[0]) || tok[0] == '-' || tok[0] == '+');
          if (numeric && tok.size() <= 2) {
            int vdim = atoi(tok.c_str());
            // keep dim coordinates per vertex: the caller's buffer holds
            // n_verts * dim (a 2D mesh may list 3D vertex coordinates)
            for (int64_t i = 0; i < M.n_verts * vdim; i++) {
              next_token(f, tok);
              if (i % vdim < M.dim) M.verts.push_back(atof(tok.c_str()));
            }
          } else {
            fseek(f, pos, SEEK_SET);  // 'nodes' section follows
          }
        }
      } else if (tok == "nodes") {
        // FiniteElementSpace block: L2 per-element nodes (periodic mesh)
        std::string fec;
        int vdim = M.dim, ordering = 1;
        while (next_token(f, tok)) {
          if (tok == "FiniteElementCollection:") {
            next_token(f, fec);
          } else if (tok == "VDim:") {
            next_token(f, tok);
            vdim = atoi(tok.c_str());
          } else if (tok == "Ordering:") {
            next_token(f, tok);
            ordering = atoi(tok.c_str());
            break;
          } else if (tok == "FiniteElementSpace") {
            continue;
          } else {
            break;
          }
        }
        if (fec.rfind("L2", 0) == 0) {
          // per-element (periodic / discontinuous) nodes
          int order = 1;
          size_t p = fec.rfind('P');
          if (p != std::string::npos) order = atoi(fec.c_str() + p + 1);
          M.has_l2_nodes = 1;
          M.l2_order = order;
          int64_t ndn = 1;
          for (int d = 0; d < M.dim; d++) ndn *= (order + 1);
          int64_t total = M.n_elems * ndn * vdim;
          for (int64_t i = 0; i < total; i++) {
            if (!next_token(f, tok)) break;
            M.l2_nodes.push_back(atof(tok.c_str()));
          }
        } else {
          // vertex-based (H1/"Linear") node grid function
          std::vector<double> vals;
          vals.reserve(M.n_verts * vdim);
          for (int64_t i = 0; i < M.n_verts * vdim; i++) {
            if (!next_token(f, tok)) break;
            vals.push_back(atof(tok.c_str()));
          }
          M.verts.assign(M.n_verts * M.dim, 0.0);
          for (int64_t v = 0; v < M.n_verts; v++)
            for (int d = 0; d < M.dim; d++)
              M.verts[v * M.dim + d] =
                  ordering == 0 ? vals[d * M.n_verts + v]
                                : vals[v * vdim + d];
        }
      }
    }
    (void)section;
    (void)remaining;
    (void)vdim_nodes;
    if (!vert_flat.empty()) {
    }
  }
  fclose(f);
  dims_out[0] = M.dim;
  dims_out[1] = M.is_inline ? M.inline_n[0] * (M.dim > 1 ? M.inline_n[1] : 1) *
                                  (M.dim > 2 ? M.inline_n[2] : 1)
                            : M.n_elems;
  dims_out[2] = M.n_verts;
  dims_out[3] = M.verts_per_elem;
  dims_out[4] = M.has_l2_nodes;
  dims_out[5] = M.l2_order;
  dims_out[6] = M.is_inline;
  dims_out[7] = (int64_t)M.l2_nodes.size();
  return 0;
}

int get_inline_spec(int64_t* n, double* s) {
  if (!g_last || !g_last->is_inline) return -1;
  for (int d = 0; d < 3; d++) {
    n[d] = g_last->inline_n[d];
    s[d] = g_last->inline_s[d];
  }
  return 0;
}

int get_mesh_arrays(int64_t* elem_verts, double* verts, double* l2_nodes) {
  if (!g_last) return -1;
  ParsedMesh& M = *g_last;
  if (elem_verts && !M.elem_verts.empty())
    memcpy(elem_verts, M.elem_verts.data(),
           M.elem_verts.size() * sizeof(int64_t));
  if (verts && !M.verts.empty())
    memcpy(verts, M.verts.data(), M.verts.size() * sizeof(double));
  if (l2_nodes && !M.l2_nodes.empty())
    memcpy(l2_nodes, M.l2_nodes.data(), M.l2_nodes.size() * sizeof(double));
  return 0;
}

}  // extern "C"
