// Stage geometry fused with the volume convection action, from the nodal
// mesh positions and the nodal mesh velocity.
//
// Replaces: fused_geom_conv / _geom_conv_kernel in
//   remhos_tpu/ops/pallas_kernels.py (:110 / :55).
//
// What it computes, for every element e:
//   J[d][b]  = sum_n xs[e, n, d] Gm[q, n, b]        Jacobian at point q
//   cof, det   closed form (2x2 or 3x3); wdet[e, q] = w_q[q] det J
//   v_q[d]   = sum_n v[e, n, d] Bm[q, n]            velocity at point q
//   va[b]    = sign sum_d cof[d][b] v_q[d]          (adj J v)
//   g[b]     = sum_j u[e, j] Gu[q, j, b]            reference gradient of u
//   du_q     = sum_b va[b] g[b]
//   Ku[e, i] = sum_q du_q Buw[q, i]                 Buw = w_q Bu
// J, the cofactors, v_q, va and du_q never reach device memory: one read of
// (xs, v, u), one write of Ku and, when asked (with_wdet), of wdet.
//
// Design: the MeshGeom provider (mesh_geom.cuh) feeding stage_core
// (stage_core.cuh) with n_cg == 0 and with_face == 0. Both halves are sum
// factorized: the geometry contracts the nodes with the 1D Gauss-Lobatto
// tables Bm1, Gm1 axis by axis into va and w_q det J in shared memory; the
// core's passes (shared with kernels 1, 2 and 5) form u's gradient, the
// integrand and its transposed contraction with Bw1. The blocks are
// persistent over tiles of te elements (the core's launch slot and grid);
// the provider's scratch (the staged nodes, its axis-0 results) lies over
// the core's scratch arrays, which are free until the core's first pass.
// The core also forms the GL mass matrix's Jacobi diagonal, which n_cg == 0
// leaves unread (a few percent of the multiply-adds).
//
// What bounds it on the H100: at N=24, mesh order 2, p=3 in f32 it reads
// 12.5 MB (xs, v, u) and writes 3.5 MB of Ku, plus 11.9 MB of wdet when
// asked: 4.8 us (8.4 with wdet) at 3.35 TB/s. Its sum-factorized
// arithmetic, ~20k multiply-adds an element (~22k with the diagonal), is
// 0.72 GFLOP, 10.7 us at the f32 FMA rate (utils/cost.py, without the
// diagonal): operations bound it, with and without wdet. The dense first
// version (per-point dots over the nm nodes and nd dofs, ~1.7 G
// multiply-adds, a table load each) ran 0.390 ms (f32), 0.607 ms (f64).
//
// Tried and slower or less accurate (H100 80GB HBM3 at 700 W, 3D N=24,
// p=3, chip_smoke.py step 3 on earlier states of this source): the core's
// full layout, 78.8 KB a block in f32, 2 blocks an SM: 0.0728 ms with
// wdet, 0.0678 without, against 0.0626 / 0.0613 with the volume-only
// layout (62.7 KB, 3 blocks an SM); the nodes' absolute coordinates in the
// contractions: f32 wdet 1.6e-5 of the f32 plain version (limit 1e-5),
// where relative ones lie 3.6e-7 from the f64 evaluation. What holds it
// now: its volume passes keep 112-168 of 256 threads busy (7 elements a
// tile), 11 barriers a tile, 3 blocks an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "mesh_geom.cuh"

namespace {

using namespace remhos;

template <typename T, int DIM, int MT, int QT>
struct Args {
  CoreArgs<T> c;
  MeshGeom<T, DIM, MT, QT, true> g;
  CoreLayout L;
  int o_mtab, o_va, o_scr;   // the provider's shared arrays
  T* Ku;                     // [E, nd] out
  T* wdet;                   // [E, Q] out, null without with_wdet
};

template <typename T, int DIM, int DT, int QT, int MT>
__global__ void __launch_bounds__(NT, min_blocks<T>())
geom_conv_kernel(const __grid_constant__ Args<T, DIM, MT, QT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const CoreLayout& L = a.L;
  const int te = a.c.te, nd = a.c.nd, Q = a.c.Q, E = a.c.E;
  MeshGeom<T, DIM, MT, QT, true> g = a.g;
  g.s_tab = sm + a.o_mtab;
  g.s_va = sm + a.o_va;
  g.s_wd = sm + L.wdet;        // the core's wdet array: volume() reads it
  g.s_scr = sm + a.o_scr;
  const T* s_w = sm + L.wdet;
  const int tid = threadIdx.x;

  load_tables(a.c, sm, L);
  g.init();
  const int ntiles = (E + te - 1) / te;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int e_base = tile * te;
    const int ne = min(te, E - e_base);
    const T* s_res = stage_core<T, DIM, DT, QT>(a.c, g, sm, L, e_base, ne);
    __syncthreads();
    const size_t g0 = (size_t)e_base * nd;
    for (int i = tid; i < ne * nd; i += NT) a.Ku[g0 + i] = s_res[i];
    if (a.wdet != nullptr) {
      const size_t w0 = (size_t)e_base * Q;
      for (int i = tid; i < ne * Q; i += NT) a.wdet[w0 + i] = s_w[i];
    }
    __syncthreads();     // the next tile reuses the shared arrays
  }
}

template <typename T, int DIM, int DT, int QT, int MT>
int launch_sized(const Args<T, DIM, MT, QT>& a, size_t smem,
                 cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(
      &geom_conv_kernel<T, DIM, DT, QT, MT>);
  int grid = 0;
  const int rc = persistent_grid(fn, smem, (a.c.E + a.c.te - 1) / a.c.te,
                                 &grid);
  if (rc != 0) return rc;
  geom_conv_kernel<T, DIM, DT, QT, MT><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The shared memory of a tile of te elements: the core's layout, the
// provider's scratch over the core's scratch (from L.A), then the mesh
// tables and va. Sets the offsets in *a; returns the bytes.
template <typename T, int DIM, int MT, int QT>
size_t layout(Args<T, DIM, MT, QT>* a, int te) {
  const int D = a->c.D, Q1 = a->c.Q1, m1 = a->g.m1_;
  const int Qv = DIM == 3 ? Q1 * Q1 * Q1 : Q1 * Q1;
  const CoreLayout L = core_layout(DIM, D, Q1, a->c.nf, te, true);
  const int scr = al4(te * a->g.sx);
  int o = L.A + scr > L.end ? L.A + scr : L.end;
  a->L = L;
  a->o_scr = L.A;
  a->o_mtab = o;
  o += al4(2 * Q1 * m1);
  a->o_va = o;
  o += al4(te * DIM * Qv);
  return (size_t)o * sizeof(T);
}

template <typename T, int DIM, int MT, int QT>
int launch_as(Args<T, DIM, MT, QT>& a, cudaStream_t stream) {
  const int Q1 = a.c.Q1;
  const int NL = DIM == 3 ? Q1 * Q1 : Q1;
  a.c.te = choose_te(NT / NL, SMEM_BUDGET,
                     [&](int te) { return layout(&a, te); });
  const size_t smem = layout(&a, a.c.te);
  if (smem > SMEM_MAX) return -3;
  constexpr int X = DIM == 3 ? 2 : 1;
  constexpr int DT = MT ? QT - X : 0;
  return launch_sized<T, DIM, DT, QT, MT>(a, smem, stream);
}

template <typename T, int DIM>
int launch(const void* xs, const void* v, const void* u, const void* sf,
           const void* msf, const void* w_q, double sign, void* Ku,
           void* wdet, const int* sz, cudaStream_t stream) {
  const int E = sz[0], nm = sz[1], nd = sz[2], Q = sz[3], D = sz[4],
            Q1 = sz[5], m1 = sz[6];
  if (E <= 0) return 0;
  const int V = DIM == 3 ? D * D * D : D * D;
  if (D < 1 || D > DMAX || nd != V) return -5;
  const int rc = check_mesh_sizes(DIM, nm, Q, m1, Q1);
  if (rc != 0) return rc;
  CoreArgs<T> c{};
  c.u = static_cast<const T*>(u);
  c.unbr = nullptr;
  c.sf = static_cast<const T*>(sf);
  c.bdr = nullptr;
  c.dof_faces = nullptr;
  c.E = E; c.nd = nd; c.Q = Q; c.nf = 2 * DIM; c.D = D; c.Q1 = Q1;
  c.n_cg = 0;
  c.with_face = 0;
  c.need_ml = 0;
  c.te = 1;
  auto fill = [&](auto& a) {
    a.c = c;
    a.g.xs = static_cast<const T*>(xs);
    a.g.v = static_cast<const T*>(v);
    a.g.msf = static_cast<const T*>(msf);
    a.g.w_q = static_cast<const T*>(w_q);
    a.g.mode = static_cast<T>(sign);
    a.g.m1_ = m1;
    a.g.Q1_ = Q1;
    a.g.with_det = wdet != nullptr;
    a.g.sx = mesh_scratch(DIM, m1, Q1, true);
    a.g.s_tab = a.g.s_va = a.g.s_wd = a.g.s_scr = nullptr;
    a.Ku = static_cast<T*>(Ku);
    a.wdet = static_cast<T*>(wdet);
  };
  // compiled where both the core's sizes and the mesh's are
  constexpr int X = DIM == 3 ? 2 : 1;
  switch (size_case(DIM, D, Q1) ? mesh_size_case(DIM, m1, Q1) : 0) {
    case 3 + X: { Args<T, DIM, 3, 3 + X> a; fill(a); return launch_as(a, stream); }
    case 4 + X: { Args<T, DIM, 3, 4 + X> a; fill(a); return launch_as(a, stream); }
    case 5 + X: { Args<T, DIM, 3, 5 + X> a; fill(a); return launch_as(a, stream); }
    default: { Args<T, DIM, 0, 0> a; fill(a); return launch_as(a, stream); }
  }
}

}  // namespace

extern "C" {

// xs[E, nm, dim], v[E, nm, dim], u[E, nd], sf (the core's packed 1D tables,
// ops/tables.SF_TABLES), msf (the packed mesh tables, MESH_TABLES), w_q[Q],
// sign -> Ku[E, nd] and, unless wdet is null, wdet[E, Q]. sizes: E, nm, nd,
// Q, D, Q1, m1. Returns 0, a CUDA error code (> 0), or < 0 for a bad
// argument (-1: sizes; -2: type or dimension; -3: shared memory; -5: not a
// tensor-product element within the bounds DMAX, QMAX).
int remhos_geom_conv(int dtype_bytes, int dim, const void* xs, const void* v,
                     const void* u, const void* sf, const void* msf,
                     const void* w_q, double sign, void* Ku, void* wdet,
                     const int* sizes, int nsizes, void* stream) {
  if (nsizes != 7) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REMHOS_GC(T, D) \
  return launch<T, D>(xs, v, u, sf, msf, w_q, sign, Ku, wdet, sizes, s)
  if (dtype_bytes == 4 && dim == 3) REMHOS_GC(float, 3);
  if (dtype_bytes == 8 && dim == 3) REMHOS_GC(double, 3);
  if (dtype_bytes == 4 && dim == 2) REMHOS_GC(float, 2);
  if (dtype_bytes == 8 && dim == 2) REMHOS_GC(double, 2);
#undef REMHOS_GC
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
