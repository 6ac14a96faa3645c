// The full HO remap stage (-ho 3 -pa) in one CUDA kernel, with the stage
// geometry derived from the nodes inside the kernel.
//
// Replaces: fused_stage_ho / _stage_ho_kernel in
//   remhos_tpu/ops/pallas_kernels.py (:490 / :265).
//
// What it computes, per element: steps 0-6 of stage_core() (stage_core.cuh)
// with the MeshGeom provider (mesh_geom.cuh) and its face part: from the
// nodes xs and the nodal velocity v the Jacobian, its cofactors and det J,
// v_q and the convective velocity at the volume points; the face tangents,
// the normal and v . n at the face points; the volume convection and the DG
// upwind flux max(0, mode vn) (u_nbr - u) scattered to the face dofs; then
// n_cg Jacobi sweeps of the GL mass inverse and du_HO = x A^T. It writes
//   du_HO[E, nd]   (Ku instead when n_cg == 0),
//   wdet[E, Q]     (w_q det J, unpadded).
// mode (+1 remap, -1 transport) is also the volume sign; with_face == 0
// skips the face flux and the face geometry (a phase ablation). Kernel 2
// (stage_ho.cu) is the same core with the geometry as t-polynomials.
//
// What bounds it on the H100: at N=24, mesh order 2, p=3 in f32 it reads xs
// and v (4.5 MB each), u (3.5 MB) and u_nbr (5.3 MB) and writes du (3.5 MB)
// and wdet (11.9 MB): ~33 MB, ~10 us at 3.35 TB/s; its sum-factorized
// operations take longer, 0.0205 ms at 67 TFLOP/s (utils/cost.py). The
// first version took its geometry from dense per-point dots over the nm
// nodes (NodeGeom: a table load per multiply-add, 0.29 of its 0.426 ms).
// What the design does about it: the geometry is MeshGeom's, axis by axis
// on the 1D mesh tables, the volume part kernel 4's and the face part from
// each face's nodes (its head note). The shared memory of a tile is the
// core's layout without ml; the provider's scratch (staged nodes, axis-0
// results) lies over the core's scratch, free until the core's first pass,
// and vn over inv, b, x and ku, which the core first writes after its face
// flux has read vn; te is the most elements that let min_blocks blocks
// share an SM (6 in f32, 3 blocks; 5 in f64, 2 blocks, at p=3 in 3D).
// The sizes are compiled for mesh order 2 at p = 2..4; at other p the
// core runs its runtime sizes, but mesh order 2 keeps the provider's
// compiled extents (its register arrays spill at runtime extents).
// Now (H100 80GB HBM3, 700 W, tools/kernel_variants.py, device-paced):
// 0.1141 ms f32, 0.3607 f64, 5.6x the bound in f32. What holds it now is
// the core's (its head note): its passes read every table entry from
// shared memory (kernel 6 left that limit with its tables in the constant
// bank; the core is kernel 1's, 2's and 4's too, and stays as it is here).
//
// Tried and slower (same card and setting, ms f32 / f64): 7 elements a
// tile at 2 blocks an SM in f32: 0.1215 / 0.3606 (f64 unchanged); vn after
// the core's arrays instead of over the sweep arrays: 0.1141 / 0.3912 (f64
// loses an element a tile) (tools/kernel_variants.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "mesh_geom.cuh"

namespace {

using namespace remhos;

template <typename T, int DIM, int MT, int QT>
struct Args {
  CoreArgs<T> c;
  MeshGeom<T, DIM, MT, QT, true, true> g;
  CoreLayout L;
  int o_mtab, o_va, o_scr, o_vn;   // the provider's shared arrays
  T* du;       // [E, nd] out
  T* wdet;     // [E, Q] out
};

template <typename T, int DIM, int DT, int QT, int MT>
__global__ void __launch_bounds__(NT, min_blocks<T>())
stage_ho_nodes_kernel(const __grid_constant__ Args<T, DIM, MT, QT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const CoreLayout& L = a.L;
  const int te = a.c.te, nd = a.c.nd, Q = a.c.Q, E = a.c.E;
  MeshGeom<T, DIM, MT, QT, true, true> g = a.g;
  g.s_tab = sm + a.o_mtab;
  g.s_va = sm + a.o_va;
  g.s_wd = sm + L.wdet;        // the core's wdet array: volume() reads it
  g.s_scr = sm + a.o_scr;
  g.s_vn = sm + a.o_vn;
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
    for (int i = tid; i < ne * nd; i += NT) a.du[g0 + i] = s_res[i];
    const size_t w0 = (size_t)e_base * Q;
    for (int i = tid; i < ne * Q; i += NT) a.wdet[w0 + i] = s_w[i];
    __syncthreads();     // the next tile reuses the shared arrays
  }
}

template <typename T, int DIM, int DT, int QT, int MT>
int launch_sized(const Args<T, DIM, MT, QT>& a, size_t smem,
                 cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(
      &stage_ho_nodes_kernel<T, DIM, DT, QT, MT>);
  int grid = 0;
  const int rc = persistent_grid(fn, smem, (a.c.E + a.c.te - 1) / a.c.te,
                                 &grid);
  if (rc != 0) return rc;
  stage_ho_nodes_kernel<T, DIM, DT, QT, MT><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The shared memory of a tile of te elements: the core's layout without
// ml; the provider's scratch over the core's scratch (from L.A, free until
// the core's first pass); vn over inv, b, x and ku, which the core first
// writes after its face flux has read vn, where it fits (else after the
// core's arrays); then the mesh tables and va. Sets the offsets in *a;
// returns the bytes.
template <typename T, int DIM, int MT, int QT>
size_t layout(Args<T, DIM, MT, QT>* a, int te) {
  const int D = a->c.D, Q1 = a->c.Q1, m1 = a->g.m1_;
  const int Qv = DIM == 3 ? Q1 * Q1 * Q1 : Q1 * Q1;
  const CoreLayout L = core_layout(DIM, D, Q1, a->c.nf, te, false, false);
  const int scr = al4(te * a->g.sx);
  const int vn = te * a->c.nf * a->c.Qf;
  int o = L.A + scr > L.end ? L.A + scr : L.end;
  a->L = L;
  a->o_scr = L.A;
  if (vn <= L.cf - L.inv) {
    a->o_vn = L.inv;
  } else {
    a->o_vn = o;
    o += al4(vn);
  }
  a->o_mtab = o;
  o += al4(2 * Q1 * m1);
  a->o_va = o;
  o += al4(te * DIM * Qv);
  return (size_t)o * sizeof(T);
}

// Shared memory a block may take: as many blocks an SM as the registers
// allow (min_blocks), each with 1 KB of the SM's 228 KB kept for the system.
template <typename T>
constexpr size_t smem_budget() {
  return (228 * 1024) / min_blocks<T>() - 1024;
}

template <typename T, int DIM, int MT, int QT>
int launch_as(Args<T, DIM, MT, QT>& a, cudaStream_t stream) {
  const int Q1 = a.c.Q1;
  const int NL = DIM == 3 ? Q1 * Q1 : Q1;
  a.c.te = choose_te(NT / NL, smem_budget<T>(),
                     [&](int te) { return layout(&a, te); });
  const size_t smem = layout(&a, a.c.te);
  if (smem > SMEM_MAX) return -3;
  constexpr int X = DIM == 3 ? 2 : 1;
  constexpr int DT = QT ? QT - X : 0;
  return launch_sized<T, DIM, DT, QT, MT>(a, smem, stream);
}

template <typename T, int DIM>
int launch(const void* const* p, double mode, const int* sz,
           cudaStream_t stream) {
  CoreArgs<T> c;
  fill_core_args(c, p, sz);
  c.with_face = sz[10];
  const void* const* q = p + N_CORE_PTRS;
  const int E = c.E, nm = sz[9], m1 = sz[11];
  if (E <= 0) return 0;
  if (c.n_cg < 0) return -4;
  int rc = check_core_sizes(DIM, sz);
  if (rc == 0) rc = check_mesh_sizes(DIM, nm, c.Q, m1, c.Q1);
  if (rc != 0) return rc;
  auto fill = [&](auto& a) {
    a.c = c;
    auto& g = a.g;
    g.xs = static_cast<const T*>(q[0]);
    g.v = static_cast<const T*>(q[1]);
    g.msf = static_cast<const T*>(q[2]);
    g.fdesc = c.with_face ? static_cast<const int*>(q[3]) : nullptr;
    g.w_q = static_cast<const T*>(q[4]);
    g.mode = static_cast<T>(mode);
    g.m1_ = m1;
    g.Q1_ = c.Q1;
    g.with_det = 1;
    g.sx = mesh_scratch(DIM, m1, c.Q1, true);
    g.s_tab = g.s_va = g.s_wd = g.s_scr = g.s_vn = nullptr;
    a.du = static_cast<T*>(const_cast<void*>(q[5]));
    a.wdet = static_cast<T*>(const_cast<void*>(q[6]));
  };
  // compiled where both the core's sizes and the mesh's are; at mesh order
  // 2 with the core's runtime sizes (p = 1, 5, ...) the mesh's m1 = 3 is
  // compiled still: the provider's register arrays do not spill
  constexpr int X = DIM == 3 ? 2 : 1;
  switch (size_case(DIM, c.D, c.Q1) ? mesh_size_case(DIM, m1, c.Q1) : 0) {
    case 3 + X: { Args<T, DIM, 3, 3 + X> a; fill(a); return launch_as(a, stream); }
    case 4 + X: { Args<T, DIM, 3, 4 + X> a; fill(a); return launch_as(a, stream); }
    case 5 + X: { Args<T, DIM, 3, 5 + X> a; fill(a); return launch_as(a, stream); }
    default:
      if (m1 == 3) { Args<T, DIM, 3, 0> a; fill(a); return launch_as(a, stream); }
      { Args<T, DIM, 0, 0> a; fill(a); return launch_as(a, stream); }
  }
}

}  // namespace

extern "C" {

// ptrs: the core's 6 device pointers (u, u_nbr, P (unused: null), sf, bdr,
// dof_faces), then xs, v, msf (the packed 1D mesh tables,
// ops/tables.MESH_TABLES), fdesc (int32 [nf, 5], ops/tables.face_descriptors),
// w_q, du, wdet; sizes: E, nd, Q, Qf, nf, fd, n_cg, D, Q1, nm, with_face, m1;
// mode is +1 or -1. Returns 0, a CUDA error code (> 0), or < 0 for a bad
// argument (-1: counts; -2: type or dimension; -3: shared memory; -4:
// n_cg; -5: not a tensor-product element within DMAX, QMAX).
int remhos_stage_ho_nodes(int dtype_bytes, int dim, const void* const* ptrs,
                          int nptrs, double mode, const int* sizes,
                          int nsizes, void* stream) {
  if (nptrs != N_CORE_PTRS + 7 || nsizes != N_CORE_SIZES + 3) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4 && dim == 3) return launch<float, 3>(ptrs, mode, sizes, s);
  if (dtype_bytes == 8 && dim == 3) return launch<double, 3>(ptrs, mode, sizes, s);
  if (dtype_bytes == 4 && dim == 2) return launch<float, 2>(ptrs, mode, sizes, s);
  if (dtype_bytes == 8 && dim == 2) return launch<double, 2>(ptrs, mode, sizes, s);
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
