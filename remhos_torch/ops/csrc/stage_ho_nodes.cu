// The full HO remap stage (-ho 3 -pa) in one CUDA kernel, with the stage
// geometry derived from the nodes inside the kernel.
//
// Replaces: fused_stage_ho / _stage_ho_kernel in
//   remhos_tpu/ops/pallas_kernels.py (:490 / :265).
//
// What it computes, per element: steps 0-6 of stage_core() (stage_core.cuh)
// with the NodeGeom provider: from the nodes xs and the nodal velocity v the
// Jacobian, its cofactors and det J, v_q and the convective velocity at the
// volume points; the face tangents, the normal and v . n at the face points;
// the volume convection and the DG upwind flux max(0, mode vn) (u_nbr - u)
// scattered to the face dofs; then n_cg Jacobi sweeps of the GL mass inverse
// and du_HO = x A^T. It writes
//   du_HO[E, nd]   (Ku instead when n_cg == 0),
//   wdet[E, Q]     (w_q det J, unpadded).
// mode (+1 remap, -1 transport) is also the volume sign; with_face == 0
// skips the face flux (a phase ablation). Kernel 2 (stage_ho.cu) is the
// same core with the geometry as t-polynomials instead.
//
// What bounds it on the H100: at N=24, mesh order 2, p=3 in f32 it reads xs
// and v (4.5 MB each), u (3.5 MB) and u_nbr (5.3 MB) and writes du (3.5 MB)
// and wdet (11.9 MB), ~33 MB, ~10 us at 3.35 TB/s. Its arithmetic at
// sum-factorized size is of the same order (remhos_torch/utils/cost.py
// decides which bounds): the geometry is dense per-point dots over the nm
// nodes (geom_conv.cu's), ~100 multiply-adds a point. The contractions are
// the sum-factorized core of stage_core.cuh (its head comment), shared with
// kernels 1 and 2; the blocks are persistent over tiles of te elements;
// plain FMA in the working type, no TF32; no 128-lane padding and no
// block-diagonal face tables, which are TPU devices.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "stage_core.cuh"

namespace {

using namespace remhos;

template <typename T, int DIM>
struct Args {
  CoreArgs<T> c;
  NodeGeom<T, DIM> g;
  CoreLayout L;
  T* du;       // [E, nd] out
  T* wdet;     // [E, Q] out
};

template <typename T, int DIM, int DT, int QT>
__global__ void __launch_bounds__(NT, min_blocks<T>())
stage_ho_nodes_kernel(const __grid_constant__ Args<T, DIM> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const CoreLayout& L = a.L;
  const int te = a.c.te, nd = a.c.nd, Q = a.c.Q, E = a.c.E;
  NodeGeom<T, DIM> g = a.g;
  g.s_x = sm + L.end;                    // [te][nm*DIM]
  g.s_v = g.s_x + te * g.nm * DIM;
  const T* s_w = sm + L.wdet;
  const int tid = threadIdx.x;

  load_tables(a.c, sm, L);
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

template <typename T, int DIM, int DT, int QT>
int launch_sized(const Args<T, DIM>& a, size_t smem, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(
      &stage_ho_nodes_kernel<T, DIM, DT, QT>);
  int grid = 0;
  const int rc = persistent_grid(fn, smem, (a.c.E + a.c.te - 1) / a.c.te,
                                 &grid);
  if (rc != 0) return rc;
  stage_ho_nodes_kernel<T, DIM, DT, QT><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DIM>
int launch(const void* const* p, double mode, const int* sz,
           cudaStream_t stream) {
  Args<T, DIM> a;
  fill_core_args(a.c, p, sz);
  a.c.with_face = sz[10];
  const void* const* q = p + N_CORE_PTRS;
  NodeGeom<T, DIM>& g = a.g;
  g.xs = static_cast<const T*>(q[0]);
  g.v = static_cast<const T*>(q[1]);
  g.GmT = static_cast<const T*>(q[2]);
  g.BmT = static_cast<const T*>(q[3]);
  g.GT1 = static_cast<const T*>(q[4]);
  g.GT2 = static_cast<const T*>(q[5]);
  g.BmfT = static_cast<const T*>(q[6]);
  g.w_q = static_cast<const T*>(q[7]);
  g.s_x = g.s_v = nullptr;
  g.mode = static_cast<T>(mode);
  g.nm = sz[9];
  g.Q = a.c.Q;
  g.FQ = a.c.nf * a.c.Qf;
  a.du = static_cast<T*>(const_cast<void*>(q[8]));
  a.wdet = static_cast<T*>(const_cast<void*>(q[9]));
  if (a.c.E <= 0) return 0;
  if (a.c.n_cg < 0) return -4;
  if (DIM == 3 && g.GT2 == nullptr) return -5;
  int rc = check_core_sizes(DIM, sz);
  if (rc != 0) return rc;
  size_t smem = 0;
  a.c.te = tile_elements(DIM, a.c.D, a.c.Q1, a.c.nf, sizeof(T),
                         2 * g.nm * DIM, &a.L, &smem);
  if (smem > SMEM_MAX) return -3;
  switch (size_case(DIM, a.c.D, a.c.Q1)) {
    case 3: return launch_sized<T, DIM, 3, 3 + (DIM == 3 ? 2 : 1)>(a, smem, stream);
    case 4: return launch_sized<T, DIM, 4, 4 + (DIM == 3 ? 2 : 1)>(a, smem, stream);
    case 5: return launch_sized<T, DIM, 5, 5 + (DIM == 3 ? 2 : 1)>(a, smem, stream);
    default: return launch_sized<T, DIM, 0, 0>(a, smem, stream);
  }
}

}  // namespace

extern "C" {

// ptrs: the core's 6 device pointers (u, u_nbr, P (unused: null), sf, bdr,
// dof_faces), then xs, v, GmT, BmT, GT1, GT2 (null in 2D), BmfT, w_q, du,
// wdet; sizes: E, nd, Q, Qf, nf, fd, n_cg, D, Q1, nm, with_face; mode is +1
// or -1. Returns 0, a CUDA error code (> 0), or < 0 for a bad argument.
int remhos_stage_ho_nodes(int dtype_bytes, int dim, const void* const* ptrs,
                          int nptrs, double mode, const int* sizes,
                          int nsizes, void* stream) {
  if (nptrs != N_CORE_PTRS + 10 || nsizes != N_CORE_SIZES + 2) return -1;
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
