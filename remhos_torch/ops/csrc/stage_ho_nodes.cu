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
// sum-factorized size is of the same order (chip_smoke.py's cost model
// decides which bounds). As written the geometry is dense per-point dots
// over the nm nodes (geom_conv.cu's) and the contractions are the core's
// dense table products: the arithmetic, not the bytes, sets this first
// version's time. The design is the other stage kernels' (one block per tile
// of TE elements, per-element vectors in shared memory, plain FMA in the
// working type, no TF32); no 128-lane padding and no block-diagonal face
// tables, which are TPU devices.
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
  T* du;       // [E, nd] out
  T* wdet;     // [E, Q] out
};

template <typename T, int DIM>
size_t smem_bytes(int nd, int Q, int Qf, int nf, int fd, int nm) {
  constexpr int TE = Tile<T, DIM>::TE;
  const size_t n = core_smem_len(DIM, nd, Q, Qf, nf, fd) + 2 * (size_t)nm * DIM;
  return n * TE * sizeof(T);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(NT, Tile<T, DIM>::MINB)
stage_ho_nodes_kernel(const Args<T, DIM> a) {
  constexpr int TE = Tile<T, DIM>::TE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int nd = a.c.nd, Q = a.c.Q;
  const CoreSmem<T> s =
      core_smem<T, DIM, TE>(sm, nd, Q, a.c.nf * a.c.Qf, a.c.nf * a.c.fd);
  NodeGeom<T, DIM> g = a.g;
  g.s_x = s.end;                         // [TE][nm*DIM]
  g.s_v = g.s_x + TE * g.nm * DIM;

  const int tid = threadIdx.x;
  const int e_base = blockIdx.x * TE;
  const int ne = min(TE, a.c.E - e_base);

  T* s_res = stage_core<T, DIM, TE>(a.c, g, s, e_base, ne);
  __syncthreads();
  for (int idx = tid; idx < TE * nd; idx += NT) {
    const int e = idx / nd, j = idx % nd;
    if (e < ne) a.du[(size_t)(e_base + e) * nd + j] = s_res[j * TE + e];
  }
  for (int idx = tid; idx < TE * Q; idx += NT) {
    const int e = idx / Q, q = idx % Q;
    if (e < ne) a.wdet[(size_t)(e_base + e) * Q + q] = s.wdet[q * TE + e];
  }
}

template <typename T, int DIM>
int launch(const void* const* p, double mode, const int* sz,
           cudaStream_t stream) {
  constexpr int TE = Tile<T, DIM>::TE;
  Args<T, DIM> a;
  fill_core_args(a.c, p, sz);
  a.c.with_face = sz[8];
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
  g.nm = sz[7];
  g.Q = a.c.Q;
  g.FQ = a.c.nf * a.c.Qf;
  a.du = static_cast<T*>(const_cast<void*>(q[8]));
  a.wdet = static_cast<T*>(const_cast<void*>(q[9]));
  if (a.c.E <= 0) return 0;
  if (a.c.n_cg < 0) return -4;
  if (DIM == 3 && g.GT2 == nullptr) return -5;
  const size_t smem = smem_bytes<T, DIM>(a.c.nd, a.c.Q, a.c.Qf, a.c.nf,
                                         a.c.fd, g.nm);
  if (smem > 227 * 1024) return -3;
  cudaError_t err = cudaFuncSetAttribute(
      stage_ho_nodes_kernel<T, DIM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.c.E + TE - 1) / TE;
  stage_ho_nodes_kernel<T, DIM><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: the core's 15 device pointers in CoreArgs order (slot 2, P, unused:
// null), then xs, v, GmT, BmT, GT1, GT2 (null in 2D), BmfT, w_q, du, wdet;
// sizes: E, nd, Q, Qf, nf, fd, n_cg, nm, with_face; mode is +1 or -1.
// Returns 0, a CUDA error code (> 0), or < 0 for a bad argument.
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
