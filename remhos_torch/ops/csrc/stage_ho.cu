// The unlimited HO remap stage (-ho 3 -pa, polynomial stage geometry) in one
// CUDA kernel, with the stage's w_q det J and, optionally, the MassBasedAvg
// LO solution as by-products.
//
// Replaces: fused_stage_ho_poly / _stage_ho_poly_kernel in
//   remhos_tpu/ops/pallas_kernels.py (:809 / :695), with its cores
//   _poly_stage_core (:578) and _mass_based_avg_core (:683).
//
// It runs wherever the fused remap stage cannot collapse into the mega stage
// kernel because something outside needs du_HO, du_LO or wdet: -vb checks,
// dt control, a product field, the IDP-RK steppers. One launch per field per
// stage.
//
// What it computes, per element: steps 0-6 of stage_core() (stage_core.cuh:
// Horner geometry, volume convection, DG upwind face flux, Jacobi GL mass
// inverse), then it writes
//   du_HO[E, nd]   (Ku instead when n_cg == 0),
//   wdet[E, Q]     (w_q det J at the stage time, unpadded),
//   du_LO[E, nd]   when with_lo: (avg(u + dt du_HO) - u) / dt with the
//                  element average taken in the lumped-mass metric
//                  (lo_element_sums); with n_cg == 0 a copy of Ku.
//
// What bounds it on the H100: bytes. At N=24, p=3, f32 with LO it reads P
// (191 MB), u and u_nbr (9 MB) and writes du_HO, wdet and du_LO (19 MB),
// about 219 MB, ~65 us at 3.35 TB/s, against ~10 us of sum-factorized
// arithmetic. The design is the mega stage kernel's (one block per tile of TE
// elements, per-element vectors in shared memory, dense table contractions
// in plain FMA, no TF32): right and simple first. No 128-lane padding and no
// bf16x3 split: those are TPU devices.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "stage_core.cuh"

namespace {

using namespace remhos;

template <typename T, int DIM>
struct Args {
  CoreArgs<T> c;
  PolyGeom<T, DIM> g;
  T* du_ho;    // [E, nd] out
  T* wdet;     // [E, Q] out
  T* du_lo;    // [E, nd] out, nullptr without LO
  T dt;
};

template <typename T, int DIM>
size_t smem_bytes(int nd, int Q, int Qf, int nf, int fd) {
  constexpr int TE = Tile<T, DIM>::TE;
  const size_t n = core_smem_len(DIM, nd, Q, Qf, nf, fd) + nd + 2;
  return n * TE * sizeof(T);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(NT, Tile<T, DIM>::MINB)
stage_ho_kernel(const Args<T, DIM> a) {
  constexpr int TE = Tile<T, DIM>::TE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int nd = a.c.nd, Q = a.c.Q;
  const CoreSmem<T> s =
      core_smem<T, DIM, TE>(sm, nd, Q, a.c.nf * a.c.Qf, a.c.nf * a.c.fd);
  T* s_ml = s.end;               // [nd][TE]
  T* s_red = s_ml + nd * TE;     // [2][TE]: mass, vol

  const int tid = threadIdx.x;
  const int e_base = blockIdx.x * TE;
  const int ne = min(TE, a.c.E - e_base);
  const bool with_lo = a.du_lo != nullptr;
  const bool avg = with_lo && a.c.n_cg != 0;

  T* s_res = stage_core<T, DIM, TE>(a.c, a.g, s, e_base, ne);
  if (avg) contract<T, TE>(s.wdet, Q, a.c.Bu, nd, s_ml);
  __syncthreads();
  if (avg) {
    lo_element_sums<T, TE>(s.u, s_res, s_ml, a.dt, nd, s_red);
    __syncthreads();
  }

  for (int idx = tid; idx < TE * nd; idx += NT) {
    const int e = idx / nd, j = idx % nd;
    if (e >= ne) continue;
    const size_t g = (size_t)(e_base + e) * nd + j;
    const T r = s_res[j * TE + e];
    a.du_ho[g] = r;
    if (with_lo)
      a.du_lo[g] = avg ? (s_red[e] / s_red[TE + e] - s.u[j * TE + e]) / a.dt
                       : r;
  }
  for (int idx = tid; idx < TE * Q; idx += NT) {
    const int e = idx / Q, q = idx % Q;
    if (e < ne) a.wdet[(size_t)(e_base + e) * Q + q] = s.wdet[q * TE + e];
  }
}

template <typename T, int DIM>
int launch(const void* const* p, double t, double dt, const int* sz,
           cudaStream_t stream) {
  constexpr int TE = Tile<T, DIM>::TE;
  Args<T, DIM> a;
  fill_core_args(a.c, p, sz);
  a.g = poly_geom<T, DIM>(p, t, sz);
  a.du_ho = static_cast<T*>(const_cast<void*>(p[N_CORE_PTRS]));
  a.wdet = static_cast<T*>(const_cast<void*>(p[N_CORE_PTRS + 1]));
  a.du_lo = static_cast<T*>(const_cast<void*>(p[N_CORE_PTRS + 2]));
  a.dt = static_cast<T>(dt);
  if (a.c.E <= 0) return 0;
  if (a.c.n_cg < 0) return -4;
  const size_t smem =
      smem_bytes<T, DIM>(a.c.nd, a.c.Q, a.c.Qf, a.c.nf, a.c.fd);
  if (smem > 227 * 1024) return -3;
  cudaError_t err = cudaFuncSetAttribute(
      stage_ho_kernel<T, DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.c.E + TE - 1) / TE;
  stage_ho_kernel<T, DIM><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: the core's 15 device pointers in CoreArgs order, then du_ho, wdet
// and du_lo (null for no LO output); sizes: E, nd, Q, Qf, nf, fd, n_cg.
// dt is read only with an LO output. Returns 0, a CUDA error code (> 0), or
// < 0 for a bad argument.
int remhos_stage_ho(int dtype_bytes, int dim, const void* const* ptrs,
                    int nptrs, double t, double dt, const int* sizes,
                    int nsizes, void* stream) {
  if (nptrs != N_CORE_PTRS + 3 || nsizes != N_CORE_SIZES) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4 && dim == 3) return launch<float, 3>(ptrs, t, dt, sizes, s);
  if (dtype_bytes == 8 && dim == 3) return launch<double, 3>(ptrs, t, dt, sizes, s);
  if (dtype_bytes == 4 && dim == 2) return launch<float, 2>(ptrs, t, dt, sizes, s);
  if (dtype_bytes == 8 && dim == 2) return launch<double, 2>(ptrs, t, dt, sizes, s);
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
