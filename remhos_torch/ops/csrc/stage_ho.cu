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
// With P16 (f32 only) the VA | VN planes come from a bf16 array and P holds
// WDET alone (stage_core.cuh's PolyGeom).
//
// What bounds it on the H100: bytes. At N=24, p=3, f32 with LO it reads P
// (191 MB), u and u_nbr (9 MB) and writes du_HO, wdet and du_LO (19 MB),
// about 219 MB, ~65 us at 3.35 TB/s, against ~10 us of sum-factorized
// arithmetic. The design is the mega stage kernel's: the sum-factorized
// core of stage_core.cuh (its head comment), persistent blocks over tiles of
// te elements, plain FMA in the working type, no TF32. No 128-lane padding
// and no bf16x3 split: those are TPU devices.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "stage_core.cuh"

namespace {

using namespace remhos;

template <typename T, int DIM, bool BF16>
struct Args {
  CoreArgs<T> c;
  PolyGeom<T, DIM, BF16> g;
  CoreLayout L;
  T* du_ho;    // [E, nd] out
  T* wdet;     // [E, Q] out
  T* du_lo;    // [E, nd] out, nullptr without LO
  T dt;
};

template <typename T, int DIM, int DT, int QT, bool BF16>
__global__ void __launch_bounds__(NT, min_blocks<T>())
stage_ho_kernel(const __grid_constant__ Args<T, DIM, BF16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const CoreLayout& L = a.L;
  const int te = a.c.te, nd = a.c.nd, Q = a.c.Q, E = a.c.E;
  T* s_red = sm + L.end;           // [2][te]: mass, vol
  const T* s_u = sm + L.u;
  const T* s_ml = sm + L.ml;
  const T* s_w = sm + L.wdet;
  const int tid = threadIdx.x;
  const bool with_lo = a.du_lo != nullptr;
  const bool avg = with_lo && a.c.n_cg != 0;

  load_tables(a.c, sm, L);
  const int ntiles = (E + te - 1) / te;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int e_base = tile * te;
    const int ne = min(te, E - e_base);
    const T* s_res = stage_core<T, DIM, DT, QT>(a.c, a.g, sm, L, e_base, ne);
    __syncthreads();
    if (avg) {
      element_sums<T>(te, nd, [&](int j, int e) {
        const int i = e * nd + j;
        return s_ml[i] * (s_u[i] + a.dt * s_res[i]);
      }, s_red);
      element_sums<T>(te, nd, [&](int j, int e) { return s_ml[e * nd + j]; },
                      s_red + te);
      __syncthreads();
    }
    const size_t g0 = (size_t)e_base * nd;
    for (int i = tid; i < ne * nd; i += NT) {
      const T r = s_res[i];
      a.du_ho[g0 + i] = r;
      if (with_lo) {
        const int e = i / nd;
        a.du_lo[g0 + i] =
            avg ? (s_red[e] / s_red[te + e] - s_u[i]) / a.dt : r;
      }
    }
    const size_t w0 = (size_t)e_base * Q;
    for (int i = tid; i < ne * Q; i += NT) a.wdet[w0 + i] = s_w[i];
    __syncthreads();     // the next tile reuses the shared arrays
  }
}

template <typename T, int DIM, int DT, int QT, bool BF16>
int launch_sized(const Args<T, DIM, BF16>& a, size_t smem,
                 cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(
      &stage_ho_kernel<T, DIM, DT, QT, BF16>);
  int grid = 0;
  const int rc = persistent_grid(fn, smem, (a.c.E + a.c.te - 1) / a.c.te,
                                 &grid);
  if (rc != 0) return rc;
  stage_ho_kernel<T, DIM, DT, QT, BF16><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DIM, bool BF16>
int launch_geom(const void* const* p, double t, double dt, const int* sz,
                cudaStream_t stream) {
  Args<T, DIM, BF16> a;
  fill_core_args(a.c, p, sz);
  a.g = poly_geom<T, DIM, BF16>(p, p[N_CORE_PTRS + 3], t, sz);
  a.du_ho = static_cast<T*>(const_cast<void*>(p[N_CORE_PTRS]));
  a.wdet = static_cast<T*>(const_cast<void*>(p[N_CORE_PTRS + 1]));
  a.du_lo = static_cast<T*>(const_cast<void*>(p[N_CORE_PTRS + 2]));
  a.dt = static_cast<T>(dt);
  if (a.c.E <= 0) return 0;
  if (a.c.n_cg < 0) return -4;
  int rc = check_core_sizes(DIM, sz);
  if (rc != 0) return rc;
  a.c.need_ml = a.du_lo != nullptr && a.c.n_cg != 0;
  size_t smem = 0;
  a.c.te = tile_elements(DIM, a.c.D, a.c.Q1, a.c.nf, sizeof(T), 0, &a.L,
                         &smem);
  smem += 2 * a.c.te * sizeof(T);    // s_red
  if (smem > SMEM_MAX) return -3;
  switch (size_case(DIM, a.c.D, a.c.Q1)) {
    case 3: return launch_sized<T, DIM, 3, 3 + (DIM == 3 ? 2 : 1)>(a, smem, stream);
    case 4: return launch_sized<T, DIM, 4, 4 + (DIM == 3 ? 2 : 1)>(a, smem, stream);
    case 5: return launch_sized<T, DIM, 5, 5 + (DIM == 3 ? 2 : 1)>(a, smem, stream);
    default: return launch_sized<T, DIM, 0, 0>(a, smem, stream);
  }
}

// P16 (non-null) picks the bf16 instances, which exist for float only
template <typename T, int DIM>
int launch(const void* const* p, double t, double dt, const int* sz,
           cudaStream_t stream) {
  if (p[N_CORE_PTRS + 3] == nullptr)
    return launch_geom<T, DIM, false>(p, t, dt, sz, stream);
  if constexpr (sizeof(T) == 4)
    return launch_geom<T, DIM, true>(p, t, dt, sz, stream);
  return -6;                                      // P16 is f32 only
}

}  // namespace

extern "C" {

// ptrs: the core's 6 device pointers (u, u_nbr, P, sf, bdr, dof_faces), then
// du_ho, wdet and du_lo (null for no LO output), and P16 (null, or the bf16
// VA | VN planes: then P holds WDET alone; f32 only); sizes: E, nd, Q, Qf,
// nf, fd, n_cg, D, Q1. dt is read only with an LO output. Returns 0, a CUDA
// error code (> 0), or < 0 for a bad argument.
int remhos_stage_ho(int dtype_bytes, int dim, const void* const* ptrs,
                    int nptrs, double t, double dt, const int* sizes,
                    int nsizes, void* stream) {
  if (nptrs != N_CORE_PTRS + 4 || nsizes != N_CORE_SIZES) return -1;
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
