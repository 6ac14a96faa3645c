// The limited remap stage (-ho 3 -lo 5 -fct 2 -pa) in one CUDA kernel.
//
// Replaces: fused_stage_mega_poly / _stage_mega_kernel in
//   remhos_tpu/ops/pallas_kernels.py (:889 / :731), with its cores
//   _poly_stage_core (:578) and _mass_based_avg_core (:683).
//
// What it computes, per element (nd dofs, Q volume and FQ = nf*Qf face
// quadrature points):
//   1. va_b, w_q det J and the face normal velocity vn by Horner's rule from
//      the t-polynomial coefficients P = [VA | WDET | VN] (ops/tables.py);
//   2. the volume convection sum_q Buw[q, j] sum_b va_b[q] grad_b u[q];
//   3. the DG upwind face flux max(0, vn) (u_nbr - u_own) at the face
//      points, scattered back to the face dofs;
//   4. the GL mass inverse: b = Ku A, x = D^-1 b, then n_cg Jacobi sweeps
//      x += D^-1 (b - M_gl x), du_HO = x A^T (1 sweep in f32, 8 in f64);
//   5. MassBasedAvg LO and the lumped mass ml = wdet Bu. The element
//      average uses sum_j ml_j (u + dt du_HO)_j / sum_j ml_j, which equals
//      the reference's sum_q wdet_q (Bu (u + dt du_HO))_q exactly in real
//      arithmetic (ml = wdet Bu, and Bernstein is a partition of unity);
//   6. the bounds, then ClipScale (eps 1e-15) over the element's nd dofs.
//      Three layouts (Layout below), one C entry each:
//      - remhos_mega_stage: the class-major overlap stencil [3^dim, E] of
//        `-bt 0` on an unsharded structured mesh (the JAX kernel's
//        bounds_stencil="T"), staged per tile in shared memory and
//        expanded to dofs by an index lookup (cls);
//      - remhos_mega_stage_elem: the element-major stencil [E, 3^dim] of a
//        sharded structured mesh (bounds_stencil=True): the tile's
//        te x 3^dim values are one contiguous run, read coalesced into the
//        same shared slots s_min/s_max[e * NCLS + c] that the class-major
//        layout fills, so the ClipScale step is the same code and, on the
//        same stencil values, the same bits;
//      - remhos_mega_stage_dof: per-dof bounds [E, nd] (`-bt 1`, a general
//        mesh; bounds_stencil=False), read straight from global memory in
//        the ClipScale step, coalesced along the dofs; no staging, no cls.
//      The two stencil layouts share one compiled instance (the staging
//      loop is chosen per launch); the per-dof layout, which stages
//      nothing, is an instance of its own; with P16 (f32) both are
//      compiled once more on the bf16 geometry provider;
//   7. writes only the limited du [E, nd].
//
// What bounds it on the H100: at N=24, p=3, f32, one launch reads about
// 207 MB (P is 191 MB of it: 3456 coefficients per element), ~62 us at
// 3.35 TB/s. The function needs ~25k multiply-adds per element with every
// tensor-product contraction sum-factorized, ~10 us at ~67 TFLOP/s f32: it
// is bound by bytes. In f64 (8 sweeps) the bytes double to ~413 MB (~123
// us) and still bound. The per-dof variant reads 2 nd values per element
// for the bounds instead of 2 * 3^dim: +4.1 MB in f32 (+8.2 MB in f64) at
// N=24, p=3, ~2% more bytes. With P16 (f32 only) the VA | VN planes, 6 of
// P's 16 coefficient planes per point in 3D (9 VA + 3 VN of 3456
// coefficients: 2592), are read as bf16: P's stream drops from 191 MB to
// ~119 MB at N=24, p=3.
//
// The first version contracted with the dense tables (~143k multiply-adds
// per element, one shared-memory load each, ~0.5 MB of tables from L2 per
// block of 8 elements) and took 12x the byte bound. Steps 1-4 are now
// stage_core() of stage_core.cuh, sum-factorized, shared with stage_ho.cu
// and stage_ho_nodes.cu (its head comment has the design); the element sums
// of step 5 and ClipScale are per-element reductions, one warp per element
// in a fixed order. The blocks are persistent and walk over tiles of te
// elements; the 1D tables are staged once per block.
//   - plain FMA in the working type: no bf16 splitting, no TF32, no tensor
//     cores. The GL<->Bernstein transforms have kappa ~4.3e4 and the LO and
//     lumped-mass sums are conservation-critical; true f32 is at least as
//     accurate as the TPU's bf16x3 products;
//   - P is streamed once, coalesced, inside the pointwise passes;
//   - the face tables are the 1D trace tables, and face dofs are reached
//     through bdr and dof_faces.
// What still bounds it and what stays for later (overlapping the P stream
// with the contractions, TMA multicast, wgmma-based f32 schemes, folding
// the neighbour gather into the element window): stage_core.cuh's head.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "stage_core.cuh"

namespace {

using namespace remhos;

// the bounds operand's layout
enum Layout { CLASS_MAJOR = 0, ELEMENT_MAJOR = 1, PER_DOF = 2 };

template <typename T, int DIM, bool BF16>
struct Args {
  CoreArgs<T> c;
  PolyGeom<T, DIM, BF16> g;
  CoreLayout L;
  const T* smin;    // [ncls, E] class-major or [E, ncls] element-major
  const T* smax;    // stencil, or [E, nd] per dof
  const int* cls;   // [nd] (the stencil layouts only)
  T* du;            // [E, nd] out
  T dt;
  int layout;       // Layout
};

// shared values per element beyond the core's: the staged stencil
template <int DIM, bool DOF>
__host__ __device__ constexpr int stencil_slots() {
  return DOF ? 0 : 2 * (DIM == 3 ? 27 : 9);
}

template <typename T, int DIM, int DT, int QT, bool DOF, bool BF16>
__global__ void __launch_bounds__(NT, min_blocks<T>())
mega_stage_kernel(const __grid_constant__ Args<T, DIM, BF16> a) {
  constexpr int NCLS = DIM == 3 ? 27 : 9;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const CoreLayout& L = a.L;
  const int te = a.c.te, nd = a.c.nd, E = a.c.E;
  T* s_min = sm + L.end;           // [te][NCLS] (stencil layout)
  T* s_max = s_min + (DOF ? 0 : te * NCLS);
  T* s_red = sm + L.end + te * stencil_slots<DIM, DOF>();  // [4][te]:
                                   // mass, vol, sum_neg, sum_pos
  const T* s_u = sm + L.u;
  const T* s_ml = sm + L.ml;
  T* s_f = sm + L.b;               // free after the core: the flux
  T* s_lo = sm + L.x;              // and du_LO
  const int tid = threadIdx.x;
  const T dt = a.dt;

  load_tables(a.c, sm, L);
  const int ntiles = (E + te - 1) / te;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int e_base = tile * te;
    const int ne = min(te, E - e_base);

    // the tile's bounds stencil (the core's first barrier covers it)
    if constexpr (!DOF) {
      if (a.layout == ELEMENT_MAJOR) {
        // the tile's rows are one contiguous run of ne * NCLS values
        const size_t g0 = (size_t)e_base * NCLS;
        for (int idx = tid; idx < NCLS * te; idx += NT) {
          const bool in = idx < ne * NCLS;
          s_min[idx] = in ? a.smin[g0 + idx] : T(0);
          s_max[idx] = in ? a.smax[g0 + idx] : T(0);
        }
      } else {
        for (int idx = tid; idx < NCLS * te; idx += NT) {
          const int c = idx / te, e = idx - c * te;
          const size_t g = (size_t)c * E + e_base + e;
          s_min[e * NCLS + c] = e < ne ? a.smin[g] : T(0);
          s_max[e * NCLS + c] = e < ne ? a.smax[g] : T(0);
        }
      }
    }

    // 1-4. du_HO and ml = wdet Bu (stage_core.cuh)
    const T* s_du = stage_core<T, DIM, DT, QT>(a.c, a.g, sm, L, e_base, ne);
    __syncthreads();

    // 5. element mass and volume of the HO update, in the ml metric
    element_sums<T>(te, nd, [&](int j, int e) {
      const int i = e * nd + j;
      return s_ml[i] * (s_u[i] + dt * s_du[i]);
    }, s_red);
    element_sums<T>(te, nd, [&](int j, int e) { return s_ml[e * nd + j]; },
                    s_red + te);
    __syncthreads();

    // MassBasedAvg LO and the clipped antidiffusive flux
    const size_t g0 = (size_t)e_base * nd;
    for (int i = tid; i < te * nd; i += NT) {
      const int e = i / nd, j = i - e * nd;
      const T u = s_u[i], ml = s_ml[i];
      const T du_lo = (s_red[e] / s_red[te + e] - u) / dt;
      T x_min, x_max;
      if constexpr (DOF) {
        // the tile's dofs are contiguous in [E, nd]: coalesced reads
        x_min = e < ne ? __ldg(a.smin + g0 + i) : T(0);
        x_max = e < ne ? __ldg(a.smax + g0 + i) : T(0);
      } else {
        const int c = __ldg(a.cls + j);
        x_min = s_min[e * NCLS + c];
        x_max = s_max[e * NCLS + c];
      }
      const T u_new_lo = u + dt * du_lo;
      const T f_min = ml / dt * (x_min - u_new_lo);
      const T f_max = ml / dt * (x_max - u_new_lo);
      const T f = ml * (s_du[i] - du_lo);
      const T f_lo = f_min > f ? f_min : f;          // max(f_min, f)
      s_f[i] = f_max < f_lo ? f_max : f_lo;          // min(f_max, .)
      s_lo[i] = du_lo;
    }
    __syncthreads();

    // 6. ClipScale: rescale the flux so that its mass sum is zero
    element_sums<T>(te, nd, [&](int j, int e) {
      const T f = s_f[e * nd + j];
      return f < T(0) ? f : T(0);
    }, s_red + 2 * te);
    element_sums<T>(te, nd, [&](int j, int e) {
      const T f = s_f[e * nd + j];
      return f > T(0) ? f : T(0);
    }, s_red + 3 * te);
    __syncthreads();
    const T eps = T(1e-15);
    T* out = a.du + (size_t)e_base * nd;
    for (int i = tid; i < ne * nd; i += NT) {
      const int e = i / nd;
      const T sum_neg = s_red[2 * te + e], sum_pos = s_red[3 * te + e];
      const T new_mass = sum_neg + sum_pos;
      T f = s_f[i];
      const T fpos = f > T(0) ? f : T(0), fneg = f < T(0) ? f : T(0);
      if (new_mass > eps) f = fneg - fpos * (sum_neg / sum_pos);
      else if (new_mass < -eps) f = fpos - fneg * (sum_pos / sum_neg);
      out[i] = s_lo[i] + f / s_ml[i];
    }
    __syncthreads();     // the next tile reuses the shared arrays
  }
}

template <typename T, int DIM, int DT, int QT, bool DOF, bool BF16>
int launch_sized(const Args<T, DIM, BF16>& a, size_t smem,
                 cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(
      &mega_stage_kernel<T, DIM, DT, QT, DOF, BF16>);
  int grid = 0;
  const int rc = persistent_grid(fn, smem, (a.c.E + a.c.te - 1) / a.c.te,
                                 &grid);
  if (rc != 0) return rc;
  mega_stage_kernel<T, DIM, DT, QT, DOF, BF16><<<grid, NT, smem, stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T, int DIM, bool DOF, bool BF16>
int launch_geom(const void* const* p, double t, double dt, const int* sz,
                int layout, cudaStream_t stream) {
  Args<T, DIM, BF16> a;
  fill_core_args(a.c, p, sz);
  a.g = poly_geom<T, DIM, BF16>(p, p[N_CORE_PTRS + 4], t, sz);
  a.smin = static_cast<const T*>(p[N_CORE_PTRS]);
  a.smax = static_cast<const T*>(p[N_CORE_PTRS + 1]);
  a.cls = static_cast<const int*>(p[N_CORE_PTRS + 2]);
  a.du = static_cast<T*>(const_cast<void*>(p[N_CORE_PTRS + 3]));
  a.dt = static_cast<T>(dt);
  a.layout = layout;
  if (a.c.E <= 0) return 0;
  if (a.c.n_cg < 1) return -4;   // the limited stage needs the mass inverse
  int rc = check_core_sizes(DIM, sz);
  if (rc != 0) return rc;
  a.c.need_ml = 1;
  size_t smem = 0;
  a.c.te = tile_elements(DIM, a.c.D, a.c.Q1, a.c.nf, sizeof(T),
                         stencil_slots<DIM, DOF>(), &a.L, &smem);
  smem += 4 * a.c.te * sizeof(T);    // s_red
  if (smem > SMEM_MAX) return -3;
  constexpr int QX = DIM == 3 ? 2 : 1;
  switch (size_case(DIM, a.c.D, a.c.Q1)) {
    case 3: return launch_sized<T, DIM, 3, 3 + QX, DOF>(a, smem, stream);
    case 4: return launch_sized<T, DIM, 4, 4 + QX, DOF>(a, smem, stream);
    case 5: return launch_sized<T, DIM, 5, 5 + QX, DOF>(a, smem, stream);
    default: return launch_sized<T, DIM, 0, 0, DOF>(a, smem, stream);
  }
}

// P16 (non-null) picks the bf16 instances, which exist for float only
template <typename T, int DIM, bool DOF>
int launch(const void* const* p, double t, double dt, const int* sz,
           int layout, cudaStream_t stream) {
  if (p[N_CORE_PTRS + 4] == nullptr)
    return launch_geom<T, DIM, DOF, false>(p, t, dt, sz, layout, stream);
  if constexpr (sizeof(T) == 4)
    return launch_geom<T, DIM, DOF, true>(p, t, dt, sz, layout, stream);
  return -6;                                      // P16 is f32 only
}

template <int LAYOUT>
int entry(int dtype_bytes, int dim, const void* const* ptrs, int nptrs,
          double t, double dt, const int* sizes, int nsizes, void* stream) {
  constexpr bool DOF = LAYOUT == PER_DOF;
  if (nptrs != N_CORE_PTRS + 5 || nsizes != N_CORE_SIZES) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4 && dim == 3) return launch<float, 3, DOF>(ptrs, t, dt, sizes, LAYOUT, s);
  if (dtype_bytes == 8 && dim == 3) return launch<double, 3, DOF>(ptrs, t, dt, sizes, LAYOUT, s);
  if (dtype_bytes == 4 && dim == 2) return launch<float, 2, DOF>(ptrs, t, dt, sizes, LAYOUT, s);
  if (dtype_bytes == 8 && dim == 2) return launch<double, 2, DOF>(ptrs, t, dt, sizes, LAYOUT, s);
  return -2;
}

}  // namespace

extern "C" {

// ptrs: the core's 6 device pointers (u, u_nbr, P, sf, bdr, dof_faces), then
// smin, smax, cls, du, P16 (null, or the bf16 VA | VN planes: then P holds
// WDET alone; f32 only); sizes: E, nd, Q, Qf, nf, fd, n_cg, D, Q1. Returns
// 0, a CUDA error code (> 0), or < 0 for a bad argument.
// smin/smax: the class-major stencil [3^dim, E], cls its dof classes [nd].
int remhos_mega_stage(int dtype_bytes, int dim, const void* const* ptrs,
                      int nptrs, double t, double dt, const int* sizes,
                      int nsizes, void* stream) {
  return entry<CLASS_MAJOR>(dtype_bytes, dim, ptrs, nptrs, t, dt, sizes,
                            nsizes, stream);
}

// The same with the element-major stencil smin/smax [E, 3^dim].
int remhos_mega_stage_elem(int dtype_bytes, int dim, const void* const* ptrs,
                           int nptrs, double t, double dt, const int* sizes,
                           int nsizes, void* stream) {
  return entry<ELEMENT_MAJOR>(dtype_bytes, dim, ptrs, nptrs, t, dt, sizes,
                              nsizes, stream);
}

// The same with per-dof bounds smin/smax [E, nd], contiguous; cls unread.
int remhos_mega_stage_dof(int dtype_bytes, int dim, const void* const* ptrs,
                          int nptrs, double t, double dt, const int* sizes,
                          int nsizes, void* stream) {
  return entry<PER_DOF>(dtype_bytes, dim, ptrs, nptrs, t, dt, sizes, nsizes,
                        stream);
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
