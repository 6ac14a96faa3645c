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
//   6. the class-major bounds stencil [3^dim, E] expanded to dofs by an
//      index lookup (cls), then ClipScale (eps 1e-15) over the element's
//      nd dofs;
//   7. writes only the limited du [E, nd].
//
// What bounds it on the H100: at N=24, p=3, f32, one launch reads about
// 207 MB (P is 191 MB of it: 3456 coefficients per element), ~62 us at
// 3.35 TB/s. The function needs ~25k multiply-adds per element (every
// tensor-product table contraction sum-factorized), ~10 us at ~67 TFLOP/s
// f32: it is bound by bytes. This kernel contracts with the dense tables,
// ~143k multiply-adds per element at 1 Jacobi sweep (~60 us), so as
// written it sits at the ridge. Reading the dense tables is the third
// stream: every block reads ~0.5 MB of tables from L2 for TE elements.
// In f64 (8 sweeps) the bytes double to ~413 MB (~123 us) and still bound.
//
// What this design does about it (a first version: right and simple).
// Steps 1-4 are stage_core() of stage_core.cuh, shared with stage_ho.cu,
// and the element sums of step 5 are its lo_element_sums():
//   - one thread block per tile of TE elements, 256 threads; every
//     per-element vector lives in shared memory as [len][TE]; in each
//     contraction a thread owns one output for a power-of-two group of the
//     tile's elements, keeps their accumulators in registers and reads each
//     table entry once per group;
//   - the static tables are read from global memory (L2/L1 resident:
//     every block shares them);
//   - plain FMA in the working type: no bf16 splitting, no TF32, no tensor
//     cores. The GL<->Bernstein transforms have kappa ~4.3e4 and the LO and
//     lumped-mass sums are conservation-critical; true f32 is at least as
//     accurate as the TPU's bf16x3 products;
//   - P is streamed once, coalesced, inside the pointwise phase;
//   - the face tables stay per face ([Qf, fd]) and are indexed through
//     bdr, which saves ~38k of the dense form's ~181k multiply-adds.
// Making it fast (wgmma/TMA, a tensor-core scheme that keeps f32 accuracy,
// larger element tiles) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "stage_core.cuh"

namespace {

using namespace remhos;

template <typename T>
struct Args {
  CoreArgs<T> c;
  const T* smin;    // [ncls, E] class-major bounds stencil
  const T* smax;
  const int* cls;   // [nd]
  T* du;            // [E, nd] out
  T dt;
};

template <typename T, int DIM>
size_t smem_bytes(int nd, int Q, int Qf, int nf, int fd) {
  constexpr int TE = Tile<T, DIM>::TE;
  const int ncls = DIM == 3 ? 27 : 9;
  const size_t n = core_smem_len(DIM, nd, Q, Qf, nf, fd) + nd + 2 * ncls + 4;
  return n * TE * sizeof(T);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(NT, Tile<T, DIM>::MINB)
mega_stage_kernel(const Args<T> a) {
  constexpr int TE = Tile<T, DIM>::TE;
  constexpr int NCLS = DIM == 3 ? 27 : 9;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int nd = a.c.nd, Q = a.c.Q;
  const CoreSmem<T> s =
      core_smem<T, DIM, TE>(sm, nd, Q, a.c.nf * a.c.Qf, a.c.nf * a.c.fd);
  T* s_ml = s.end;                 // [nd][TE]
  T* s_min = s_ml + nd * TE;       // [NCLS][TE]
  T* s_max = s_min + NCLS * TE;
  T* s_red = s_max + NCLS * TE;    // [4][TE]: mass, vol, sum_neg, sum_pos

  const int tid = threadIdx.x;
  const int e_base = blockIdx.x * TE;
  const int ne = min(TE, a.c.E - e_base);
  const T dt = a.dt;

  // the tile's bounds stencil (the core's first barrier covers it)
  for (int idx = tid; idx < NCLS * TE; idx += NT) {
    const int c = idx / TE, e = idx % TE;
    const size_t g = (size_t)c * a.c.E + e_base + e;
    s_min[idx] = e < ne ? a.smin[g] : T(0);
    s_max[idx] = e < ne ? a.smax[g] : T(0);
  }

  // 1-4. du_HO (stage_core.cuh), and the lumped mass ml = wdet Bu
  T* s_du = stage_core<T, DIM, TE>(a.c, s, e_base, ne);
  contract<T, TE>(s.wdet, Q, a.c.Bu, nd, s_ml);
  __syncthreads();

  // 5. element mass and volume of the HO update, in the ml metric
  lo_element_sums<T, TE>(s.u, s_du, s_ml, dt, nd, s_red);
  __syncthreads();

  // MassBasedAvg LO and the clipped antidiffusive flux (s.ku and s.b are
  // free after the core: they take the flux and du_LO)
  for (int idx = tid; idx < nd * TE; idx += NT) {
    const int j = idx / TE, e = idx % TE;
    const T u = s.u[idx], ml = s_ml[idx];
    const T du_lo = (s_red[e] / s_red[TE + e] - u) / dt;
    const int c = __ldg(a.cls + j);
    const T u_new_lo = u + dt * du_lo;
    const T f_min = ml / dt * (s_min[c * TE + e] - u_new_lo);
    const T f_max = ml / dt * (s_max[c * TE + e] - u_new_lo);
    const T f = ml * (s_du[idx] - du_lo);
    const T f_lo = f_min > f ? f_min : f;          // max(f_min, f)
    s.ku[idx] = f_max < f_lo ? f_max : f_lo;       // min(f_max, .)
    s.b[idx] = du_lo;
  }
  __syncthreads();

  // 6. ClipScale: rescale the flux so that its mass sum is zero
  element_sum<T, TE>(
      nd,
      [&](int j, int e) {
        const T f = s.ku[j * TE + e];
        return f < T(0) ? f : T(0);
      },
      s_red + 2 * TE);
  element_sum<T, TE>(
      nd,
      [&](int j, int e) {
        const T f = s.ku[j * TE + e];
        return f > T(0) ? f : T(0);
      },
      s_red + 3 * TE);
  __syncthreads();
  const T eps = T(1e-15);
  for (int idx = tid; idx < TE * nd; idx += NT) {
    const int e = idx / nd, j = idx % nd;
    if (e >= ne) continue;
    const int sl = j * TE + e;
    const T sum_neg = s_red[2 * TE + e], sum_pos = s_red[3 * TE + e];
    const T new_mass = sum_neg + sum_pos;
    T f = s.ku[sl];
    const T fpos = f > T(0) ? f : T(0), fneg = f < T(0) ? f : T(0);
    if (new_mass > eps) f = fneg - fpos * (sum_neg / sum_pos);
    else if (new_mass < -eps) f = fpos - fneg * (sum_pos / sum_neg);
    a.du[(size_t)(e_base + e) * nd + j] = s.b[sl] + f / s_ml[sl];
  }
}

template <typename T, int DIM>
int launch(const void* const* p, double t, double dt, const int* sz,
           cudaStream_t stream) {
  constexpr int TE = Tile<T, DIM>::TE;
  Args<T> a;
  fill_core_args(a.c, p, t, sz);
  a.smin = static_cast<const T*>(p[N_CORE_PTRS]);
  a.smax = static_cast<const T*>(p[N_CORE_PTRS + 1]);
  a.cls = static_cast<const int*>(p[N_CORE_PTRS + 2]);
  a.du = static_cast<T*>(const_cast<void*>(p[N_CORE_PTRS + 3]));
  a.dt = static_cast<T>(dt);
  if (a.c.E <= 0) return 0;
  if (a.c.n_cg < 1) return -4;   // the limited stage needs the mass inverse
  const size_t smem =
      smem_bytes<T, DIM>(a.c.nd, a.c.Q, a.c.Qf, a.c.nf, a.c.fd);
  if (smem > 227 * 1024) return -3;
  cudaError_t err = cudaFuncSetAttribute(
      mega_stage_kernel<T, DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.c.E + TE - 1) / TE;
  mega_stage_kernel<T, DIM><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: the core's 15 device pointers in CoreArgs order, then smin, smax,
// cls, du; sizes: E, nd, Q, Qf, nf, fd, n_cg. Returns 0, a CUDA error code
// (> 0), or < 0 for a bad argument.
int remhos_mega_stage(int dtype_bytes, int dim, const void* const* ptrs,
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
