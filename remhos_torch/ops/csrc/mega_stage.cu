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
// What this design does about it (a first version: right and simple):
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

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;               // threads per block
constexpr int NWARPS = NT / 32;

// elements per block, by scalar type and dimension (shared memory ~64 KB
// in 3D, ~37 KB in 2D, so several blocks fit on an SM)
template <typename T, int DIM> struct Tile;
template <> struct Tile<float, 3> { static constexpr int TE = 8; };
template <> struct Tile<double, 3> { static constexpr int TE = 4; };
template <> struct Tile<float, 2> { static constexpr int TE = 32; };
template <> struct Tile<double, 2> { static constexpr int TE = 16; };

__device__ __forceinline__ float fmaT(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmaT(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
struct Args {
  const T* u;       // [E, nd]
  const T* unbr;    // [E, nf*fd] face-neighbour dofs, 0 on physical edges
  const T* P;       // [E, width] t-polynomial coefficients
  const T* smin;    // [ncls, E] class-major bounds stencil
  const T* smax;
  const T* GuT;     // [nd, DIM*Q]
  const T* Buw;     // [Q, nd]
  const T* Bface;   // [Qf, fd]
  const T* SBf;     // [Qf, fd] w_fq * Bface
  const T* A;       // [nd, nd] GL -> Bernstein
  const T* AT;      // [nd, nd]
  const T* BglT;    // [nd, Q]
  const T* Bgl;     // [Q, nd]
  const T* Bgl2;    // [Q, nd]
  const T* Bu;      // [Q, nd]
  const int* bdr;        // [nf, fd]
  const int* dof_faces;  // [nd, DIM] face-dof slots of each dof, -1 padded
  const int* cls;        // [nd]
  T* du;            // [E, nd] out
  T t, dt;
  int E, nd, Q, Qf, nf, fd, n_cg;
};

// out[l][e] = sum_k in[k][e] * W[k*L + l] for l < L and the tile's TE
// elements. Each thread owns one output l for EPT consecutive elements,
// keeps their accumulators in registers and reads each W entry once; when
// L < NT, NT/L thread groups split the tile's elements. EPT is a
// compile-time power of two dividing TE, so no multiply-add is predicated
// off, and the k loop is unrolled to keep several table loads in flight.
template <typename T, int TE, int EPT>
__device__ __forceinline__ void contract_ept(const T* __restrict__ in, int K,
                                             const T* __restrict__ W, int L,
                                             T* __restrict__ out) {
  constexpr int G = TE / EPT;
  for (int idx = threadIdx.x; idx < L * G; idx += NT) {
    const int l = idx % L;
    const int e0 = (idx / L) * EPT;
    T acc[EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) acc[i] = T(0);
    const T* col = W + l;
    const T* row = in + e0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const T w = __ldg(col + (size_t)k * L);
#pragma unroll
      for (int i = 0; i < EPT; ++i) acc[i] = fmaT(row[k * TE + i], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < EPT; ++i) out[l * TE + e0 + i] = acc[i];
  }
}

template <typename T, int TE>
__device__ __forceinline__ void contract(const T* __restrict__ in, int K,
                                         const T* __restrict__ W, int L,
                                         T* __restrict__ out) {
  // the smallest power-of-two element count per thread that lets
  // TE/EPT groups of L threads fit in the block
  int ept = 1;
  while (ept < TE && (TE / ept) * L > NT) ept *= 2;
  switch (ept) {
    case 1: if constexpr (TE >= 1) contract_ept<T, TE, 1>(in, K, W, L, out); break;
    case 2: if constexpr (TE >= 2) contract_ept<T, TE, 2>(in, K, W, L, out); break;
    case 4: if constexpr (TE >= 4) contract_ept<T, TE, 4>(in, K, W, L, out); break;
    case 8: if constexpr (TE >= 8) contract_ept<T, TE, 8>(in, K, W, L, out); break;
    case 16: if constexpr (TE >= 16) contract_ept<T, TE, 16>(in, K, W, L, out); break;
    default: if constexpr (TE >= 32) contract_ept<T, TE, 32>(in, K, W, L, out); break;
  }
}

// out[e] = sum_{j < n} f(j, e), one warp per element, fixed order.
template <typename T, int TE, typename F>
__device__ __forceinline__ void element_sum(int n, F f, T* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < TE; e += NWARPS) {
    T s = T(0);
    for (int j = lane; j < n; j += 32) s += f(j, e);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[e] = s;
  }
}

template <typename T, int DIM>
size_t smem_bytes(int nd, int Q, int Qf, int nf, int fd) {
  constexpr int TE = Tile<T, DIM>::TE;
  const int ncls = DIM == 3 ? 27 : 9;
  const size_t n = 7 * nd + 2 * nf * fd + 2 * ncls + DIM * Q + 2 * Q +
                   nf * Qf + 4;
  return n * TE * sizeof(T);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(NT) mega_stage_kernel(const Args<T> a) {
  constexpr int TE = Tile<T, DIM>::TE;
  constexpr int NCLS = DIM == 3 ? 27 : 9;
  constexpr int NKV = DIM, NKD = DIM + 1, NKN = DIM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int nd = a.nd, Q = a.Q, Qf = a.Qf, nf = a.nf, fd = a.fd;
  const int FQ = nf * Qf, NFD = nf * fd;
  const int off_wd = NKV * DIM * Q, off_vn = off_wd + NKD * Q;
  const int width = off_vn + NKN * FQ;

  // shared layout, every array [len][TE]
  T* s_u = sm;
  T* s_un = s_u + nd * TE;
  T* s_min = s_un + NFD * TE;
  T* s_max = s_min + NCLS * TE;
  T* s_grad = s_max + NCLS * TE;   // DIM*Q; later the GL point values
  T* s_duq = s_grad + DIM * Q * TE;
  T* s_wdet = s_duq + Q * TE;
  T* s_flux = s_wdet + Q * TE;
  T* s_cf = s_flux + FQ * TE;
  T* s_ku = s_cf + NFD * TE;       // Ku; later M_gl x; later the flux f
  T* s_b = s_ku + nd * TE;
  T* s_inv = s_b + nd * TE;
  T* s_x = s_inv + nd * TE;
  T* s_du = s_x + nd * TE;         // du_HO
  T* s_ml = s_du + nd * TE;
  T* s_red = s_ml + nd * TE;       // [4][TE]: mass, vol, sum_neg, sum_pos

  const int tid = threadIdx.x;
  const int e_base = blockIdx.x * TE;
  const int ne = min(TE, a.E - e_base);
  const T t = a.t, dt = a.dt;

  // 0. the tile's u, u_nbr and bounds stencil
  for (int idx = tid; idx < TE * nd; idx += NT) {
    const int e = idx / nd, j = idx % nd;
    s_u[j * TE + e] = e < ne ? a.u[(size_t)(e_base + e) * nd + j] : T(0);
  }
  for (int idx = tid; idx < TE * NFD; idx += NT) {
    const int e = idx / NFD, j = idx % NFD;
    s_un[j * TE + e] = e < ne ? a.unbr[(size_t)(e_base + e) * NFD + j] : T(0);
  }
  for (int idx = tid; idx < NCLS * TE; idx += NT) {
    const int c = idx / TE, e = idx % TE;
    const size_t g = (size_t)c * a.E + e_base + e;
    s_min[idx] = e < ne ? a.smin[g] : T(0);
    s_max[idx] = e < ne ? a.smax[g] : T(0);
  }
  __syncthreads();

  // 1. reference gradients of u at the volume points
  contract<T, TE>(s_u, nd, a.GuT, DIM * Q, s_grad);
  __syncthreads();

  // 2. pointwise: Horner for va, wdet, vn; volume integrand; face flux
  const int QQ = Q > FQ ? Q : FQ;
  for (int idx = tid; idx < TE * QQ; idx += NT) {
    const int e = idx / QQ, q = idx % QQ;
    if (e >= ne) {
      if (q < Q) { s_duq[q * TE + e] = T(0); s_wdet[q * TE + e] = T(1); }
      if (q < FQ) s_flux[q * TE + e] = T(0);
      continue;
    }
    const T* Pe = a.P + (size_t)(e_base + e) * width;
    if (q < Q) {
      T duq = T(0);
#pragma unroll
      for (int b = 0; b < DIM; ++b) {
        T va = Pe[((NKV - 1) * DIM + b) * Q + q];
#pragma unroll
        for (int k = NKV - 2; k >= 0; --k) va = Pe[(k * DIM + b) * Q + q] + t * va;
        const T g = s_grad[(b * Q + q) * TE + e];
        duq = b == 0 ? va * g : duq + va * g;
      }
      s_duq[q * TE + e] = duq;
      T wd = Pe[off_wd + (NKD - 1) * Q + q];
#pragma unroll
      for (int k = NKD - 2; k >= 0; --k) wd = Pe[off_wd + k * Q + q] + t * wd;
      s_wdet[q * TE + e] = wd;
    }
    if (q < FQ) {
      T vn = Pe[off_vn + (NKN - 1) * FQ + q];
#pragma unroll
      for (int k = NKN - 2; k >= 0; --k) vn = Pe[off_vn + k * FQ + q] + t * vn;
      const T up = vn > T(0) ? vn : T(0);
      const int f = q / Qf, qq = q % Qf;
      T un = T(0), uo = T(0);
#pragma unroll 4
      for (int i = 0; i < fd; ++i) {
        const T bf = __ldg(a.Bface + qq * fd + i);
        un = fmaT(s_un[(f * fd + i) * TE + e], bf, un);
        uo = fmaT(s_u[__ldg(a.bdr + f * fd + i) * TE + e], bf, uo);
      }
      s_flux[q * TE + e] = up * (un - uo);
    }
  }
  __syncthreads();

  // 3. Ku: volume part, and the face contributions per face dof
  contract<T, TE>(s_duq, Q, a.Buw, nd, s_ku);
  for (int idx = tid; idx < NFD * TE; idx += NT) {
    const int s = idx / TE, e = idx % TE;
    const int f = s / fd, i = s % fd;
    T acc = T(0);
#pragma unroll 4
    for (int qq = 0; qq < Qf; ++qq)
      acc = fmaT(__ldg(a.SBf + qq * fd + i), s_flux[(f * Qf + qq) * TE + e],
                 acc);
    s_cf[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < nd * TE; idx += NT) {
    const int j = idx / TE, e = idx % TE;
    T acc = s_ku[idx];
#pragma unroll
    for (int m = 0; m < DIM; ++m) {
      const int s = __ldg(a.dof_faces + j * DIM + m);
      if (s >= 0) acc += s_cf[s * TE + e];
    }
    s_ku[idx] = acc;
  }
  __syncthreads();

  // 4. b = Ku A and the Jacobi diagonal of the GL mass matrix
  contract<T, TE>(s_ku, nd, a.A, nd, s_b);
  contract<T, TE>(s_wdet, Q, a.Bgl2, nd, s_inv);
  __syncthreads();
  for (int idx = tid; idx < nd * TE; idx += NT) {
    const T inv = T(1) / s_inv[idx];
    s_inv[idx] = inv;
    s_x[idx] = inv * s_b[idx];
  }
  __syncthreads();

  // 5. Jacobi sweeps x += D^-1 (b - M_gl x), M_gl x = Bgl^T (wdet (Bgl x))
  for (int it = 0; it < a.n_cg; ++it) {
    contract<T, TE>(s_x, nd, a.BglT, Q, s_grad);
    __syncthreads();
    for (int idx = tid; idx < Q * TE; idx += NT) s_grad[idx] *= s_wdet[idx];
    __syncthreads();
    contract<T, TE>(s_grad, Q, a.Bgl, nd, s_ku);
    __syncthreads();
    for (int idx = tid; idx < nd * TE; idx += NT)
      s_x[idx] = s_x[idx] + s_inv[idx] * (s_b[idx] - s_ku[idx]);
    __syncthreads();
  }

  // 6. du_HO = x A^T and the lumped mass ml = wdet Bu
  contract<T, TE>(s_x, nd, a.AT, nd, s_du);
  contract<T, TE>(s_wdet, Q, a.Bu, nd, s_ml);
  __syncthreads();

  // 7. element mass and volume of the HO update, in the ml metric
  element_sum<T, TE>(
      nd,
      [&](int j, int e) {
        return s_ml[j * TE + e] * (s_u[j * TE + e] + dt * s_du[j * TE + e]);
      },
      s_red);
  element_sum<T, TE>(nd, [&](int j, int e) { return s_ml[j * TE + e]; },
                     s_red + TE);
  __syncthreads();

  // 8. MassBasedAvg LO and the clipped antidiffusive flux
  for (int idx = tid; idx < nd * TE; idx += NT) {
    const int j = idx / TE, e = idx % TE;
    const T u = s_u[idx], ml = s_ml[idx];
    const T du_lo = (s_red[e] / s_red[TE + e] - u) / dt;
    const int c = __ldg(a.cls + j);
    const T u_new_lo = u + dt * du_lo;
    const T f_min = ml / dt * (s_min[c * TE + e] - u_new_lo);
    const T f_max = ml / dt * (s_max[c * TE + e] - u_new_lo);
    const T f = ml * (s_du[idx] - du_lo);
    const T f_lo = f_min > f ? f_min : f;          // max(f_min, f)
    s_ku[idx] = f_max < f_lo ? f_max : f_lo;       // min(f_max, .)
    s_b[idx] = du_lo;
  }
  __syncthreads();

  // 9. ClipScale: rescale the flux so that its mass sum is zero
  element_sum<T, TE>(
      nd,
      [&](int j, int e) {
        const T f = s_ku[j * TE + e];
        return f < T(0) ? f : T(0);
      },
      s_red + 2 * TE);
  element_sum<T, TE>(
      nd,
      [&](int j, int e) {
        const T f = s_ku[j * TE + e];
        return f > T(0) ? f : T(0);
      },
      s_red + 3 * TE);
  __syncthreads();
  const T eps = T(1e-15);
  for (int idx = tid; idx < TE * nd; idx += NT) {
    const int e = idx / nd, j = idx % nd;
    if (e >= ne) continue;
    const int s = j * TE + e;
    const T sum_neg = s_red[2 * TE + e], sum_pos = s_red[3 * TE + e];
    const T new_mass = sum_neg + sum_pos;
    T f = s_ku[s];
    const T fpos = f > T(0) ? f : T(0), fneg = f < T(0) ? f : T(0);
    if (new_mass > eps) f = fneg - fpos * (sum_neg / sum_pos);
    else if (new_mass < -eps) f = fpos - fneg * (sum_pos / sum_neg);
    a.du[(size_t)(e_base + e) * nd + j] = s_b[s] + f / s_ml[s];
  }
}

template <typename T, int DIM>
int launch(const void* const* p, double t, double dt, const int* sz,
           cudaStream_t stream) {
  constexpr int TE = Tile<T, DIM>::TE;
  Args<T> a;
  a.u = static_cast<const T*>(p[0]);
  a.unbr = static_cast<const T*>(p[1]);
  a.P = static_cast<const T*>(p[2]);
  a.smin = static_cast<const T*>(p[3]);
  a.smax = static_cast<const T*>(p[4]);
  a.GuT = static_cast<const T*>(p[5]);
  a.Buw = static_cast<const T*>(p[6]);
  a.Bface = static_cast<const T*>(p[7]);
  a.SBf = static_cast<const T*>(p[8]);
  a.A = static_cast<const T*>(p[9]);
  a.AT = static_cast<const T*>(p[10]);
  a.BglT = static_cast<const T*>(p[11]);
  a.Bgl = static_cast<const T*>(p[12]);
  a.Bgl2 = static_cast<const T*>(p[13]);
  a.Bu = static_cast<const T*>(p[14]);
  a.bdr = static_cast<const int*>(p[15]);
  a.dof_faces = static_cast<const int*>(p[16]);
  a.cls = static_cast<const int*>(p[17]);
  a.du = static_cast<T*>(const_cast<void*>(p[18]));
  a.t = static_cast<T>(t);
  a.dt = static_cast<T>(dt);
  a.E = sz[0]; a.nd = sz[1]; a.Q = sz[2]; a.Qf = sz[3]; a.nf = sz[4];
  a.fd = sz[5]; a.n_cg = sz[6];
  if (a.E <= 0) return 0;
  const size_t smem = smem_bytes<T, DIM>(a.nd, a.Q, a.Qf, a.nf, a.fd);
  if (smem > 227 * 1024) return -3;
  cudaError_t err = cudaFuncSetAttribute(
      mega_stage_kernel<T, DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.E + TE - 1) / TE;
  mega_stage_kernel<T, DIM><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: the 19 device pointers in Args order; sizes: E, nd, Q, Qf, nf, fd,
// n_cg. Returns 0, a CUDA error code (> 0), or < 0 for a bad argument.
int remhos_mega_stage(int dtype_bytes, int dim, const void* const* ptrs,
                      int nptrs, double t, double dt, const int* sizes,
                      int nsizes, void* stream) {
  if (nptrs != 19 || nsizes != 7) return -1;
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
