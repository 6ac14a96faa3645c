// The shared core of the polynomial-geometry remap stage kernels.
//
// Counterpart of _poly_stage_core and _mass_based_avg_core in
// remhos_tpu/ops/pallas_kernels.py (:578, :683), which _stage_ho_poly_kernel
// and _stage_mega_kernel share there; here stage_ho.cu and mega_stage.cu
// share stage_core() and lo_element_sums().
//
// stage_core computes, for one tile of TE elements held in shared memory
// (nd dofs, Q volume and FQ = nf*Qf face quadrature points per element):
//   0. loads the tile's u and u_nbr;
//   1. reference gradients of u at the volume points;
//   2. va_b, w_q det J and the face normal velocity vn by Horner's rule from
//      the t-polynomial coefficients P = [VA | WDET | VN] (ops/tables.py),
//      the volume integrand and the DG upwind face flux
//      max(0, vn) (u_nbr - u_own);
//   3. Ku: the volume part, plus the face flux scattered to the face dofs;
//   4. b = Ku A and the Jacobi diagonal of the GL mass matrix;
//   5. n_cg Jacobi sweeps x += D^-1 (b - M_gl x);
//   6. du_HO = x A^T.
// With n_cg == 0 it stops after step 3 and returns Ku.
//
// Design (a first version: right and simple): one thread block of NT threads
// per tile; every per-element vector lives in shared memory as [len][TE]; in
// each contraction a thread owns one output for a power-of-two group of the
// tile's elements, keeps their accumulators in registers and reads each table
// entry once per group. The static tables are read from global memory (L2/L1
// resident: every block shares them). Plain FMA in the working type: no bf16
// splitting, no TF32, no tensor cores. P is streamed once, coalesced, inside
// the pointwise phase. The face tables stay per face ([Qf, fd]) and are
// indexed through bdr.

#pragma once

#include <cuda_runtime.h>

namespace remhos {

constexpr int NT = 256;               // threads per block
constexpr int NWARPS = NT / 32;

// elements per block, by scalar type and dimension (shared memory ~64 KB
// in 3D, ~37 KB in 2D, so several blocks fit on an SM), and the blocks per
// SM the kernels ask the compiler to leave registers for: in 3D the three
// that the shared memory admits (at most 85 registers a thread)
template <typename T, int DIM> struct Tile;
template <> struct Tile<float, 3> { static constexpr int TE = 8, MINB = 3; };
template <> struct Tile<double, 3> { static constexpr int TE = 4, MINB = 3; };
template <> struct Tile<float, 2> { static constexpr int TE = 32, MINB = 1; };
template <> struct Tile<double, 2> { static constexpr int TE = 16, MINB = 1; };

__device__ __forceinline__ float fmaT(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmaT(double a, double b, double c) {
  return fma(a, b, c);
}

// What the core reads: the stage's operands and the static tables.
template <typename T>
struct CoreArgs {
  const T* u;       // [E, nd]
  const T* unbr;    // [E, nf*fd] face-neighbour dofs, 0 on physical edges
  const T* P;       // [E, width] t-polynomial coefficients
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
  T t;
  int E, nd, Q, Qf, nf, fd, n_cg;
};

// The core's shared-memory arrays, every one [len][TE].
template <typename T>
struct CoreSmem {
  T* u;      // nd
  T* un;     // nf*fd
  T* grad;   // DIM*Q; later the GL point values
  T* duq;    // Q
  T* wdet;   // Q
  T* flux;   // nf*Qf
  T* cf;     // nf*fd
  T* ku;     // nd: Ku; later M_gl x (free for the caller after the core)
  T* b;      // nd (free for the caller after the core)
  T* inv;    // nd
  T* x;      // nd
  T* du;     // nd: du_HO
  T* end;    // first entry after the core's arrays
};

// Entries (per element of the tile) the core's arrays take.
inline size_t core_smem_len(int dim, int nd, int Q, int Qf, int nf, int fd) {
  return 6 * (size_t)nd + 2 * (size_t)nf * fd + (size_t)dim * Q + 2 * (size_t)Q +
         (size_t)nf * Qf;
}

template <typename T, int DIM, int TE>
__device__ __forceinline__ CoreSmem<T> core_smem(T* sm, int nd, int Q, int FQ,
                                                 int NFD) {
  CoreSmem<T> s;
  s.u = sm;
  s.un = s.u + nd * TE;
  s.grad = s.un + NFD * TE;
  s.duq = s.grad + DIM * Q * TE;
  s.wdet = s.duq + Q * TE;
  s.flux = s.wdet + Q * TE;
  s.cf = s.flux + FQ * TE;
  s.ku = s.cf + NFD * TE;
  s.b = s.ku + nd * TE;
  s.inv = s.b + nd * TE;
  s.x = s.inv + nd * TE;
  s.du = s.x + nd * TE;
  s.end = s.du + nd * TE;
  return s;
}

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

// Steps 0-6 above for the tile of ne <= TE elements starting at e_base.
// Returns the shared array [nd][TE] that holds the result: s.du (du_HO), or
// s.ku (Ku) when n_cg == 0. The last contraction is NOT followed by a
// barrier: the caller calls __syncthreads() before it reads the result (it
// may put further contractions of s.wdet before that barrier). Rows e >= ne
// of the tile hold u = 0 and wdet = 1, so every later division is finite.
template <typename T, int DIM, int TE>
__device__ __forceinline__ T* stage_core(const CoreArgs<T>& a,
                                         const CoreSmem<T>& s, int e_base,
                                         int ne) {
  constexpr int NKV = DIM, NKD = DIM + 1, NKN = DIM;
  const int nd = a.nd, Q = a.Q, Qf = a.Qf, nf = a.nf, fd = a.fd;
  const int FQ = nf * Qf, NFD = nf * fd;
  const int off_wd = NKV * DIM * Q, off_vn = off_wd + NKD * Q;
  const int width = off_vn + NKN * FQ;
  const int tid = threadIdx.x;
  const T t = a.t;

  // 0. the tile's u and u_nbr
  for (int idx = tid; idx < TE * nd; idx += NT) {
    const int e = idx / nd, j = idx % nd;
    s.u[j * TE + e] = e < ne ? a.u[(size_t)(e_base + e) * nd + j] : T(0);
  }
  for (int idx = tid; idx < TE * NFD; idx += NT) {
    const int e = idx / NFD, j = idx % NFD;
    s.un[j * TE + e] = e < ne ? a.unbr[(size_t)(e_base + e) * NFD + j] : T(0);
  }
  __syncthreads();

  // 1. reference gradients of u at the volume points
  contract<T, TE>(s.u, nd, a.GuT, DIM * Q, s.grad);
  __syncthreads();

  // 2. pointwise: Horner for va, wdet, vn; volume integrand; face flux
  const int QQ = Q > FQ ? Q : FQ;
  for (int idx = tid; idx < TE * QQ; idx += NT) {
    const int e = idx / QQ, q = idx % QQ;
    if (e >= ne) {
      if (q < Q) { s.duq[q * TE + e] = T(0); s.wdet[q * TE + e] = T(1); }
      if (q < FQ) s.flux[q * TE + e] = T(0);
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
        const T g = s.grad[(b * Q + q) * TE + e];
        duq = b == 0 ? va * g : duq + va * g;
      }
      s.duq[q * TE + e] = duq;
      T wd = Pe[off_wd + (NKD - 1) * Q + q];
#pragma unroll
      for (int k = NKD - 2; k >= 0; --k) wd = Pe[off_wd + k * Q + q] + t * wd;
      s.wdet[q * TE + e] = wd;
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
        un = fmaT(s.un[(f * fd + i) * TE + e], bf, un);
        uo = fmaT(s.u[__ldg(a.bdr + f * fd + i) * TE + e], bf, uo);
      }
      s.flux[q * TE + e] = up * (un - uo);
    }
  }
  __syncthreads();

  // 3. Ku: volume part, and the face contributions per face dof
  contract<T, TE>(s.duq, Q, a.Buw, nd, s.ku);
  for (int idx = tid; idx < NFD * TE; idx += NT) {
    const int sl = idx / TE, e = idx % TE;
    const int f = sl / fd, i = sl % fd;
    T acc = T(0);
#pragma unroll 4
    for (int qq = 0; qq < Qf; ++qq)
      acc = fmaT(__ldg(a.SBf + qq * fd + i), s.flux[(f * Qf + qq) * TE + e],
                 acc);
    s.cf[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < nd * TE; idx += NT) {
    const int j = idx / TE, e = idx % TE;
    T acc = s.ku[idx];
#pragma unroll
    for (int m = 0; m < DIM; ++m) {
      const int sl = __ldg(a.dof_faces + j * DIM + m);
      if (sl >= 0) acc += s.cf[sl * TE + e];
    }
    s.ku[idx] = acc;
  }
  __syncthreads();
  if (a.n_cg == 0) return s.ku;

  // 4. b = Ku A and the Jacobi diagonal of the GL mass matrix
  contract<T, TE>(s.ku, nd, a.A, nd, s.b);
  contract<T, TE>(s.wdet, Q, a.Bgl2, nd, s.inv);
  __syncthreads();
  for (int idx = tid; idx < nd * TE; idx += NT) {
    const T inv = T(1) / s.inv[idx];
    s.inv[idx] = inv;
    s.x[idx] = inv * s.b[idx];
  }
  __syncthreads();

  // 5. Jacobi sweeps x += D^-1 (b - M_gl x), M_gl x = Bgl^T (wdet (Bgl x))
  for (int it = 0; it < a.n_cg; ++it) {
    contract<T, TE>(s.x, nd, a.BglT, Q, s.grad);
    __syncthreads();
    for (int idx = tid; idx < Q * TE; idx += NT) s.grad[idx] *= s.wdet[idx];
    __syncthreads();
    contract<T, TE>(s.grad, Q, a.Bgl, nd, s.ku);
    __syncthreads();
    for (int idx = tid; idx < nd * TE; idx += NT)
      s.x[idx] = s.x[idx] + s.inv[idx] * (s.b[idx] - s.ku[idx]);
    __syncthreads();
  }

  // 6. du_HO = x A^T
  contract<T, TE>(s.x, nd, a.AT, nd, s.du);
  return s.du;
}

// The two element sums of MassBasedAvg in the lumped-mass metric, after
// ml = wdet Bu is in s_ml and du_HO in s_du (both behind a barrier):
// red[e] = sum_j ml_j (u + dt du_HO)_j and red[TE + e] = sum_j ml_j. Their
// quotient is the element average of the new HO solution: it equals the
// reference's sum_q wdet_q (Bu (u + dt du_HO))_q / sum_q wdet_q exactly in
// real arithmetic (ml = wdet Bu, and Bernstein is a partition of unity).
// The caller places the barrier before it reads red.
template <typename T, int TE>
__device__ __forceinline__ void lo_element_sums(const T* s_u, const T* s_du,
                                                const T* s_ml, T dt, int nd,
                                                T* red) {
  element_sum<T, TE>(
      nd,
      [&](int j, int e) {
        return s_ml[j * TE + e] * (s_u[j * TE + e] + dt * s_du[j * TE + e]);
      },
      red);
  element_sum<T, TE>(nd, [&](int j, int e) { return s_ml[j * TE + e]; },
                     red + TE);
}

// Fill CoreArgs from the C interface's pointer and size arrays: ptrs are in
// the order of the struct's pointer members; sizes are E, nd, Q, Qf, nf, fd,
// n_cg.
template <typename T>
inline void fill_core_args(CoreArgs<T>& a, const void* const* p, double t,
                           const int* sz) {
  a.u = static_cast<const T*>(p[0]);
  a.unbr = static_cast<const T*>(p[1]);
  a.P = static_cast<const T*>(p[2]);
  a.GuT = static_cast<const T*>(p[3]);
  a.Buw = static_cast<const T*>(p[4]);
  a.Bface = static_cast<const T*>(p[5]);
  a.SBf = static_cast<const T*>(p[6]);
  a.A = static_cast<const T*>(p[7]);
  a.AT = static_cast<const T*>(p[8]);
  a.BglT = static_cast<const T*>(p[9]);
  a.Bgl = static_cast<const T*>(p[10]);
  a.Bgl2 = static_cast<const T*>(p[11]);
  a.Bu = static_cast<const T*>(p[12]);
  a.bdr = static_cast<const int*>(p[13]);
  a.dof_faces = static_cast<const int*>(p[14]);
  a.t = static_cast<T>(t);
  a.E = sz[0]; a.nd = sz[1]; a.Q = sz[2]; a.Qf = sz[3]; a.nf = sz[4];
  a.fd = sz[5]; a.n_cg = sz[6];
}

constexpr int N_CORE_PTRS = 15;
constexpr int N_CORE_SIZES = 7;

}  // namespace remhos
