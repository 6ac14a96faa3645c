// The shared core of the HO remap stage kernels.
//
// Counterpart of _poly_stage_core and _mass_based_avg_core in
// remhos_tpu/ops/pallas_kernels.py (:578, :683), which _stage_ho_poly_kernel
// and _stage_mega_kernel share there, and of the body of _stage_ho_kernel
// (:265); here stage_ho.cu, mega_stage.cu and stage_ho_nodes.cu share
// stage_core() and lo_element_sums().
//
// stage_core computes, for one tile of TE elements held in shared memory
// (nd dofs, Q volume and FQ = nf*Qf face quadrature points per element):
//   0. loads the tile's u and u_nbr (and whatever the geometry provider
//      stages in shared memory);
//   1. reference gradients of u at the volume points;
//   2. from the geometry provider G, per volume point va_b (the convective
//      velocity adj(J)^T v, times the volume sign) and w_q det J, per face
//      point the normal velocity vn (times the flux mode); the volume
//      integrand and the DG upwind face flux max(0, vn) (u_nbr - u_own);
//   3. Ku: the volume part, plus the face flux scattered to the face dofs;
//   4. b = Ku A and the Jacobi diagonal of the GL mass matrix;
//   5. n_cg Jacobi sweeps x += D^-1 (b - M_gl x);
//   6. du_HO = x A^T.
// With n_cg == 0 it stops after step 3 and returns Ku; with with_face == 0
// it skips the face flux (a phase ablation of kernel 5).
//
// Two geometry providers:
//   PolyGeom  (kernels 1 and 2): va_b, w_q det J and vn by Horner's rule
//             from the t-polynomial coefficients P = [VA | WDET | VN]
//             (ops/tables.py); remap sign and mode +1;
//   NodeGeom  (kernel 5): from the nodes xs and the nodal velocity v of the
//             tile, staged in shared memory: the Jacobian by a length-nm dot
//             per entry, closed-form cofactors and det J, v_q, the face
//             tangents T1 (reference-normal sign folded in) and T2, v at the
//             face points, the normal T1 x T2 (2D: T1 rotated); sign and
//             mode +-1.
// A provider has load() (step 0), volume() and face() (step 2).
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

// What the core reads besides the geometry: the stage's operands and the
// static tables.
template <typename T>
struct CoreArgs {
  const T* u;       // [E, nd]
  const T* unbr;    // [E, nf*fd] face-neighbour dofs, 0 on physical edges
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
  int E, nd, Q, Qf, nf, fd, n_cg;
  int with_face;         // 0: no face flux (kernel 5's phase ablation)
};

// Step 2's geometry from the t-polynomial coefficients P[E, width] (layout
// ops/tables.poly_layout): va_b, w_q det J and vn by Horner's rule at t.
template <typename T, int DIM>
struct PolyGeom {
  static constexpr int NKV = DIM, NKD = DIM + 1, NKN = DIM;
  const T* P;
  T t;
  int Q, FQ;

  __device__ __forceinline__ void load(int, int) const {}

  __device__ __forceinline__ const T* row(int eg) const {
    return P + (size_t)eg * ((NKV * DIM + NKD) * Q + NKN * FQ);
  }

  // va[b] and w_q det J at volume point q of element eg
  __device__ __forceinline__ void volume(int, int eg, int q, T* va,
                                         T& wd) const {
    const T* Pe = row(eg);
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      T acc = Pe[((NKV - 1) * DIM + b) * Q + q];
#pragma unroll
      for (int k = NKV - 2; k >= 0; --k) acc = Pe[(k * DIM + b) * Q + q] + t * acc;
      va[b] = acc;
    }
    const int off = NKV * DIM * Q;
    wd = Pe[off + (NKD - 1) * Q + q];
#pragma unroll
    for (int k = NKD - 2; k >= 0; --k) wd = Pe[off + k * Q + q] + t * wd;
  }

  // the upwind normal velocity at face point fq of element eg
  __device__ __forceinline__ T face(int, int eg, int fq) const {
    const T* Pe = row(eg) + (NKV * DIM + NKD) * Q;
    T vn = Pe[(NKN - 1) * FQ + fq];
#pragma unroll
    for (int k = NKN - 2; k >= 0; --k) vn = Pe[k * FQ + fq] + t * vn;
    return vn;
  }
};

// Step 2's geometry from the nodes xs and the nodal velocity v[E, nm, DIM]
// (kernel 5). The tile's rows go to shared memory (s_x, s_v: [TE][nm*DIM])
// and are read as broadcasts; the point tables are point-minor, so the
// threads of a warp, which hold consecutive points, read consecutive
// entries. The sums are geom_conv.cu's, in its order.
template <typename T, int DIM>
struct NodeGeom {
  const T* xs;     // [E, nm, DIM]
  const T* v;      // [E, nm, DIM]
  const T* GmT;    // [nm, DIM, Q]
  const T* BmT;    // [nm, Q]
  const T* GT1;    // [nm, FQ] first tangent, reference-normal sign folded in
  const T* GT2;    // [nm, FQ] second tangent (3D)
  const T* BmfT;   // [nm, FQ]
  const T* w_q;    // [Q]
  T* s_x;          // [TE][nm*DIM] shared
  T* s_v;
  T mode;          // +1 remap, -1 transport: the volume sign and flux mode
  int nm, Q, FQ;

  __device__ __forceinline__ void load(int e_base, int ne) const {
    const int n = ne * nm * DIM;
    const size_t g0 = (size_t)e_base * nm * DIM;
    for (int idx = threadIdx.x; idx < n; idx += NT) {
      s_x[idx] = xs[g0 + idx];
      s_v[idx] = v[g0 + idx];
    }
  }

  __device__ __forceinline__ void volume(int e, int, int q, T* va,
                                         T& wd) const {
    T J[DIM][DIM], vq[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      vq[d] = T(0);
#pragma unroll
      for (int b = 0; b < DIM; ++b) J[d][b] = T(0);
    }
    const T* xe = s_x + e * nm * DIM;
    const T* ve = s_v + e * nm * DIM;
    for (int n = 0; n < nm; ++n) {
      T gm[DIM];
#pragma unroll
      for (int b = 0; b < DIM; ++b)
        gm[b] = __ldg(GmT + ((size_t)n * DIM + b) * Q + q);
      const T bm = __ldg(BmT + (size_t)n * Q + q);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const T x = xe[n * DIM + d];
#pragma unroll
        for (int b = 0; b < DIM; ++b) J[d][b] = fmaT(x, gm[b], J[d][b]);
        vq[d] = fmaT(ve[n * DIM + d], bm, vq[d]);
      }
    }
    T det;
    if constexpr (DIM == 3) {
      T cof[3][3];
      cof[0][0] = J[1][1] * J[2][2] - J[1][2] * J[2][1];
      cof[0][1] = J[1][2] * J[2][0] - J[1][0] * J[2][2];
      cof[0][2] = J[1][0] * J[2][1] - J[1][1] * J[2][0];
      cof[1][0] = J[0][2] * J[2][1] - J[0][1] * J[2][2];
      cof[1][1] = J[0][0] * J[2][2] - J[0][2] * J[2][0];
      cof[1][2] = J[0][1] * J[2][0] - J[0][0] * J[2][1];
      cof[2][0] = J[0][1] * J[1][2] - J[0][2] * J[1][1];
      cof[2][1] = J[0][2] * J[1][0] - J[0][0] * J[1][2];
      cof[2][2] = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      det = J[0][0] * cof[0][0] + J[0][1] * cof[0][1] + J[0][2] * cof[0][2];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        va[b] = mode * (cof[0][b] * vq[0] + cof[1][b] * vq[1] +
                        cof[2][b] * vq[2]);
    } else {
      // cof = ((J11, -J10), (-J01, J00))
      det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      va[0] = mode * (J[1][1] * vq[0] - J[0][1] * vq[1]);
      va[1] = mode * (J[0][0] * vq[1] - J[1][0] * vq[0]);
    }
    wd = __ldg(w_q + q) * det;
  }

  __device__ __forceinline__ T face(int e, int, int fq) const {
    constexpr int NT_ = DIM - 1;    // tangents per face point
    T tan[NT_][DIM], vf[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      vf[d] = T(0);
#pragma unroll
      for (int k = 0; k < NT_; ++k) tan[k][d] = T(0);
    }
    const T* xe = s_x + e * nm * DIM;
    const T* ve = s_v + e * nm * DIM;
    for (int n = 0; n < nm; ++n) {
      T gt[NT_];
      gt[0] = __ldg(GT1 + (size_t)n * FQ + fq);
      if constexpr (DIM == 3) gt[1] = __ldg(GT2 + (size_t)n * FQ + fq);
      const T bm = __ldg(BmfT + (size_t)n * FQ + fq);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const T x = xe[n * DIM + d];
#pragma unroll
        for (int k = 0; k < NT_; ++k) tan[k][d] = fmaT(x, gt[k], tan[k][d]);
        vf[d] = fmaT(ve[n * DIM + d], bm, vf[d]);
      }
    }
    T vn;
    if constexpr (DIM == 3) {
      const T n0 = tan[0][1] * tan[1][2] - tan[0][2] * tan[1][1];
      const T n1 = tan[0][2] * tan[1][0] - tan[0][0] * tan[1][2];
      const T n2 = tan[0][0] * tan[1][1] - tan[0][1] * tan[1][0];
      vn = vf[0] * n0 + vf[1] * n1 + vf[2] * n2;
    } else {
      vn = vf[0] * tan[0][1] + vf[1] * -tan[0][0];
    }
    return mode * vn;
  }
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

// Steps 0-6 above for the tile of ne <= TE elements starting at e_base, with
// the geometry of provider g. Returns the shared array [nd][TE] that holds
// the result: s.du (du_HO), or s.ku (Ku) when n_cg == 0. The last
// contraction is NOT followed by a barrier: the caller calls __syncthreads()
// before it reads the result (it may put further contractions of s.wdet
// before that barrier). Rows e >= ne of the tile hold u = 0 and wdet = 1, so
// every later division is finite.
template <typename T, int DIM, int TE, typename G>
__device__ __forceinline__ T* stage_core(const CoreArgs<T>& a, const G& g,
                                         const CoreSmem<T>& s, int e_base,
                                         int ne) {
  const int nd = a.nd, Q = a.Q, Qf = a.Qf, nf = a.nf, fd = a.fd;
  const int FQ = nf * Qf, NFD = nf * fd;
  const bool face = a.with_face != 0;
  const int tid = threadIdx.x;

  // 0. the tile's u and u_nbr, and the provider's rows
  for (int idx = tid; idx < TE * nd; idx += NT) {
    const int e = idx / nd, j = idx % nd;
    s.u[j * TE + e] = e < ne ? a.u[(size_t)(e_base + e) * nd + j] : T(0);
  }
  if (face) {
    for (int idx = tid; idx < TE * NFD; idx += NT) {
      const int e = idx / NFD, j = idx % NFD;
      s.un[j * TE + e] = e < ne ? a.unbr[(size_t)(e_base + e) * NFD + j] : T(0);
    }
  }
  g.load(e_base, ne);
  __syncthreads();

  // 1. reference gradients of u at the volume points
  contract<T, TE>(s.u, nd, a.GuT, DIM * Q, s.grad);
  __syncthreads();

  // 2. pointwise: the provider's va, wdet, vn; volume integrand; face flux
  const int QQ = Q > FQ ? Q : FQ;
  for (int idx = tid; idx < TE * QQ; idx += NT) {
    const int e = idx / QQ, q = idx % QQ;
    if (e >= ne) {
      if (q < Q) { s.duq[q * TE + e] = T(0); s.wdet[q * TE + e] = T(1); }
      if (q < FQ) s.flux[q * TE + e] = T(0);
      continue;
    }
    if (q < Q) {
      T va[DIM], wd;
      g.volume(e, e_base + e, q, va, wd);
      T duq = T(0);
#pragma unroll
      for (int b = 0; b < DIM; ++b) {
        const T gr = s.grad[(b * Q + q) * TE + e];
        duq = b == 0 ? va[b] * gr : duq + va[b] * gr;
      }
      s.duq[q * TE + e] = duq;
      s.wdet[q * TE + e] = wd;
    }
    if (face && q < FQ) {
      const T vn = g.face(e, e_base + e, q);
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
  if (face) {
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
// the order u, u_nbr, P, then the tables in the struct's order (P, which
// PolyGeom reads, keeps its slot: the three stage libraries share the
// order); sizes are E, nd, Q, Qf, nf, fd, n_cg.
template <typename T>
inline void fill_core_args(CoreArgs<T>& a, const void* const* p,
                           const int* sz) {
  a.u = static_cast<const T*>(p[0]);
  a.unbr = static_cast<const T*>(p[1]);
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
  a.E = sz[0]; a.nd = sz[1]; a.Q = sz[2]; a.Qf = sz[3]; a.nf = sz[4];
  a.fd = sz[5]; a.n_cg = sz[6];
  a.with_face = 1;
}

// PolyGeom from the same arrays (P in slot 2) and the stage time t.
template <typename T, int DIM>
inline PolyGeom<T, DIM> poly_geom(const void* const* p, double t,
                                  const int* sz) {
  PolyGeom<T, DIM> g;
  g.P = static_cast<const T*>(p[2]);
  g.t = static_cast<T>(t);
  g.Q = sz[2];
  g.FQ = sz[4] * sz[3];
  return g;
}

constexpr int N_CORE_PTRS = 15;
constexpr int N_CORE_SIZES = 7;

}  // namespace remhos
