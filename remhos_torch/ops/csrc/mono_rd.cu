// The monolithic RD solver's limited fluctuations, `-mono 1`, in one launch.
//
// No TPU counterpart: the JAX package forms the explicit part of
// MonoRDSolver in XLA ops (remhos_tpu/mono.py), as the port's plain chain
// does (ops/mono_rd.mono_rd_reference, moved from mono.explicit_part).
//
// What it computes (MonoRDSolver::CalcSolution, remhos_mono.cpp:60-260),
// for every element e from its K_elem [nd, nd], upwind face blocks B [nf,
// fd, fd], u, the dof bounds xi_min, xi_max, the indicator's dof values si
// (with -si), ml and the neighbour values u_nbr [nf, fd]:
//   z       = K u;
//   alpha_i = min(1, BETA min(up, dn) / (max(up, dn) + EPS)), up = xi_max -
//             u_i, dn = u_i - xi_min; with -si the relaxed bounds bndN, bndP
//             and the three-way choice on xi_min + xi_max against 2 u_i +- EPS
//             (remhos_mono.cpp:128-154);
//   du_i    = alpha_i z_i, and z_i -= alpha_i z_i;
//   du     += NonlinFluxLumping with alpha (remhos_tools.cpp:915-973): on each
//             face f, for its dof a, xd = u_nbr - u at the face's dofs, row_a
//             = sum_b B_ab, corr_a = (sum_b B_ab xd_b - row_a xd_a) alpha_a,
//             rescaled for conservation by the face's positive and negative
//             sums, plus row_a xd_a; added face by face in face order (the
//             order of mono.py's index_add over the bdr_dofs rows);
//   du     += the RD weights of the remaining z (lo.residual_distribution_core:
//             each weight's normaliser the sum of its own numerators);
// then, on problems 6 and 7 (no inner loop, FULL false), du = (du + 0) / ml;
// elsewhere (FULL) it also writes d_full = K u plus the same lumping with
// alpha = 1, which the inner consistent-mass loop reads. The elementwise
// steps round as the plain chain's ATen ops do (no contracted multiply-adds;
// K u, a matrix product there too, runs as a chain of FMAs); the sums over an
// element or a face run in index order.
//
// What bounds it on the H100: bytes. At 2048^2, p=1, f64 (the transport
// cell, FULL false) one launch reads K and B (537 MB each), u, xi_min,
// xi_max, si and ml (134 MB each), u_nbr (268 MB) and writes du: 2.15 GB,
// 0.64 ms at 3.35 TB/s; its 1.8 GFLOP take 0.03 ms (utils/cost.mono_rd_cost).
// The plain chain ran ~140 ATen ops, each streaming [E, nd] or [E, nf, fd,
// fd] arrays through memory: ~29 ms a stage.
//
// Design. One thread owns one dof i of one element; a block of NT threads
// holds TE = NT / nd whole elements (the last NT mod nd threads idle). Every
// load is issued first and goes straight to registers: the thread's own
// vector entries (neighbouring threads, neighbouring addresses), row i of K,
// and for each face holding dof i (at most dim, in face order, from the slot
// table) its row of B and the face's u_nbr, in 16-byte pieces where the row
// length allows. Nothing of an element touches device memory but its inputs
// and du: what a thread needs of its element's other dofs (u, the remaining
// z, the face corrections) passes through shared memory, with a barrier
// between the three passes (u; then z and the corrections; then the sums).
// Compiled for 2D p = 1 and 2 (the `-mono 1` sizes that run), f32 and f64,
// with and without -si and d_full; the operator launches it only there
// (ops/mono_rd.engages) and keeps the plain chain elsewhere. Measured at
// the cell's size (H100, f64, 0.641 ms bound): NT = 128 0.78 ms (kept), 256
// 0.80, 512 0.84; scalar loads in place of the 16-byte ones 0.81; streaming
// loads (__ldcs) 0.81; a thread per element, its dofs in registers and no
// shared memory, 0.97.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// mono_lumping.EPS (= lo.EPS) and mono_lumping.BETA
constexpr double EPS = 1.0e-15;
constexpr double BETA = 10.0;

// The sizes of one instance: nd dofs, nf faces of fd dofs; NT threads a
// block, TE elements a block.
template <int ND_, int NF_, int FD_>
struct Shape {
  static constexpr int ND = ND_, NF = NF_, FD = FD_;
  static constexpr int DIM = NF / 2;
  static constexpr int NS = NF * FD;          // face slots of an element
  static constexpr int NT = 128;
  static constexpr int TE = NT / ND;
};

template <typename T>
struct Args {
  const T* K;       // [E, nd, nd]
  const T* bdr;     // [E, nf, fd, fd]
  const T* u;       // [E, nd] each: u, xi_min, xi_max, si (or null), ml
  const T* xmin;
  const T* xmax;
  const T* si;
  const T* ml;
  const T* nbr;     // [E, nf, fd]
  const int* slots;  // [nd, dim]: f fd + a of the faces holding dof i, -1 past
  const int* fdofs;  // [nf, fd]: bdr_dofs
  T* du;            // [E, nd] out
  T* dfull;         // [E, nd] out where FULL
  int E;
};

// Rounded elementwise arithmetic: the plain chain's ATen ops round every
// product and sum, so no multiply-add may be contracted here.
__device__ __forceinline__ float mulR(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mulR(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float addR(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double addR(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float subR(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double subR(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float fmaR(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmaR(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// clamp(min=0), clamp(max=0), clamp(max=1), minimum, maximum as ATen takes
// them on finite values
template <typename T>
__device__ __forceinline__ T pos(T x) { return x < T(0) ? T(0) : x; }
template <typename T>
__device__ __forceinline__ T neg(T x) { return x > T(0) ? T(0) : x; }
template <typename T>
__device__ __forceinline__ T min1(T x) { return x > T(1) ? T(1) : x; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return b > a ? b : a; }

// n consecutive values from p (16-byte aligned wherever n allows a piece)
template <typename T, int N>
__device__ __forceinline__ void load_row(T (&d)[N], const T* p) {
  if constexpr (sizeof(T) == 8 && N % 2 == 0) {
    const double2* v = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const double2 x = __ldg(v + q);
      d[2 * q] = x.x;
      d[2 * q + 1] = x.y;
    }
  } else if constexpr (sizeof(T) == 4 && N % 4 == 0) {
    const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = __ldg(v + q);
      d[4 * q] = x.x;
      d[4 * q + 1] = x.y;
      d[4 * q + 2] = x.z;
      d[4 * q + 3] = x.w;
    }
  } else if constexpr (sizeof(T) == 4 && N % 2 == 0) {
    const float2* v = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x = __ldg(v + q);
      d[2 * q] = x.x;
      d[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) d[q] = __ldg(p + q);
  }
}

// The conservation rescaling of mono._rescale (remhos_tools.cpp:945-968):
// with the face's positive and negative sums sp, sn the larger side is
// scaled down so that the parts cancel.
template <typename T>
__device__ __forceinline__ T rescale(T c, T sp, T sn) {
  const T tot = addR(sp, sn);
  const T cp = pos(c), cn = neg(c);
  if (tot > T(EPS)) return subR(cn, mulR(cp, sn / (sp != T(0) ? sp : T(1))));
  if (tot < T(-EPS)) return subR(cp, mulR(cn, sp / (sn != T(0) ? sn : T(1))));
  return c;
}

// The per-dof limiter alpha (mono_rd_reference's, remhos_mono.cpp:128-154).
template <typename T, bool SI>
__device__ __forceinline__ T limiter(T u, T lo, T hi, T t) {
  const T beta = T(BETA), eps = T(EPS);
  const T up = subR(hi, u), dn = subR(u, lo);
  T al = min1(mulR(beta, tmin(up, dn)) / addR(tmax(up, dn), eps));
  if constexpr (SI) {
    const T u2 = mulR(T(2), u), rt = subR(T(1), t);
    const T bndN = pos(addR(mulR(t, subR(u2, hi)), mulR(rt, lo)));
    const T bndP = min1(addR(mulR(t, subR(u2, lo)), mulR(rt, hi)));
    const T aN = min1(mulR(beta, subR(u, bndN)) / addR(subR(hi, u), eps));
    const T aP = min1(mulR(beta, subR(bndP, u)) / addR(subR(u, lo), eps));
    const T mid = addR(lo, hi);
    al = mid > addR(u2, eps) ? aN : (mid < subR(u2, eps) ? aP : al);
  }
  return al;
}

template <typename T, int ND, int NF, int FD, bool SI, bool FULL>
__global__ void __launch_bounds__(Shape<ND, NF, FD>::NT)
mono_rd_kernel(const __grid_constant__ Args<T> a) {
  using S = Shape<ND, NF, FD>;
  constexpr int DIM = S::DIM, NS = S::NS, TE = S::TE;
  __shared__ T s_u[TE * ND];
  __shared__ T s_z[TE * ND];
  __shared__ T s_c[TE * NS];
  __shared__ T s_c1[FULL ? TE * NS : 1];
  const int t = threadIdx.x;
  const int el = t / ND, i = t - el * ND;
  const int64_t e = (int64_t)blockIdx.x * TE + el;
  const bool on = el < TE && e < a.E;
  const int64_t o = e * ND + i;

  // 1. every load: the own entries, row i of K, and for each face holding
  // dof i its row of B and the face's neighbour values
  T ui = T(0), lo = T(0), hi = T(0), th = T(0), m = T(1);
  T k[ND];
  T b[DIM][FD], nb[DIM][FD];
  int sl[DIM];
  if (on) {
    ui = __ldg(a.u + o);
    lo = __ldg(a.xmin + o);
    hi = __ldg(a.xmax + o);
    if constexpr (SI) th = __ldg(a.si + o);
    if constexpr (!FULL) m = __ldg(a.ml + o);
    load_row<T, ND>(k, a.K + o * ND);
#pragma unroll
    for (int q = 0; q < DIM; ++q) {
      sl[q] = __ldg(a.slots + i * DIM + q);
      if (sl[q] >= 0) {
        const int f = sl[q] / FD;
        load_row<T, FD>(b[q], a.bdr + (e * NS + sl[q]) * FD);
        load_row<T, FD>(nb[q], a.nbr + e * NS + f * FD);
      }
    }
    s_u[el * ND + i] = ui;
  }
  __syncthreads();

  // 2. z = K u, the limiter, the split; each face correction of dof i
  const T* ue = s_u + el * ND;
  T z = T(0), du = T(0), emax = T(0), emin = T(0);
  T lump[DIM], cor[DIM], cor1[DIM];
  if (on) {
    z = mulR(k[0], ue[0]);
    emax = emin = ue[0];
#pragma unroll
    for (int j = 1; j < ND; ++j) {
      const T uj = ue[j];
      z = fmaR(k[j], uj, z);
      emax = tmax(emax, uj);
      emin = tmin(emin, uj);
    }
    const T al = limiter<T, SI>(ui, lo, hi, th);
    du = mulR(al, z);
    s_z[el * ND + i] = subR(z, du);
#pragma unroll
    for (int q = 0; q < DIM; ++q) {
      if (sl[q] >= 0) {
        const int f = sl[q] / FD, p = sl[q] - f * FD;
        const int* fc = a.fdofs + f * FD;
        T s = T(0), row = T(0), xo = T(0);
#pragma unroll
        for (int c = 0; c < FD; ++c) {
          const T xd = subR(nb[q][c], ue[__ldg(fc + c)]);
          if (c == p) xo = xd;
          s = c == 0 ? mulR(b[q][c], xd) : addR(s, mulR(b[q][c], xd));
          row = c == 0 ? b[q][c] : addR(row, b[q][c]);
        }
        lump[q] = mulR(row, xo);
        const T c1 = subR(s, lump[q]);
        cor[q] = mulR(c1, al);
        s_c[el * NS + sl[q]] = cor[q];
        if constexpr (FULL) {
          cor1[q] = c1;
          s_c1[el * NS + sl[q]] = c1;
        }
      }
    }
  }
  __syncthreads();

  // 3. the face terms in face order, the RD weights, the result
  if (on) {
    T d = z;
#pragma unroll
    for (int q = 0; q < DIM; ++q) {
      if (sl[q] >= 0) {
        const int f = sl[q] / FD;
        const T* cf = s_c + el * NS + f * FD;
        T sp = pos(cf[0]), sn = neg(cf[0]);
#pragma unroll
        for (int c = 1; c < FD; ++c) {
          sp = addR(sp, pos(cf[c]));
          sn = addR(sn, neg(cf[c]));
        }
        du = addR(du, addR(lump[q], rescale(cor[q], sp, sn)));
        if constexpr (FULL) {
          const T* cf1 = s_c1 + el * NS + f * FD;
          T sp1 = pos(cf1[0]), sn1 = neg(cf1[0]);
#pragma unroll
          for (int c = 1; c < FD; ++c) {
            sp1 = addR(sp1, pos(cf1[c]));
            sn1 = addR(sn1, neg(cf1[c]));
          }
          d = addR(d, addR(lump[q], rescale(cor1[q], sp1, sn1)));
        }
      }
    }
    // the residual distribution of the remaining z (lo.py:51-59)
    const T* ze = s_z + el * ND;
    T rhoP = pos(ze[0]), rhoN = neg(ze[0]);
    T nP = subR(emax, ue[0]), nN = subR(emin, ue[0]);
#pragma unroll
    for (int j = 1; j < ND; ++j) {
      rhoP = addR(rhoP, pos(ze[j]));
      rhoN = addR(rhoN, neg(ze[j]));
      nP = addR(nP, subR(emax, ue[j]));
      nN = addR(nN, subR(emin, ue[j]));
    }
    const T wP = subR(emax, ui) / addR(nP, T(EPS));
    const T wN = subR(emin, ui) / subR(nN, T(EPS));
    du = addR(du, addR(addR(T(0), mulR(wP, rhoP)), mulR(wN, rhoN)));
    if constexpr (FULL) {
      a.du[o] = du;
      a.dfull[o] = d;
    } else {
      a.du[o] = addR(du, T(0)) / m;
    }
  }
}

struct Ptrs {
  const void *K, *bdr, *u, *xmin, *xmax, *si, *ml, *nbr;
  const int *slots, *fdofs;
  void *du, *dfull;
};

template <typename T, int ND, int NF, int FD, bool SI, bool FULL>
int launch_flags(const Ptrs& p, int E, cudaStream_t stream) {
  using S = Shape<ND, NF, FD>;
  Args<T> a;
  a.K = static_cast<const T*>(p.K);
  a.bdr = static_cast<const T*>(p.bdr);
  a.u = static_cast<const T*>(p.u);
  a.xmin = static_cast<const T*>(p.xmin);
  a.xmax = static_cast<const T*>(p.xmax);
  a.si = static_cast<const T*>(p.si);
  a.ml = static_cast<const T*>(p.ml);
  a.nbr = static_cast<const T*>(p.nbr);
  a.slots = p.slots;
  a.fdofs = p.fdofs;
  a.du = static_cast<T*>(p.du);
  a.dfull = static_cast<T*>(p.dfull);
  a.E = E;
  const int grid = (int)(((int64_t)E + S::TE - 1) / S::TE);
  mono_rd_kernel<T, ND, NF, FD, SI, FULL><<<grid, S::NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int ND, int NF, int FD>
int launch_sized(const Ptrs& p, int E, bool si, bool full,
                 cudaStream_t stream) {
  if (si && p.si == nullptr) return -1;
  if (!full && p.ml == nullptr) return -1;
  if (full && p.dfull == nullptr) return -1;
  if (si)
    return full ? launch_flags<T, ND, NF, FD, true, true>(p, E, stream)
                : launch_flags<T, ND, NF, FD, true, false>(p, E, stream);
  return full ? launch_flags<T, ND, NF, FD, false, true>(p, E, stream)
              : launch_flags<T, ND, NF, FD, false, false>(p, E, stream);
}

template <typename T>
int launch(const Ptrs& p, int E, int nd, int nf, int fd, bool si, bool full,
           cudaStream_t stream) {
  if (E < 0) return -1;
  if (E == 0) return 0;
#define REMHOS_MONO(ND_, NF_, FD_) \
  if (nd == ND_ && nf == NF_ && fd == FD_) \
    return launch_sized<T, ND_, NF_, FD_>(p, E, si, full, stream)
  REMHOS_MONO(4, 4, 2);
  REMHOS_MONO(9, 4, 3);
#undef REMHOS_MONO
  return -5;                         // no instance for these sizes
}

}  // namespace

extern "C" {

// K [E, nd, nd], bdr [E, nf, fd, fd], u, xi_min, xi_max, si (null without
// -si), ml [E, nd], u_nbr [E, nf, fd], slots (int32 [nd, nf / 2]) and fdofs
// (int32 [nf, fd]; ops/mono_rd.mono_rd_tables) -> du [E, nd] and, where
// full, d_full [E, nd]; sizes: E, nd, nf, fd, si (0|1), full (0|1). K, bdr
// and u_nbr start on 16-byte boundaries. Returns 0, a CUDA error code
// (> 0), or < 0 for a bad argument (-1: sizes or a missing operand; -2:
// type; -5: not a compiled element).
int remhos_mono_rd(int dtype_bytes, const void* K, const void* bdr,
                   const void* u, const void* xmin, const void* xmax,
                   const void* si, const void* ml, const void* nbr,
                   const int* slots, const int* fdofs, void* du, void* dfull,
                   const int* sizes, int nsizes, void* stream) {
  if (nsizes != 6) return -1;
  const Ptrs p{K, bdr, u, xmin, xmax, si, ml, nbr, slots, fdofs, du, dfull};
  const int E = sizes[0], nd = sizes[1], nf = sizes[2], fd = sizes[3];
  const bool with_si = sizes[4] != 0, full = sizes[5] != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4)
    return launch<float>(p, E, nd, nf, fd, with_si, full, s);
  if (dtype_bytes == 8)
    return launch<double>(p, E, nd, nf, fd, with_si, full, s);
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
