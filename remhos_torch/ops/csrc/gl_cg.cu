// Element-local Jacobi-preconditioned CG for the Gauss-Legendre mass inverse,
// with the Krylov state of a tile of elements in shared memory.
//
// Replaces: fused_gl_cg / _gl_cg_kernel in
//   remhos_tpu/ops/pallas_kernels.py (:209 / :162).
//
// What it computes, for every element independently (MFEM's DGMassInverse
// local CG, remhos_ho.cpp:79-80): b = rhs A (Bernstein -> GL), the Jacobi
// diagonal D = wdet Bgl2, then n_iter fixed CG iterations on
// M_gl g = Bgl^T (wdet (Bgl g)), each masked per element by the relative
// test rr > rel_tol2 * rr0 taken from the previous iteration's residual: a
// stopped element gets alpha = beta = 0, so its state is frozen. pAp == 0 and
// rz == 0 are guarded as in the TPU kernel. Out: x A^T.
//
// What bounds it on the H100: at N=24, p=3 in f32 one launch reads rhs
// (3.5 MB) and wdet (11.9 MB) and writes the result (3.5 MB), ~19 MB, ~6 us
// at 3.35 TB/s; the iterations' products, counted at sum-factorized size,
// put it near or above that (chip_smoke.py's cost model counts the
// iterations this run's data takes). As written the products are the dense
// table contractions of stage_core.cuh (`contract`), the three dots per
// iteration its fixed-order per-element sum (`element_sum`): a first, simple
// version.
//
// Layout: a block takes TE elements; x, r, z, p, Ap, D^-1 are [nd][TE], wdet
// and the point values [Q][TE], the per-element scalars [TE], all in shared
// memory for the whole solve. A tile leaves its iteration loop once every one
// of its elements has stopped: the remaining iterations would change nothing
// (alpha = 0 leaves x as it is).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "stage_core.cuh"

namespace {

using namespace remhos;

// elements per block: ~56 KB of shared memory at p=3 in 3D
template <typename T> struct CgTile;
template <> struct CgTile<float> { static constexpr int TE = 16; };
template <> struct CgTile<double> { static constexpr int TE = 8; };

template <typename T>
struct Args {
  const T* rhs;     // [E, nd]
  const T* wdet;    // [E, Q]
  const T* A;       // [nd, nd]
  const T* AT;      // [nd, nd]
  const T* BglT;    // [nd, Q]
  const T* Bgl;     // [Q, nd]
  const T* Bgl2;    // [Q, nd]
  T* out;           // [E, nd]
  T rel_tol2;
  int E, nd, Q, n_iter;
};

template <typename T>
size_t smem_bytes(int nd, int Q) {
  constexpr int TE = CgTile<T>::TE;
  return ((size_t)6 * nd + 2 * (size_t)Q + 7) * TE * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(NT) gl_cg_kernel(const Args<T> a) {
  constexpr int TE = CgTile<T>::TE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nd = a.nd, Q = a.Q;
  T* s_x = reinterpret_cast<T*>(smem_raw);   // [nd][TE]
  T* s_r = s_x + nd * TE;
  T* s_z = s_r + nd * TE;                    // first the tile's rhs
  T* s_p = s_z + nd * TE;
  T* s_ap = s_p + nd * TE;                   // Ap; at the end x A^T
  T* s_inv = s_ap + nd * TE;
  T* s_w = s_inv + nd * TE;                  // [Q][TE] wdet
  T* s_t = s_w + Q * TE;                     // [Q][TE] point values
  T* s_rz = s_t + Q * TE;                    // [TE] each
  T* s_rr = s_rz + TE;
  T* s_tol = s_rr + TE;
  T* s_pap = s_tol + TE;
  T* s_rzn = s_pap + TE;
  T* s_rrn = s_rzn + TE;
  int* s_live = reinterpret_cast<int*>(s_rrn + TE);   // one flag

  const int tid = threadIdx.x;
  const int e_base = blockIdx.x * TE;
  const int ne = min(TE, a.E - e_base);

  // the tile's rhs and wdet; rows e >= ne hold rhs = 0 and wdet = 1, so they
  // start (and stay) stopped with finite values
  for (int idx = tid; idx < TE * nd; idx += NT) {
    const int e = idx / nd, j = idx % nd;
    s_z[j * TE + e] = e < ne ? a.rhs[(size_t)(e_base + e) * nd + j] : T(0);
  }
  for (int idx = tid; idx < TE * Q; idx += NT) {
    const int e = idx / Q, q = idx % Q;
    s_w[q * TE + e] = e < ne ? a.wdet[(size_t)(e_base + e) * Q + q] : T(1);
  }
  __syncthreads();

  // b = rhs A (kept in r), the Jacobi diagonal; x = 0, z = D^-1 r, p = z
  contract<T, TE>(s_z, nd, a.A, nd, s_r);
  contract<T, TE>(s_w, Q, a.Bgl2, nd, s_inv);
  __syncthreads();
  for (int idx = tid; idx < nd * TE; idx += NT) {
    const T inv = T(1) / s_inv[idx];
    s_inv[idx] = inv;
    s_x[idx] = T(0);
    const T z = inv * s_r[idx];
    s_z[idx] = z;
    s_p[idx] = z;
  }
  __syncthreads();
  element_sum<T, TE>(nd, [&](int j, int e) {
    return s_r[j * TE + e] * s_z[j * TE + e]; }, s_rz);
  element_sum<T, TE>(nd, [&](int j, int e) {
    return s_r[j * TE + e] * s_r[j * TE + e]; }, s_rr);
  __syncthreads();
  if (tid < TE) s_tol[tid] = a.rel_tol2 * s_rr[tid];
  __syncthreads();

  for (int it = 0; it < a.n_iter; ++it) {
    // live is taken from the previous iteration's rr
    if (tid == 0) {
      int any = 0;
      for (int e = 0; e < TE; ++e) any |= s_rr[e] > s_tol[e];
      *s_live = any;
    }
    __syncthreads();
    if (!*s_live) break;        // every element stopped: nothing changes

    // Ap = Bgl^T (wdet (Bgl p)), pAp
    contract<T, TE>(s_p, nd, a.BglT, Q, s_t);
    __syncthreads();
    for (int idx = tid; idx < Q * TE; idx += NT) s_t[idx] *= s_w[idx];
    __syncthreads();
    contract<T, TE>(s_t, Q, a.Bgl, nd, s_ap);
    __syncthreads();
    element_sum<T, TE>(nd, [&](int j, int e) {
      return s_p[j * TE + e] * s_ap[j * TE + e]; }, s_pap);
    __syncthreads();

    for (int idx = tid; idx < nd * TE; idx += NT) {
      const int e = idx % TE;
      const bool live = s_rr[e] > s_tol[e];
      const T pap = s_pap[e];
      const T alpha = live ? s_rz[e] / (pap != T(0) ? pap : T(1)) : T(0);
      s_x[idx] = s_x[idx] + alpha * s_p[idx];
      const T r = s_r[idx] - alpha * s_ap[idx];
      s_r[idx] = r;
      s_z[idx] = s_inv[idx] * r;
    }
    __syncthreads();
    element_sum<T, TE>(nd, [&](int j, int e) {
      return s_r[j * TE + e] * s_z[j * TE + e]; }, s_rzn);
    element_sum<T, TE>(nd, [&](int j, int e) {
      return s_r[j * TE + e] * s_r[j * TE + e]; }, s_rrn);
    __syncthreads();
    for (int idx = tid; idx < nd * TE; idx += NT) {
      const int e = idx % TE;
      if (s_rr[e] > s_tol[e]) {
        const T rz = s_rz[e];
        const T beta = s_rzn[e] / (rz != T(0) ? rz : T(1));
        s_p[idx] = s_z[idx] + beta * s_p[idx];
      }
    }
    __syncthreads();
    if (tid < TE && s_rr[tid] > s_tol[tid]) {
      s_rz[tid] = s_rzn[tid];
      s_rr[tid] = s_rrn[tid];
    }
    __syncthreads();
  }

  // out = x A^T
  contract<T, TE>(s_x, nd, a.AT, nd, s_ap);
  __syncthreads();
  for (int idx = tid; idx < TE * nd; idx += NT) {
    const int e = idx / nd, j = idx % nd;
    if (e < ne) a.out[(size_t)(e_base + e) * nd + j] = s_ap[j * TE + e];
  }
}

template <typename T>
int launch(const void* const* p, double rel_tol2, const int* sz,
           cudaStream_t stream) {
  constexpr int TE = CgTile<T>::TE;
  Args<T> a;
  a.rhs = static_cast<const T*>(p[0]);
  a.wdet = static_cast<const T*>(p[1]);
  a.A = static_cast<const T*>(p[2]);
  a.AT = static_cast<const T*>(p[3]);
  a.BglT = static_cast<const T*>(p[4]);
  a.Bgl = static_cast<const T*>(p[5]);
  a.Bgl2 = static_cast<const T*>(p[6]);
  a.out = static_cast<T*>(const_cast<void*>(p[7]));
  a.rel_tol2 = static_cast<T>(rel_tol2);
  a.E = sz[0]; a.nd = sz[1]; a.Q = sz[2]; a.n_iter = sz[3];
  if (a.E <= 0) return 0;
  if (a.n_iter < 0) return -4;
  const size_t smem = smem_bytes<T>(a.nd, a.Q);
  if (smem > 227 * 1024) return -3;
  // the shared-memory attribute is set once per size and device
  const int rc =
      allow_smem(reinterpret_cast<const void*>(&gl_cg_kernel<T>), smem);
  if (rc != 0) return rc;
  const int blocks = (a.E + TE - 1) / TE;
  gl_cg_kernel<T><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: rhs, wdet, A, AT, BglT, Bgl, Bgl2, out; sizes: E, nd, Q, n_iter;
// rel_tol2 is the square of the relative tolerance. Returns 0, a CUDA error
// code (> 0), or < 0 for a bad argument.
int remhos_gl_cg(int dtype_bytes, const void* const* ptrs, int nptrs,
                 double rel_tol2, const int* sizes, int nsizes,
                 void* stream) {
  if (nptrs != 8 || nsizes != 4) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4) return launch<float>(ptrs, rel_tol2, sizes, s);
  if (dtype_bytes == 8) return launch<double>(ptrs, rel_tol2, sizes, s);
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
