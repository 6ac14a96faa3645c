// Stage geometry fused with the volume convection action, from the nodal
// mesh positions and the nodal mesh velocity.
//
// Replaces: fused_geom_conv / _geom_conv_kernel in
//   remhos_tpu/ops/pallas_kernels.py (:110 / :55).
//
// What it computes, for every element e:
//   J[d][b]  = sum_n xs[e, n, d] Gm[q, n, b]        Jacobian at point q
//   cof, det   closed form (2x2 or 3x3); wdet[e, q] = w_q[q] det J
//   v_q[d]   = sum_n v[e, n, d] Bm[q, n]            velocity at point q
//   va[b]    = sum_d cof[d][b] v_q[d]               (adj J v)
//   g[b]     = sum_j u[e, j] Gu[q, j, b]            reference gradient of u
//   du_q     = sign * sum_b va[b] g[b]
//   Ku[e, i] = sum_q du_q Buw[q, i]                 Buw = w_q Bu
// J, the cofactors, v_q, va and du_q never reach device memory: one read of
// (xs, v, u), one write of (Ku, wdet).
//
// Layout: xs and v stay [E, nm, dim] as the mesh stores them (the TPU
// wrapper transposes to [dim, E, nm] for its lanes; nothing obliges the
// port to). The point tables arrive point-minor, GmT[nm, dim, Q], BmT[nm, Q]
// and GuT[nd, dim, Q], so that the threads of a warp, which hold consecutive
// points q, read consecutive table entries; Buw[Q, nd] is dof-minor for the
// second phase, whose threads hold consecutive dofs.
//
// What bounds it on the H100: bytes. At N=24, mesh order 2, p=3 in f32 it
// reads 12.5 MB (xs, v, u) and writes 15.5 MB (Ku, wdet), ~8 us at 3.35
// TB/s. As written it does dense per-point dots, ~1.7 G multiply-adds
// (nm (dim^2 + dim) + nd dim per point, plus Q per dof), ~50 us at the f32
// FMA rate, each with a table load from L1/L2: the dots, not the bytes, set
// this first version's time. Sum factorization of the tensor-product tables
// would bring the arithmetic under the bytes.
//
// One block takes `te` elements: their xs, v and u rows go to shared memory
// and are read as broadcasts. Phase 1 gives one thread to each (element,
// point): the dim*dim + 2 dim sums stay in registers, wdet goes out, du_q
// goes to shared memory. Phase 2 gives one thread to each (element, dof) for
// the length-Q dot with Buw. Every sum is taken by one thread in a fixed
// order, so a result does not depend on the launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int TE_MAX = 8;    // elements per block, halved until they fit
constexpr size_t SMEM_MAX = 48 * 1024;

__device__ __forceinline__ float fmaT(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmaT(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(NT)
geom_conv_kernel(const T* __restrict__ xs, const T* __restrict__ v,
                 const T* __restrict__ u, const T* __restrict__ GmT,
                 const T* __restrict__ BmT, const T* __restrict__ GuT,
                 const T* __restrict__ Buw, const T* __restrict__ w_q,
                 T sign, T* __restrict__ Ku, T* __restrict__ wdet, int E,
                 int nm, int nd, int Q, int te) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = nm * DIM;
  T* s_x = reinterpret_cast<T*>(smem_raw);   // [te][nm*DIM]
  T* s_v = s_x + te * row;                   // [te][nm*DIM]
  T* s_u = s_v + te * row;                   // [te][nd]
  T* s_dq = s_u + te * nd;                   // [te][Q]
  const int e_base = blockIdx.x * te;
  const int ne = min(te, E - e_base);
  for (int idx = threadIdx.x; idx < ne * row; idx += NT) {
    s_x[idx] = xs[(size_t)e_base * row + idx];
    s_v[idx] = v[(size_t)e_base * row + idx];
  }
  for (int idx = threadIdx.x; idx < ne * nd; idx += NT)
    s_u[idx] = u[(size_t)e_base * nd + idx];
  __syncthreads();

  // phase 1: one thread per (element, point)
  for (int idx = threadIdx.x; idx < ne * Q; idx += NT) {
    const int e = idx / Q, q = idx % Q;
    T J[DIM][DIM], vq[DIM], g[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      vq[d] = T(0);
      g[d] = T(0);
#pragma unroll
      for (int b = 0; b < DIM; ++b) J[d][b] = T(0);
    }
    const T* xe = s_x + e * row;
    const T* ve = s_v + e * row;
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
    const T* ue = s_u + e * nd;
    for (int j = 0; j < nd; ++j) {
      const T uj = ue[j];
#pragma unroll
      for (int b = 0; b < DIM; ++b)
        g[b] = fmaT(uj, __ldg(GuT + ((size_t)j * DIM + b) * Q + q), g[b]);
    }
    T det, dq;
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
      dq = T(0);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const T va = cof[0][b] * vq[0] + cof[1][b] * vq[1] +
                     cof[2][b] * vq[2];
        dq += va * g[b];
      }
    } else {
      // cof = ((J11, -J10), (-J01, J00))
      det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      const T va0 = J[1][1] * vq[0] - J[0][1] * vq[1];
      const T va1 = J[0][0] * vq[1] - J[1][0] * vq[0];
      dq = va0 * g[0] + va1 * g[1];
    }
    wdet[(size_t)(e_base + e) * Q + q] = __ldg(w_q + q) * det;
    s_dq[e * Q + q] = sign * dq;
  }
  __syncthreads();

  // phase 2: one thread per (element, dof)
  for (int idx = threadIdx.x; idx < ne * nd; idx += NT) {
    const int e = idx / nd, i = idx % nd;
    const T* dq = s_dq + e * Q;
    T acc = T(0);
    for (int q = 0; q < Q; ++q)
      acc = fmaT(dq[q], __ldg(Buw + (size_t)q * nd + i), acc);
    Ku[(size_t)(e_base + e) * nd + i] = acc;
  }
}

template <typename T, int DIM>
int launch(const void* xs, const void* v, const void* u, const void* GmT,
           const void* BmT, const void* GuT, const void* Buw,
           const void* w_q, double sign, void* Ku, void* wdet, int E, int nm,
           int nd, int Q, cudaStream_t stream) {
  if (E <= 0) return 0;
  const size_t per_el = ((size_t)2 * nm * DIM + nd + Q) * sizeof(T);
  int te = TE_MAX;
  while (te > 0 && te * per_el > SMEM_MAX) te /= 2;
  if (te == 0) return -3;
  const int blocks = (E + te - 1) / te;
  geom_conv_kernel<T, DIM><<<blocks, NT, te * per_el, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(v),
      static_cast<const T*>(u), static_cast<const T*>(GmT),
      static_cast<const T*>(BmT), static_cast<const T*>(GuT),
      static_cast<const T*>(Buw), static_cast<const T*>(w_q), T(sign),
      static_cast<T*>(Ku), static_cast<T*>(wdet), E, nm, nd, Q, te);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xs[E, nm, dim], v[E, nm, dim], u[E, nd], GmT[nm, dim, Q], BmT[nm, Q],
// GuT[nd, dim, Q], Buw[Q, nd], w_q[Q], sign -> Ku[E, nd], wdet[E, Q].
// Returns 0, a CUDA error code (> 0), or < 0 for a bad argument (-2: type
// or dimension; -3: one element's rows exceed the shared memory).
int remhos_geom_conv(int dtype_bytes, int dim, const void* xs, const void* v,
                     const void* u, const void* GmT, const void* BmT,
                     const void* GuT, const void* Buw, const void* w_q,
                     double sign, void* Ku, void* wdet, int E, int nm, int nd,
                     int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REMHOS_GC(T, D)                                                     \
  return launch<T, D>(xs, v, u, GmT, BmT, GuT, Buw, w_q, sign, Ku, wdet, E, \
                      nm, nd, Q, s)
  if (dtype_bytes == 4 && dim == 3) REMHOS_GC(float, 3);
  if (dtype_bytes == 8 && dim == 3) REMHOS_GC(double, 3);
  if (dtype_bytes == 4 && dim == 2) REMHOS_GC(float, 2);
  if (dtype_bytes == 8 && dim == 2) REMHOS_GC(double, 2);
#undef REMHOS_GC
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
