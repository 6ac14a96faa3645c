// w_q det J at the volume quadrature points from the nodal mesh positions.
//
// Replaces: fused_wdet / _wdet_kernel in remhos_tpu/ops/pallas_kernels.py
//   (:1130 / :1110).
//
// What it computes: for every element e and volume point q the Jacobian
//   J[d][b] = sum_n xs[e, n, d] * Gm[q, n, b]   (a length-nm dot each),
// its determinant in closed form (2x2 or 3x3) and wdet[e, q] = w_q[q] det J.
// J never reaches device memory.
//
// Layout: xs[E, nm, dim] as the mesh stores it (the TPU wrapper transposes
// to [dim, E, nm] for its lanes; nothing obliges the port to). The gradient
// table arrives as GmT[nm, dim, Q], point-minor, so that the threads of a
// warp, which hold consecutive points q, read consecutive table entries.
//
// What bounds it on the H100: bytes. At N=24, mesh order 2, p=3 in f32 it
// reads 4.5 MB of xs and writes 11.9 MB of wdet, ~5 us at 3.35 TB/s, against
// ~0.7 G multiply-adds as written (dim*dim*nm per point, ~22 us at the f32
// FMA rate): the dense per-point dots, not the bytes, set this first
// version's time; sum factorization of Gm would bring the arithmetic under
// the bytes. One block takes TE elements: their xs go to shared memory (read
// as broadcasts), one thread per (element, point) keeps the dim*dim sums in
// registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int TE = 8;     // elements per block

__device__ __forceinline__ float fmaT(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmaT(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(NT)
wdet_kernel(const T* __restrict__ xs, const T* __restrict__ GmT,
            const T* __restrict__ w_q, T* __restrict__ wdet, int E, int nm,
            int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_x = reinterpret_cast<T*>(smem_raw);     // [TE][nm*DIM]
  const int e_base = blockIdx.x * TE;
  const int ne = min(TE, E - e_base);
  const int row = nm * DIM;
  for (int idx = threadIdx.x; idx < ne * row; idx += NT)
    s_x[idx] = xs[(size_t)e_base * row + idx];
  __syncthreads();

  for (int idx = threadIdx.x; idx < ne * Q; idx += NT) {
    const int e = idx / Q, q = idx % Q;
    T J[DIM][DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
#pragma unroll
      for (int b = 0; b < DIM; ++b) J[d][b] = T(0);
    const T* xe = s_x + e * row;
    for (int n = 0; n < nm; ++n) {
      T g[DIM];
#pragma unroll
      for (int b = 0; b < DIM; ++b)
        g[b] = __ldg(GmT + ((size_t)n * DIM + b) * Q + q);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const T x = xe[n * DIM + d];
#pragma unroll
        for (int b = 0; b < DIM; ++b) J[d][b] = fmaT(x, g[b], J[d][b]);
      }
    }
    T det;
    if constexpr (DIM == 3) {
      det = J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1]) +
            J[0][1] * (J[1][2] * J[2][0] - J[1][0] * J[2][2]) +
            J[0][2] * (J[1][0] * J[2][1] - J[1][1] * J[2][0]);
    } else {
      det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    }
    wdet[(size_t)(e_base + e) * Q + q] = __ldg(w_q + q) * det;
  }
}

template <typename T, int DIM>
int launch(const void* xs, const void* GmT, const void* w_q, void* wdet,
           int E, int nm, int Q, cudaStream_t stream) {
  if (E <= 0) return 0;
  const size_t smem = (size_t)TE * nm * DIM * sizeof(T);
  if (smem > 48 * 1024) return -3;
  const int blocks = (E + TE - 1) / TE;
  wdet_kernel<T, DIM><<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(GmT),
      static_cast<const T*>(w_q), static_cast<T*>(wdet), E, nm, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xs[E, nm, dim], GmT[nm, dim, Q], w_q[Q] -> wdet[E, Q]. Returns 0, a CUDA
// error code (> 0), or < 0 for a bad argument.
int remhos_wdet(int dtype_bytes, int dim, const void* xs, const void* GmT,
                const void* w_q, void* wdet, int E, int nm, int Q,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4 && dim == 3) return launch<float, 3>(xs, GmT, w_q, wdet, E, nm, Q, s);
  if (dtype_bytes == 8 && dim == 3) return launch<double, 3>(xs, GmT, w_q, wdet, E, nm, Q, s);
  if (dtype_bytes == 4 && dim == 2) return launch<float, 2>(xs, GmT, w_q, wdet, E, nm, Q, s);
  if (dtype_bytes == 8 && dim == 2) return launch<double, 2>(xs, GmT, w_q, wdet, E, nm, Q, s);
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
