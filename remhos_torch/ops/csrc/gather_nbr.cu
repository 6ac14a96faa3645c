// The structured neighbour face-dof gather: for every element e, face f and
// face dof i, u_nbr[e, f*fd + i] = u[nbr(e, f), nbr_dof_local[f, i]], 0 where
// the face lies on a physical edge, wrapped on a periodic axis.
//
// Replaces: gather_nbr_flat / _gather_nbr_kernel in
//   remhos_tpu/ops/pallas_kernels.py (:1280 / :1183, tables from
//   gather_nbr_flat_meta :1227).
//
// The TPU kernel reaches every neighbour inside a 3-block window of u and
// extracts the face dofs by a one-hot matrix product; both are devices of
// the TPU's block grid and matrix unit, not of the function. Here a thread
// takes the element's grid coordinates from the flat index (e = ix + nx iy +
// nx ny iz), steps one cell along the face's axis (wrapping on a periodic
// axis, writing 0 off a physical edge) and copies values of u. The copy
// moves bits, so the result equals the
// plain index gather (structured.gather_nbr_structured) bit for bit, in
// every dtype of 2, 4 or 8 bytes, and every structured layout is taken (the
// TPU meta's block-size condition does not apply).
//
// What bounds it on the H100: bytes. At N=24, p=3 in f32 it writes u_nbr
// (5.3 MB) and reads the face dofs of u it needs (at most u, 3.5 MB): ~9 MB,
// ~2.6 us at 3.35 TB/s.
//
// The first version mapped one thread to one output: per output it divided
// the flat index three times by runtime values (element, face, axis
// coordinate), selected the face's axis, and read the neighbour dof from
// global memory, so integer arithmetic, not bytes, set its time (4.5x the
// bound). This version gives each thread VEC consecutive outputs of one
// (element, face): the element, face and neighbour element are computed once
// per VEC outputs, the face's neighbour dofs come from a copy of
// nbr_dof_local in shared memory, and the VEC outputs (16 bytes where fd and
// the element size allow) leave in one vector store. The reads of u stay
// element-sized: a face's dofs are strided in the neighbour's row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block
constexpr int MAX_F = 6;   // faces of a hexahedron

struct Layout {
  int dim, nf, fd, nd, E;
  int shape[3], stride[3], periodic[3];
  int axis[MAX_F], side[MAX_F];
};

// the unsigned type of `bytes` bytes, for one vector store
template <int BYTES> struct VecT;
template <> struct VecT<2> { using type = uint16_t; };
template <> struct VecT<4> { using type = uint32_t; };
template <> struct VecT<8> { using type = uint2; };
template <> struct VecT<16> { using type = uint4; };

template <typename W, int VEC>
__global__ void __launch_bounds__(NT)
gather_nbr_kernel(const W* __restrict__ u, const int* __restrict__ nbr_dof,
                  W* __restrict__ out, const __grid_constant__ Layout L) {
  extern __shared__ int s_nbr[];                 // [nf*fd]
  const int nfd = L.nf * L.fd;
  for (int i = threadIdx.x; i < nfd; i += NT) s_nbr[i] = __ldg(nbr_dof + i);
  __syncthreads();
  // 32-bit index arithmetic (the launch checks that E * nf * fd fits)
  const int vpf = L.fd / VEC;                   // vectors per face
  const int n = L.E * L.nf * vpf;
  const int v = blockIdx.x * NT + threadIdx.x;
  if (v >= n) return;
  const int e = v / (L.nf * vpf), r = v - e * (L.nf * vpf);
  const int f = r / vpf, c = r - f * vpf;
  // the face's axis and side, then that axis's extent: selects over
  // constant indices keep the parameter arrays out of local memory
  int ax = 0, side = 0;
#pragma unroll
  for (int k = 0; k < MAX_F; ++k)
    if (k == f) { ax = L.axis[k]; side = L.side[k]; }
  int stride = 1, na = 1, per = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if (a == ax) { stride = L.stride[a]; na = L.shape[a]; per = L.periodic[a]; }
  const int co = (e / stride) % na;
  int cn = co + (side ? 1 : -1);
  bool edge = false;
  if (cn < 0 || cn >= na) {
    edge = !per;
    cn = cn < 0 ? na - 1 : 0;
  }
  union {
    W w[VEC];
    typename VecT<VEC * sizeof(W)>::type v;
  } pack;
  const int sl = f * L.fd + c * VEC;
  if (edge) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) pack.w[i] = W(0);
  } else {
    const W* un = u + (size_t)(e + (cn - co) * stride) * L.nd;
#pragma unroll
    for (int i = 0; i < VEC; ++i) pack.w[i] = un[s_nbr[sl + i]];
  }
  *reinterpret_cast<typename VecT<VEC * sizeof(W)>::type*>(
      out + (size_t)e * nfd + sl) = pack.v;
}

template <typename W, int VEC>
int launch_vec(const void* u, const void* nbr, void* out, const Layout& L,
               cudaStream_t stream) {
  const int64_t n = (int64_t)L.E * L.nf * L.fd / VEC;
  const int blocks = (int)((n + NT - 1) / NT);
  gather_nbr_kernel<W, VEC><<<blocks, NT, L.nf * L.fd * sizeof(int),
                              stream>>>(
      static_cast<const W*>(u), static_cast<const int*>(nbr),
      static_cast<W*>(out), L);
  return (int)cudaGetLastError();
}

// the widest vector of up to 16 bytes that divides fd and the output's
// alignment
template <typename W>
int launch(const void* u, const void* nbr, void* out, const Layout& L,
           cudaStream_t stream) {
  const int64_t n = (int64_t)L.E * L.nf * L.fd;
  if (n == 0) return 0;
  if (n > 0x7fffffff - NT) return -3;
  const uintptr_t a = reinterpret_cast<uintptr_t>(out);
  constexpr int VMAX = 16 / sizeof(W);
  int vec = VMAX;
  while (vec > 1 && (L.fd % vec != 0 || a % (vec * sizeof(W)) != 0)) vec /= 2;
  switch (vec) {
    case 8: if constexpr (VMAX >= 8) return launch_vec<W, 8>(u, nbr, out, L, stream);
    case 4: if constexpr (VMAX >= 4) return launch_vec<W, 4>(u, nbr, out, L, stream);
    case 2: return launch_vec<W, 2>(u, nbr, out, L, stream);
    default: return launch_vec<W, 1>(u, nbr, out, L, stream);
  }
}

}  // namespace

extern "C" {

// u[E, nd] (elements of elem_bytes = 2, 4 or 8), nbr_dof_local[nf, fd]
// (int32, on the device) -> out[E, nf*fd]. sizes: dim, nf, fd, nd, then per
// axis shape, periodic (dim each), then per face axis, side (nf each).
// Returns 0, a CUDA error code (> 0), or < 0 for a bad argument.
int remhos_gather_nbr(int elem_bytes, const void* u, const void* nbr,
                      void* out, const int* sizes, int nsizes, void* stream) {
  if (nsizes < 4) return -1;
  Layout L;
  L.dim = sizes[0]; L.nf = sizes[1]; L.fd = sizes[2]; L.nd = sizes[3];
  if (L.dim < 1 || L.dim > 3 || L.nf < 1 || L.nf > MAX_F || L.fd < 1 ||
      nsizes != 4 + 2 * L.dim + 2 * L.nf)
    return -1;
  L.E = 1;
  for (int a = 0; a < 3; ++a) {
    L.shape[a] = a < L.dim ? sizes[4 + a] : 1;
    L.periodic[a] = a < L.dim ? sizes[4 + L.dim + a] : 0;
    if (L.shape[a] < 1) return -1;
    L.stride[a] = L.E;
    L.E *= L.shape[a];
  }
  for (int f = 0; f < L.nf; ++f) {
    L.axis[f] = sizes[4 + 2 * L.dim + f];
    L.side[f] = sizes[4 + 2 * L.dim + L.nf + f];
    if (L.axis[f] < 0 || L.axis[f] >= L.dim) return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return launch<uint16_t>(u, nbr, out, L, s);
  if (elem_bytes == 4) return launch<uint32_t>(u, nbr, out, L, s);
  if (elem_bytes == 8) return launch<uint64_t>(u, nbr, out, L, s);
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
