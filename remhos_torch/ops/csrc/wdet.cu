// w_q det J at the volume quadrature points from the nodal mesh positions.
//
// Replaces: fused_wdet / _wdet_kernel in remhos_tpu/ops/pallas_kernels.py
//   (:1130 / :1110).
//
// What it computes: for every element e and volume point q the Jacobian
//   J[d][b] = sum_n xs[e, n, d] * Gm[q, n, b],
// its determinant in closed form (2x2 or 3x3) and wdet[e, q] = w_q[q] det J.
// J never reaches device memory. The face variant (remhos_wdet_face; no
// TPU counterpart: the JAX package forms these weights in XLA ops) also
// takes the nodal mesh velocity v and stores the upwind face weights of the
// non-fused remap stage,
//   wvn[e, f, fq] = w_fq[fq] max(0, v . n)
// at every point fq of every face f, n the scaled outward normal from the
// face's tangents (remhos_torch/geometry.face_normals_tangent), the points
// numbered as the dense face tables number them; neither the tangents, the
// normals nor v at the face points reach device memory.
//
// Design: the load stage of the MeshGeom provider (mesh_geom.cuh, shared
// with kernel 4) without the velocity: the tile's nodes go to shared memory,
// J comes out of axis-by-axis contractions with the 1D Gauss-Lobatto tables
// Bm1, Gm1 (~9.7k multiply-adds an element at mesh order 2 and p=3 in 3D,
// where the dense dots took ~52k), and w_q det J lands in shared memory; the
// block stores the tile's wdet rows, which are contiguous in wdet[E, Q]:
// consecutive threads write consecutive points (16-byte stores where the
// tile's rows are 16-byte aligned). The face variant stages v beside the
// nodes and runs the provider's face pass (kernel 5's: the tangents and v
// at each face's points from the face's nodes, with the face descriptors
// of ops/tables.face_descriptors), then stores the tile's wvn rows,
// contiguous in wvn[E, nf, Qf], with the weight and the upwind clamp
// applied on the way out. One tile of te = NT / Q1^(dim-1)
// elements per block (one thread per point line in the contraction pass),
// ~18 KB of shared memory in f32 at p=3: several blocks are resident on an
// SM, so one block's stores are in flight while another computes.
//
// What bounds it on the H100: bytes. At N=24, mesh order 2, p=3 in f32 it
// reads 4.5 MB of xs and writes 11.9 MB of wdet, 4.9 us at 3.35 TB/s; the
// sum-factorized arithmetic (0.31 GFLOP, 4.7 us at the f32 FMA rate) is
// just below that (utils/cost.py). The dense first version (a length-nm
// dot per Jacobian entry, ~0.7 G multiply-adds) ran 0.097 ms (f32), 0.122
// ms (f64). The face variant reads v as well and writes wvn (nf Qf an
// element, as many as wdet's Q at p=3 in 3D): 32.8 MB at N=24, 9.8 us,
// bytes again (utils/cost.wdet_cost).
//
// Tried and slower or less accurate (H100 80GB HBM3 at 700 W, 3D N=24,
// p=3): at least 4, 5, 6 or 8 resident blocks an SM by launch bounds
// (fewer registers, spills): 0.0182, 0.0182, 0.0249, 0.0792 ms f32 and
// 0.100, 0.252, 0.407, 0.612 f64 against 0.0178 and 0.0342 as shipped
// (device-paced, tools/wdet_variants.py); the nodes' absolute coordinates
// in the contractions: f32 wdet 1.6e-5 of the f32 plain version (limit
// 1e-5), where relative ones lie 3.6e-7 from the f64 evaluation
// (chip_smoke.py step 3). What holds it now: a
// block's load, two contraction passes and store run one after another
// between barriers, 4 blocks an SM (64 registers).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "mesh_geom.cuh"

namespace {

using namespace remhos;

template <typename T, int DIM, int MT, int QT, bool FACE>
struct Args {
  MeshGeom<T, DIM, MT, QT, false, FACE> g;
  T* wdet;        // [E, Q] out
  T* wvn;         // [E, nf, Qf] out (FACE)
  const T* w_fq;  // [Qf] (FACE)
  int E, Q, Qf, te;
  int o_wd, o_vn, o_scr;
};

template <typename T, int DIM, int MT, int QT, bool FACE>
__global__ void __launch_bounds__(NT)
wdet_kernel(const __grid_constant__ Args<T, DIM, MT, QT, FACE> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  MeshGeom<T, DIM, MT, QT, false, FACE> g = a.g;
  g.s_tab = sm;
  g.s_wd = sm + a.o_wd;
  g.s_scr = sm + a.o_scr;
  if constexpr (FACE) g.s_vn = sm + a.o_vn;
  g.init();
  const int e_base = blockIdx.x * a.te;
  const int ne = min(a.te, a.E - e_base);
  g.load(e_base, ne);
  __syncthreads();
  // the tile's rows are contiguous in wdet: ne * Q entries from e_base * Q
  const int n = ne * a.Q;
  const size_t o = (size_t)e_base * a.Q;
  T* out = a.wdet + o;
  const T* s_wd = g.s_wd;
  constexpr int VEC = 16 / sizeof(T);
  if ((reinterpret_cast<size_t>(out) | (size_t)n * sizeof(T)) % 16 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(s_wd);
    uint4* dst = reinterpret_cast<uint4*>(out);
    for (int i = threadIdx.x; i < n / VEC; i += NT) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < n; i += NT) out[i] = s_wd[i];
  }
  if constexpr (FACE) {
    // and in wvn: ne * nf * Qf entries from e_base * nf * Qf
    const int nfq = 2 * DIM * a.Qf;
    T* wvn = a.wvn + (size_t)e_base * nfq;
    for (int i = threadIdx.x; i < ne * nfq; i += NT) {
      const T vn = g.s_vn[i];
      wvn[i] = __ldg(a.w_fq + i % a.Qf) * (vn > T(0) ? vn : T(0));
    }
  }
}

// The shared memory of a tile of te elements: the mesh tables, wd, vn
// (FACE), the provider's scratch. Sets the offsets in *a; returns the bytes.
template <typename T, int DIM, int MT, int QT, bool FACE>
size_t layout(Args<T, DIM, MT, QT, FACE>* a, int te) {
  const int m1 = a->g.m1_, Q1 = a->g.Q1_;
  int o = al4(2 * Q1 * m1);
  a->o_wd = o;
  o += al4(te * a->Q);
  a->o_vn = o;
  if (FACE) o += al4(te * 2 * DIM * a->Qf);
  a->o_scr = o;
  o += al4(te * a->g.sx);
  return (size_t)o * sizeof(T);
}

template <typename T, int DIM, int MT, int QT, bool FACE>
int launch_as(Args<T, DIM, MT, QT, FACE>& a, cudaStream_t stream) {
  const int Q1 = a.g.Q1_;
  const int NL = DIM == 3 ? Q1 * Q1 : Q1;
  a.te = choose_te(NT / NL, SMEM_BUDGET,
                   [&](int te) { return layout(&a, te); });
  const size_t smem = layout(&a, a.te);
  if (smem > SMEM_MAX) return -3;
  const void* fn =
      reinterpret_cast<const void*>(&wdet_kernel<T, DIM, MT, QT, FACE>);
  if (smem > 48 * 1024) {
    const int rc = allow_smem(fn, smem);
    if (rc != 0) return rc;
  }
  const int blocks = (a.E + a.te - 1) / a.te;
  wdet_kernel<T, DIM, MT, QT, FACE><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The operands of a launch; v, fdesc, w_fq and wvn only with FACE.
struct Ptrs {
  const void *xs, *v, *msf, *w_q, *w_fq;
  const int* fdesc;
  void *wdet, *wvn;
};

template <typename T, int DIM, bool FACE>
int launch(const Ptrs& p, int E, int nm, int Q, int m1, int Q1,
           cudaStream_t stream) {
  if (E <= 0) return 0;
  const int rc = check_mesh_sizes(DIM, nm, Q, m1, Q1);
  if (rc != 0) return rc;
  auto fill = [&](auto& a) {
    a.g.xs = static_cast<const T*>(p.xs);
    a.g.v = static_cast<const T*>(p.v);
    a.g.msf = static_cast<const T*>(p.msf);
    a.g.w_q = static_cast<const T*>(p.w_q);
    a.g.fdesc = p.fdesc;
    a.g.mode = T(1);
    a.g.m1_ = m1;
    a.g.Q1_ = Q1;
    a.g.with_det = 1;
    a.g.sx = mesh_scratch(DIM, m1, Q1, false, FACE);
    a.g.s_tab = a.g.s_va = a.g.s_wd = a.g.s_scr = a.g.s_vn = nullptr;
    a.wdet = static_cast<T*>(p.wdet);
    a.wvn = static_cast<T*>(p.wvn);
    a.w_fq = static_cast<const T*>(p.w_fq);
    a.E = E;
    a.Q = Q;
    a.Qf = DIM == 3 ? Q1 * Q1 : Q1;
  };
  constexpr int X = DIM == 3 ? 2 : 1;
  switch (mesh_size_case(DIM, m1, Q1)) {
    case 3 + X: { Args<T, DIM, 3, 3 + X, FACE> a; fill(a); return launch_as(a, stream); }
    case 4 + X: { Args<T, DIM, 3, 4 + X, FACE> a; fill(a); return launch_as(a, stream); }
    case 5 + X: { Args<T, DIM, 3, 5 + X, FACE> a; fill(a); return launch_as(a, stream); }
    default: { Args<T, DIM, 0, 0, FACE> a; fill(a); return launch_as(a, stream); }
  }
}

template <bool FACE>
int dispatch(int dtype_bytes, int dim, const Ptrs& p, const int* sizes,
             int nsizes, void* stream) {
  if (nsizes != 5) return -1;
  const int E = sizes[0], nm = sizes[1], Q = sizes[2], m1 = sizes[3],
            Q1 = sizes[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REMHOS_WD(T, D) return launch<T, D, FACE>(p, E, nm, Q, m1, Q1, s)
  if (dtype_bytes == 4 && dim == 3) REMHOS_WD(float, 3);
  if (dtype_bytes == 8 && dim == 3) REMHOS_WD(double, 3);
  if (dtype_bytes == 4 && dim == 2) REMHOS_WD(float, 2);
  if (dtype_bytes == 8 && dim == 2) REMHOS_WD(double, 2);
#undef REMHOS_WD
  return -2;
}

}  // namespace

extern "C" {

// xs[E, nm, dim], msf (the packed mesh tables, ops/tables.MESH_TABLES),
// w_q[Q] -> wdet[E, Q]; sizes: E, nm, Q, m1, Q1 (m1 nodes and Q1 points
// per axis). Returns 0, a CUDA error code (> 0), or < 0 for a bad argument
// (-1: sizes; -2: type or dimension; -3: shared memory; -5: not a
// tensor-product element within DMAX, QMAX).
int remhos_wdet(int dtype_bytes, int dim, const void* xs, const void* msf,
                const void* w_q, void* wdet, const int* sizes, int nsizes,
                void* stream) {
  const Ptrs p{xs, nullptr, msf, w_q, nullptr, nullptr, wdet, nullptr};
  return dispatch<false>(dtype_bytes, dim, p, sizes, nsizes, stream);
}

// The face variant: also the nodal mesh velocity v[E, nm, dim], the face
// descriptors fdesc (int32 [2 dim, 5], ops/tables.face_descriptors) and the
// face weights w_fq[Qf] -> wvn[E, 2 dim, Qf] as well as wdet. Sizes and
// return codes as remhos_wdet's.
int remhos_wdet_face(int dtype_bytes, int dim, const void* xs, const void* v,
                     const void* msf, const void* w_q, const int* fdesc,
                     const void* w_fq, void* wdet, void* wvn,
                     const int* sizes, int nsizes, void* stream) {
  const Ptrs p{xs, v, msf, w_q, w_fq, fdesc, wdet, wvn};
  return dispatch<true>(dtype_bytes, dim, p, sizes, nsizes, stream);
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
