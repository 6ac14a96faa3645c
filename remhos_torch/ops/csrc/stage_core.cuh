// The shared core of the HO remap stage kernels, sum-factorized.
//
// Counterpart of _poly_stage_core and _mass_based_avg_core in
// remhos_tpu/ops/pallas_kernels.py (:578, :683), which _stage_ho_poly_kernel
// and _stage_mega_kernel share there, and of the body of _stage_ho_kernel
// (:265); here stage_ho.cu, mega_stage.cu, stage_ho_nodes.cu and (with
// n_cg == 0 and no face flux, the volume action alone) geom_conv.cu share
// stage_core(), the first two element_sums(), and gl_cg.cu (kernel 6) its
// passes: axis_pass, chain_dd (steps 4 and 6), gl_mass_action (step 5's
// M_gl x) and warp_sum.
//
// stage_core computes, for one tile of te elements (nd = D^dim dofs,
// Q = Q1^dim volume and FQ = nf Q1^(dim-1) face points per element):
//   0. loads the tile's u and u_nbr (and whatever the geometry provider
//      stages in shared memory);
//   1. reference gradients of u at the volume points;
//   2. from the geometry provider G, per volume point va_b (the convective
//      velocity adj(J)^T v, times the volume sign) and w_q det J, per face
//      point the normal velocity vn (times the flux mode); the volume
//      integrand and the DG upwind face flux max(0, vn) (u_nbr - u_own);
//   3. Ku: the volume part, plus the face flux scattered to the face dofs;
//      with need_ml also the lumped mass ml = wdet Bu;
//   4. b = Ku A and the Jacobi diagonal of the GL mass matrix;
//   5. n_cg Jacobi sweeps x += D^-1 (b - M_gl x);
//   6. du_HO = x A^T.
// With n_cg == 0 it stops after step 3 and returns Ku; with with_face == 0
// it skips the face flux (a phase ablation of kernel 5).
//
// Two geometry providers:
//   PolyGeom  (kernels 1 and 2): va_b, w_q det J and vn by Horner's rule
//             from the t-polynomial coefficients P = [VA | WDET | VN]
//             (ops/tables.py); remap sign and mode +1. Bound by P's bytes.
//             PolyGeom<float, DIM, true> (the JAX package's poly_bf16):
//             VA | VN come from a bf16 array P16 and P holds WDET alone;
//             each bf16 value is converted to f32 before any arithmetic (no
//             bf16 FMA, no tensor core), and w_q det J, so the lumped mass
//             and the LO average, stays true f32. Kernels 1 and 2 compile
//             it as instances of their own (f32 only).
//   MeshGeom  (kernels 4 and 5; its load() alone is kernel 3;
//             mesh_geom.cuh): from the nodes xs and the nodal velocity v of
//             the tile, sum-factorized on the 1D mesh tables: load()
//             contracts the staged nodes axis by axis into va and w_q det J
//             at the volume points and (kernel 5) vn at the face points, in
//             shared memory; volume() and face() read one point. It took
//             the place of kernel 5's dense NodeGeom (a length-nm dot with
//             a table load per Jacobian or tangent entry at every point:
//             0.29 of that kernel's 0.43 ms at p=3, f32, 24^3).
// A provider has load() (step 0), volume() and face() (step 2).
//
// What bounds the core on the H100. The first version contracted with the
// dense tables (GuT [nd, dim Q], Buw, A, AT, Bgl, BglT, Bgl2): ~143k
// multiply-adds per element at p=3 in 3D with one Jacobi sweep, each with a
// shared-memory load, and every block of 8 elements streamed ~0.5 MB of
// tables from L2; it ran at 12x the byte bound that P sets (191 of the 207
// MB a launch of kernel 1 moves at N=24 in f32).
//
// What this design does about it (sum factorization): the fused family runs
// only on tensor-product elements, so every table is a Kronecker product of
// one 1D table per axis (ops/tables.sum_factor_tables), and every
// contraction of steps 1-6 runs axis by axis, ~25k multiply-adds per element.
//   - The 1D tables (a few hundred entries) are staged in shared memory once
//     per block; the blocks are persistent (one grid of SMs x resident
//     blocks, each walking over tiles), so they are read once per block.
//   - A contraction pass gives one thread one line of one element: it reads
//     the line's K inputs into registers and writes its M outputs, each a
//     K-term dot with one row of a 1D table read as a warp-wide broadcast.
//     Lines are numbered fastest within an element, the arrays are
//     element-major ([te][len]), so a warp works on consecutive lines.
//   - The last gradient contraction is fused with the pointwise phase and
//     the first transposed contraction: one thread per point line along the
//     last axis holds the line's gradient, va, wdet and integrand in
//     registers and writes the volume integrand, the Jacobi diagonal and ml
//     already contracted along that axis, so grad u and the integrand never
//     reach shared memory. The Jacobi sweep fuses the same way (Bgl, wdet,
//     Bgl^T along the last axis in one pass).
//   - P is read once, straight from global memory in the pointwise passes:
//     the threads of a warp hold consecutive points of one element, so each
//     coefficient segment is read coalesced. The resident blocks (3 an SM in
//     f32, 2 in f64) overlap one tile's P stream with another's
//     contractions. Tried on an H100 and slower, so not used: staging each
//     tile's P in shared memory with cp.async, the next tile's while this
//     one computes (the staged P takes the shared memory of half the
//     resident elements: 13.8 KB an element in f32 at p=3); a bulk L2
//     prefetch of each block's next tile (cp.async.bulk.prefetch.L2); one
//     or two blocks an SM with twice the tile.
//   - The 1D sizes are template parameters for p = 2..4 (D = p + 1, Q1 the
//     rule's points per axis: every loop unrolls, every line stays in
//     registers); every other size runs the same code with runtime sizes up
//     to D = DMAX, Q1 = QMAX (`DT = QT = 0`).
//   - Plain FMA in the working type: no bf16 splitting, no TF32, no tensor
//     cores (the GL<->Bernstein transforms have kappa ~4.3e4 and the LO and
//     lumped-mass sums decide conservation); every sum in a fixed order.
// What still bounds it: the P stream is not hidden behind the contractions
// (the blocks of an SM reach their pointwise passes together), and a pass's
// table rows are shared-memory loads. Left for later: a schedule that overlaps P with compute inside a
// block (warp-specialized TMA producers), the tables as constant-bank
// operands, TMA multicast across a cluster, wgmma-based schemes that keep
// f32 accuracy, and folding the neighbour gather into the element window.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

namespace remhos {

constexpr int NT = 256;               // threads per block
constexpr int NWARPS = NT / 32;
// the largest 1D sizes the runtime-size instantiation takes
constexpr int DMAX = 8, QMAX = 12;
// blocks per SM the stage kernels leave registers for: 3 in f32 (at most 85
// registers a thread), 2 in f64 (128), the faster of 1-3 on an H100
template <typename T>
constexpr int min_blocks() {
  return sizeof(T) == 4 ? 3 : 2;
}

__device__ __forceinline__ float fmaT(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmaT(double a, double b, double c) {
  return fma(a, b, c);
}

// The sum of v over the 32 lanes of a warp, in a fixed order (a butterfly):
// every lane gets it.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[e] = sum_{j < n} f(j, e) for e < te, one warp per element, fixed
// order (the lanes' strided partial sums, then a butterfly).
template <typename T, typename F>
__device__ __forceinline__ void element_sums(int te, int n, F f, T* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < te; e += NWARPS) {
    T s = T(0);
    for (int j = lane; j < n; j += 32) s += f(j, e);
    s = warp_sum(s);
    if (lane == 0) out[e] = s;
  }
}

// ---------------------------------------------------------------------------
// Launch configuration, per kernel and device, made once.

// Per (kernel, device), made once: the dynamic shared memory the kernel is
// allowed (cudaFuncSetAttribute, called only when a launch needs more than
// before) and its resident blocks per SM at the size last asked.
struct LaunchSlot {
  const void* fn;
  int dev, occ;
  size_t allowed, occ_smem;
};

// The slot of (fn, current device) with `smem` allowed; nullptr and *err
// set on a failure.
inline LaunchSlot* launch_slot(const void* fn, size_t smem, int* err) {
  static std::mutex mu;
  static LaunchSlot slots[256];
  static int n_slots = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) { *err = (int)e; return nullptr; }
  std::lock_guard<std::mutex> lock(mu);
  LaunchSlot* s = nullptr;
  for (int i = 0; i < n_slots; ++i)
    if (slots[i].fn == fn && slots[i].dev == dev) s = &slots[i];
  if (s == nullptr) {
    if (n_slots == 256) { *err = -6; return nullptr; }
    s = &slots[n_slots++];
    *s = LaunchSlot{fn, dev, 0, 0, 0};
  }
  if (smem > s->allowed) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) { *err = (int)e; return nullptr; }
    s->allowed = smem;
  }
  *err = 0;
  return s;
}

// Allow a kernel `smem` bytes of dynamic shared memory. Returns 0 or a CUDA
// error code.
inline int allow_smem(const void* fn, size_t smem) {
  int err = 0;
  launch_slot(fn, smem, &err);
  return err;
}

// Allow `smem` and set *grid to the persistent grid of a kernel with `tiles`
// tiles: min(tiles, SMs x resident blocks). Returns 0 or an error code.
inline int persistent_grid(const void* fn, size_t smem, int tiles,
                           int* grid) {
  static int sms[64];
  int err = 0;
  LaunchSlot* s = launch_slot(fn, smem, &err);
  if (s == nullptr) return err;
  if (s->dev < 0 || s->dev >= 64) return -6;
  if (s->occ == 0 || s->occ_smem != smem) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s->occ, fn, NT, smem);
    if (e != cudaSuccess) return (int)e;
    if (s->occ < 1) return -3;
    s->occ_smem = smem;
  }
  if (sms[s->dev] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &sms[s->dev], cudaDevAttrMultiProcessorCount, s->dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long cap = (long)sms[s->dev] * s->occ;
  *grid = (int)(tiles < cap ? tiles : cap);
  return 0;
}

// The dynamic shared memory of a kernel whose smem grows with the tile:
// the largest te <= te_max whose bytes(te) fit in `budget`, at least 1.
template <typename F>
inline int choose_te(int te_max, size_t budget, F bytes) {
  int te = te_max < 1 ? 1 : te_max;
  while (te > 1 && bytes(te) > budget) --te;
  return te;
}

// ---------------------------------------------------------------------------
// The sum-factorized core.

// The 1D sizes, compile-time where DT, QT are nonzero.
template <int DT, int QT>
struct Sizes1D {
  static constexpr int DM = DT ? DT : DMAX;   // register extents
  static constexpr int QM = QT ? QT : QMAX;
  int D_, Q1_;
  __device__ __forceinline__ int D() const { return DT ? DT : D_; }
  __device__ __forceinline__ int Q1() const { return QT ? QT : Q1_; }
};

// What the core reads besides the geometry: the stage's operands, the
// packed 1D tables and the face index tables.
template <typename T>
struct CoreArgs {
  const T* u;       // [E, nd]
  const T* unbr;    // [E, nf*fd] face-neighbour dofs, 0 on physical edges
  const T* sf;      // the 1D tables: B1, G1, Bw1, Bgl1, Bgl21, Bf1, wBf1
                    // ([Q1, D] each), A1 [D, D] (ops/tables.SF_TABLES)
  const int* bdr;        // [nf, fd]
  const int* dof_faces;  // [nd, DIM] face-dof slots of each dof, -1 padded
  int E, nd, Q, Qf, nf, fd, n_cg, D, Q1;
  int with_face;    // 0: no face flux (kernel 5's phase ablation)
  int need_ml;      // also the lumped mass ml = wdet Bu
  int te;           // elements per tile
};

// Offsets, in entries of T, of the core's shared arrays. The 1D tables come
// first; every per-element array X is [te][len_X], each starting on a
// 4-entry boundary. A, B and C are scratch, reused pass by pass.
struct CoreLayout {
  int tab, u, un, wdet, inv, b, x, ml, ku, cf, A, B, C, end;
};

__host__ __device__ inline int al4(int n) { return (n + 3) & ~3; }

// volume_only: the layout of a core run with with_face == 0, n_cg == 0 and
// need_ml == 0 (kernel 4), which never touches un, cf, b, x and ml: they
// take no room there, and the scratch no face room. with_ml false: ml takes
// no room (a run with need_ml == 0).
__host__ __device__ inline CoreLayout core_layout(int dim, int D, int Q1,
                                                  int nf, int te,
                                                  bool volume_only = false,
                                                  bool with_ml = true) {
  const int V = dim == 3 ? D * D * D : D * D;
  const int Qv = dim == 3 ? Q1 * Q1 * Q1 : Q1 * Q1;
  const int DF = dim == 3 ? D : 1;              // face-dof lines per face
  const int NFD = volume_only ? 0 : nf * D * DF;
  const int S1 = Q1 * (dim == 3 ? D * D : D);   // one axis at the points
  const int S2 = dim == 3 ? Q1 * Q1 * D : S1;   // two axes
  const int FT = volume_only ? 0 : nf * Q1 * DF;  // a face, one axis
  const int VS = volume_only ? 0 : V;           // the sweeps'
  const int MS = with_ml ? VS : 0;              // ml's
  const int sA = 3 * S1 > 2 * S1 + FT ? 3 * S1 : 2 * S1 + FT;
  CoreLayout L;
  int o = 0;
  L.tab = o; o += al4(7 * Q1 * D + D * D);
  L.u = o; o += al4(te * V);
  L.un = o; o += al4(te * NFD);
  L.wdet = o; o += al4(te * Qv);
  L.inv = o; o += al4(te * V);
  L.b = o; o += al4(te * VS);
  L.x = o; o += al4(te * VS);
  L.ml = o; o += al4(te * MS);
  L.ku = o; o += al4(te * V);
  L.cf = o; o += al4(te * NFD);
  L.A = o; o += al4(te * (sA > V ? sA : V));
  L.B = o; o += al4(te * (3 * S2 + FT > V ? 3 * S2 + FT : V));
  L.C = o; o += al4(te * 3 * S2);
  L.end = o;
  return L;
}

// The 1D tables in shared memory ([Q1][D] each, A1 [D][D]).
template <typename T>
struct Tab1D {
  const T *B, *G, *Bw, *Bgl, *Bgl2, *Bf, *wBf, *A;
};

template <typename T>
__device__ __forceinline__ Tab1D<T> tab1d(const T* s, int D, int Q1) {
  const int n = Q1 * D;
  return Tab1D<T>{s, s + n, s + 2 * n, s + 3 * n, s + 4 * n, s + 5 * n,
                  s + 6 * n, s + 7 * n};
}

// Stage the packed 1D tables sf in shared memory at dst (once per block;
// the caller places the barrier).
template <typename T>
__device__ __forceinline__ void stage_tables(const T* sf, int D, int Q1,
                                             T* dst) {
  const int n = 7 * Q1 * D + D * D;
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = __ldg(sf + i);
}

template <typename T>
__device__ __forceinline__ void load_tables(const CoreArgs<T>& a, T* sm,
                                            const CoreLayout& L) {
  stage_tables(a.sf, a.D, a.Q1, sm + L.tab);
}

// One contraction pass over the tile along axis AX of arrays [n2][n1][n0]
// (axis 0 fastest; the extent along AX is the input's K): for the NO
// triples (in[o], tab[o], store o), every line of every element e < te gets
// out[m] = sum_k T_o(m, k) x[k], with T_o(m, k) = tab[o][m*K + k] (forward,
// TR false) or tab[o][k*M + m] (transposed, TR true). KM/MM bound K/M at
// compile time. store(o, e, off, value) writes output entry `off` (in the
// output array, whose extent along AX is M) of element e.
template <typename T, int AX, int KM, int MM, bool TR, int NO, typename St>
__device__ __forceinline__ void axis_pass(int te, int n0, int n1, int n2,
                                          int M, const T* const (&in)[NO],
                                          int ies, const T* const (&tab)[NO],
                                          St store) {
  const int K = AX == 0 ? n0 : (AX == 1 ? n1 : n2);
  const int L0 = AX == 0 ? n1 : n0;             // the other two axes
  const int L1 = AX == 2 ? n1 : n2;
  const int s0 = AX == 0 ? n0 : 1;              // their input strides
  const int s1 = AX == 2 ? n0 : n0 * n1;
  const int sK = AX == 0 ? 1 : (AX == 1 ? n0 : n0 * n1);
  const int m0 = AX == 0 ? M : n0;              // output extents
  const int m1 = AX == 1 ? M : n1;
  const int t0 = AX == 0 ? m0 : 1;              // output strides
  const int t1 = AX == 2 ? m0 : m0 * m1;
  const int tM = AX == 0 ? 1 : (AX == 1 ? m0 : m0 * m1);
  const int nl = L0 * L1;
  for (int idx = threadIdx.x; idx < te * nl; idx += NT) {
    const int e = idx / nl, l = idx - e * nl;
    const int lb = l / L0, la = l - lb * L0;
    const int ib = e * ies + la * s0 + lb * s1;
    const int ob = la * t0 + lb * t1;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      T x[KM];
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K) x[k] = in[o][ib + k * sK];
#pragma unroll
      for (int m = 0; m < MM; ++m) {
        if (m < M) {
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < KM; ++k)
            if (k < K)
              acc = fmaT(x[k], TR ? tab[o][k * M + m] : tab[o][m * K + k], acc);
          store(o, e, ob + m * tM, acc);
        }
      }
    }
  }
}

// The plain store of a pass: out[o][e * oes + off] = v.
template <typename T, int NO>
struct Store {
  T* const* out;
  int oes;
  __device__ __forceinline__ void operator()(int o, int e, int off, T v) const {
    out[o][e * oes + off] = v;
  }
};

// x contracted with the D x D table tab1 along every axis, for the te
// elements of arrays [te][D^DIM]: the forward use of tab1 (T(m, k) =
// tab1[m*D + k]) or, with TR, the transposed one. The passes go through the
// scratch sA, sB ([te][D^DIM] each) with a barrier after each but the last,
// whose store is `last` (store(o, e, off, value), off < D^DIM).
template <typename T, int DIM, int DM, bool TR, typename St>
__device__ __forceinline__ void chain_dd(int te, int D, const T* x,
                                         const T* tab1, T* sA, T* sB,
                                         St last) {
  const int V = DIM == 3 ? D * D * D : D * D;
  const int n2 = DIM == 3 ? D : 1;
  const T* in0[1] = {x};
  const T* tb0[1] = {tab1};
  T* oA[1] = {sA};
  axis_pass<T, 0, DM, DM, TR, 1>(te, D, D, n2, D, in0, V, tb0,
                                 Store<T, 1>{oA, V});
  __syncthreads();
  const T* in1[1] = {sA};
  if constexpr (DIM == 3) {
    T* oB[1] = {sB};
    axis_pass<T, 1, DM, DM, TR, 1>(te, D, D, D, D, in1, V, tb0,
                                   Store<T, 1>{oB, V});
    __syncthreads();
    const T* in2[1] = {sB};
    axis_pass<T, 2, DM, DM, TR, 1>(te, D, D, D, D, in2, V, tb0, last);
  } else {
    axis_pass<T, 1, DM, DM, TR, 1>(te, D, D, 1, D, in1, V, tb0, last);
  }
}

// The GL mass action M_gl x = Bgl^T (wdet (Bgl x)) for the te elements of x
// [te][D^DIM], wdet w [te][Q1^DIM], Bgl the 1D table [Q1][D]: Bgl forward
// along every axis but the last; along the last one forward, times wdet
// and back in one pass (one thread per point line holds the line in
// registers); then back along the other axes. Scratch: sA [te][S1], sB and
// sC [te][S2] (S1 = Q1 D^(DIM-1); S2 = Q1^2 D in 3D, S1 in 2D). A barrier
// after each pass but the last, whose store is `last` (store(o, e, off,
// value), off < D^DIM).
template <typename T, int DIM, int DM, int QM, typename St>
__device__ __forceinline__ void gl_mass_action(int te, int D, int Q1,
                                               const T* x, const T* w,
                                               const T* Bgl, T* sA, T* sB,
                                               T* sC, St last) {
  const int V = DIM == 3 ? D * D * D : D * D;
  const int Qv = DIM == 3 ? Q1 * Q1 * Q1 : Q1 * Q1;
  const int S1 = Q1 * (DIM == 3 ? D * D : D);
  const int S2 = DIM == 3 ? Q1 * Q1 * D : S1;
  const int NL = DIM == 3 ? Q1 * Q1 : Q1;       // point lines, last axis
  const int n2 = DIM == 3 ? D : 1;
  const T* tab[1] = {Bgl};
  {
    const T* in[1] = {x};
    T* out[1] = {sA};
    axis_pass<T, 0, DM, QM, false, 1>(te, D, D, n2, Q1, in, V, tab,
                                      Store<T, 1>{out, S1});
  }
  __syncthreads();
  const T* ylast = sA;               // [NL][D] per element
  if constexpr (DIM == 3) {
    const T* in[1] = {sA};
    T* out[1] = {sB};
    axis_pass<T, 1, DM, QM, false, 1>(te, Q1, D, D, Q1, in, S1, tab,
                                      Store<T, 1>{out, S2});
    __syncthreads();
    ylast = sB;
  }
  {
    const int ies = DIM == 3 ? S2 : S1;
    for (int idx = threadIdx.x; idx < te * NL; idx += NT) {
      const int e = idx / NL, l = idx - e * NL;
      T xl[DM], y[QM];
#pragma unroll
      for (int k = 0; k < DM; ++k)
        if (k < D) xl[k] = ylast[e * ies + l + NL * k];
#pragma unroll
      for (int q = 0; q < QM; ++q)
        if (q < Q1) {
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < DM; ++k)
            if (k < D) acc = fmaT(xl[k], Bgl[q * D + k], acc);
          y[q] = acc * w[e * Qv + l + NL * q];
        }
#pragma unroll
      for (int k = 0; k < DM; ++k)
        if (k < D) {
          T acc = T(0);
#pragma unroll
          for (int q = 0; q < QM; ++q)
            if (q < Q1) acc = fmaT(y[q], Bgl[q * D + k], acc);
          sC[e * ies + l + NL * k] = acc;
        }
    }
  }
  __syncthreads();
  if constexpr (DIM == 3) {
    const T* in[1] = {sC};
    T* out[1] = {sA};
    axis_pass<T, 1, QM, DM, true, 1>(te, Q1, Q1, D, D, in, S2, tab,
                                     Store<T, 1>{out, S1});
    __syncthreads();
    const T* in0[1] = {sA};
    axis_pass<T, 0, QM, DM, true, 1>(te, Q1, D, D, D, in0, S1, tab, last);
  } else {
    const T* in0[1] = {sC};
    axis_pass<T, 0, QM, DM, true, 1>(te, Q1, D, 1, D, in0, S1, tab, last);
  }
}

// Step 2's geometry from the t-polynomial coefficients P[E, width] (layout
// ops/tables.poly_layout): va_b, w_q det J and vn by Horner's rule at t.
// BF16 (float only): P is [E, NKD Q] (WDET) and P16 the bf16
// [E, NKV DIM Q + NKN FQ] = [VA | VN] (ops/tables.poly16_layout). A
// compile-time choice: a branch per point on a runtime pointer cost kernels
// 1 and 2 ~7% on an H100 (PERF.md, PR 13).
template <typename T, int DIM, bool BF16 = false>
struct PolyGeom {
  static constexpr int NKV = DIM, NKD = DIM + 1, NKN = DIM;
  const T* P;
  const __nv_bfloat16* P16;
  T t;
  int Q, FQ;

  __device__ __forceinline__ void load(int, int) const {}

  __device__ __forceinline__ const T* row(int eg) const {
    return P + (size_t)eg * ((NKV * DIM + NKD) * Q + NKN * FQ);
  }

  __device__ __forceinline__ const __nv_bfloat16* row16(int eg) const {
    return P16 + (size_t)eg * (NKV * DIM * Q + NKN * FQ);
  }

  // Horner's rule over n coefficients at stride s from c (the highest
  // degree last), in T
  template <int N, typename S>
  __device__ __forceinline__ T horner(const S* c, int s) const {
    T acc = ld(c + (N - 1) * s);
#pragma unroll
    for (int k = N - 2; k >= 0; --k) acc = ld(c + k * s) + t * acc;
    return acc;
  }
  __device__ __forceinline__ static T ld(const T* p) { return __ldg(p); }
  __device__ __forceinline__ static T ld(const __nv_bfloat16* p) {
    return T(__bfloat162float(__ldg(p)));
  }

  // va[b] and w_q det J at volume point q of element eg
  __device__ __forceinline__ void volume(int, int eg, int q, T* va,
                                         T& wd) const {
    if constexpr (BF16) {
      const __nv_bfloat16* Pe = row16(eg);
#pragma unroll
      for (int b = 0; b < DIM; ++b) va[b] = horner<NKV>(Pe + b * Q + q, DIM * Q);
      wd = horner<NKD>(P + (size_t)eg * NKD * Q + q, Q);
    } else {
      const T* Pe = row(eg);
#pragma unroll
      for (int b = 0; b < DIM; ++b)
        va[b] = horner<NKV>(Pe + b * Q + q, DIM * Q);
      wd = horner<NKD>(Pe + NKV * DIM * Q + q, Q);
    }
  }

  // the upwind normal velocity at face point fq of element eg
  __device__ __forceinline__ T face(int, int eg, int fq) const {
    if constexpr (BF16)
      return horner<NKN>(row16(eg) + NKV * DIM * Q + fq, FQ);
    else
      return horner<NKN>(row(eg) + (NKV * DIM + NKD) * Q + fq, FQ);
  }
};

// Steps 0-6 above for the tile of ne <= te elements starting at e_base, with
// the geometry of provider g and the 1D tables already in shared memory.
// Returns the shared array [te][nd] that holds the result: du_HO, or Ku when
// n_cg == 0; with need_ml, sm + L.ml holds ml. The result is NOT followed by
// a barrier: the caller calls __syncthreads() before it reads it. Elements
// e >= ne of the tile hold u = 0 and wdet = 1, so every division is finite.
// After the core, the arrays at L.b, L.inv and L.x are free for the caller.
template <typename T, int DIM, int DT, int QT, typename G>
__device__ __forceinline__ T* stage_core(const CoreArgs<T>& a, const G& g,
                                         T* sm, const CoreLayout& L,
                                         int e_base, int ne) {
  using SZ = Sizes1D<DT, QT>;
  constexpr int DM = SZ::DM, QM = SZ::QM;
  const SZ sz{a.D, a.Q1};
  const int D = sz.D(), Q1 = sz.Q1();
  const int te = a.te;
  const int V = DIM == 3 ? D * D * D : D * D;
  const int Qv = DIM == 3 ? Q1 * Q1 * Q1 : Q1 * Q1;
  const int DF = DIM == 3 ? D : 1;
  const int fd = D * DF, NFD = a.nf * fd, nf = a.nf;
  const int S1 = Q1 * (DIM == 3 ? D * D : D);
  const int S2 = DIM == 3 ? Q1 * Q1 * D : S1;
  const int FT = nf * Q1 * DF;
  const int NL = DIM == 3 ? Q1 * Q1 : Q1;       // point lines, last axis
  const int FS = Q1 * DF;                       // a face, one axis
  const int Qf = DIM == 3 ? Q1 * Q1 : Q1;       // face points per face
  const bool face = a.with_face != 0;
  const Tab1D<T> tb = tab1d<T>(sm + L.tab, D, Q1);
  T* s_u = sm + L.u;
  T* s_un = sm + L.un;
  T* s_w = sm + L.wdet;
  T* s_inv = sm + L.inv;
  T* s_b = sm + L.b;
  T* s_x = sm + L.x;
  T* s_ml = sm + L.ml;
  T* s_ku = sm + L.ku;
  T* s_cf = sm + L.cf;
  T* sA = sm + L.A;
  T* sB = sm + L.B;
  T* sC = sm + L.C;
  const int tid = threadIdx.x;

  // 0. the tile's u and u_nbr (contiguous rows), and the provider's rows
  {
    const T* ug = a.u + (size_t)e_base * a.nd;
    for (int i = tid; i < te * V; i += NT) s_u[i] = i < ne * V ? ug[i] : T(0);
    if (face) {
      const T* ng = a.unbr + (size_t)e_base * NFD;
      for (int i = tid; i < te * NFD; i += NT)
        s_un[i] = i < ne * NFD ? ng[i] : T(0);
    }
  }
  g.load(e_base, ne);
  __syncthreads();

  // 1a. gradient, axis 0: t1B = B u, t1G = G u [Q1, D(, D)]; face: the
  // difference u_nbr - u_own per face, along its first axis: ft1 [nf][Q1
  // x DF]
  T* t1B = sA;
  T* t1G = sA + te * S1;
  T* ft1 = sA + 2 * te * S1;
  {
    const T* in[2] = {s_u, s_u};
    const T* tab[2] = {tb.B, tb.G};
    T* out[2] = {t1B, t1G};
    axis_pass<T, 0, DM, QM, false, 2>(te, D, D, DIM == 3 ? D : 1, Q1, in, V,
                                      tab, Store<T, 2>{out, S1});
  }
  if (face) {
    const int nl = nf * DF;
    for (int idx = tid; idx < te * nl; idx += NT) {
      const int e = idx / nl, l = idx - e * nl;
      const int f = l / DF, i1 = l - f * DF;
      T x[DM];
#pragma unroll
      for (int k = 0; k < DM; ++k)
        if (k < D) {
          const int sl = f * fd + k + D * i1;
          x[k] = s_un[e * NFD + sl] - s_u[e * V + __ldg(a.bdr + sl)];
        }
#pragma unroll
      for (int q = 0; q < QM; ++q)
        if (q < Q1) {
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < DM; ++k)
            if (k < D) acc = fmaT(x[k], tb.Bf[q * D + k], acc);
          ft1[e * FT + f * FS + q + Q1 * i1] = acc;
        }
    }
  }
  __syncthreads();

  // 1b. (3D) gradient, axis 1: t2BB, t2BG (from t1B), t2GB (from t1G)
  // [Q1, Q1, D]; face: the second face axis at the face points, the upwind
  // flux, and its weighted transpose along that axis: fr [nf][Q1 x DF]
  T* t2BB = sB;
  T* t2BG = sB + te * S2;
  T* t2GB = sB + 2 * te * S2;
  T* fr = sB + 3 * te * S2;
  if constexpr (DIM == 3) {
    const T* in[3] = {t1B, t1B, t1G};
    const T* tab[3] = {tb.B, tb.G, tb.B};
    T* out[3] = {t2BB, t2BG, t2GB};
    axis_pass<T, 1, DM, QM, false, 3>(te, Q1, D, D, Q1, in, S1, tab,
                                      Store<T, 3>{out, S2});
  }
  auto face_flux = [&]() {
    const int nl = nf * Q1;
    for (int idx = tid; idx < te * nl; idx += NT) {
      const int e = idx / nl, l = idx - e * nl;
      const int f = l / Q1, q0 = l - f * Q1;
      const T* ft = ft1 + e * FT + f * FS;
      T* frl = fr + e * FT + f * FS;
      if constexpr (DIM == 3) {
        T x[DM], fl[QM];
#pragma unroll
        for (int k = 0; k < DM; ++k)
          if (k < D) x[k] = ft[q0 + Q1 * k];
#pragma unroll
        for (int q1 = 0; q1 < QM; ++q1)
          if (q1 < Q1) {
            T val = T(0);
#pragma unroll
            for (int k = 0; k < DM; ++k)
              if (k < D) val = fmaT(x[k], tb.Bf[q1 * D + k], val);
            T up = T(0);
            if (e < ne) {
              const T vn = g.face(e, e_base + e, f * Qf + q0 + Q1 * q1);
              up = vn > T(0) ? vn : T(0);
            }
            fl[q1] = up * val;
          }
#pragma unroll
        for (int k = 0; k < DM; ++k)
          if (k < D) {
            T acc = T(0);
#pragma unroll
            for (int q1 = 0; q1 < QM; ++q1)
              if (q1 < Q1) acc = fmaT(fl[q1], tb.wBf[q1 * D + k], acc);
            frl[q0 + Q1 * k] = acc;
          }
      } else {
        T up = T(0);
        if (e < ne) {
          const T vn = g.face(e, e_base + e, f * Qf + q0);
          up = vn > T(0) ? vn : T(0);
        }
        frl[q0] = up * ft[q0];
      }
    }
  };
  if constexpr (DIM == 3) {
    if (face) face_flux();
    __syncthreads();
  }

  // 2. the pointwise pass, one thread per point line along the last axis:
  // the last gradient contraction, va and w_q det J from the provider, the
  // integrand, then the transposed contraction of the integrand (Bw), of
  // wdet (Bgl^2: the Jacobi diagonal) and, with need_ml, of wdet (B: ml)
  // along the last axis: kv, kd, km [NL][D] in C. wdet goes to shared memory
  // for the sweeps. (2D: the face flux runs here.)
  T* kv = sC;
  T* kd = sC + te * S2;
  T* km = sC + 2 * te * S2;
  {
    // gradient component b from gin[b] with the last-axis table gtab[b]
    const T* gin[DIM];
    const T* gtab[DIM];
    if constexpr (DIM == 3) {
      gin[0] = t2GB; gin[1] = t2BG; gin[2] = t2BB;
      gtab[0] = tb.B; gtab[1] = tb.B; gtab[2] = tb.G;
    } else {
      gin[0] = t1G; gin[1] = t1B;
      gtab[0] = tb.B; gtab[1] = tb.G;
    }
    const int ies = DIM == 3 ? S2 : S1;
    const bool need_ml = a.need_ml != 0;
    for (int idx = tid; idx < te * NL; idx += NT) {
      const int e = idx / NL, l = idx - e * NL;
      T gl[DIM][DM];
#pragma unroll
      for (int b = 0; b < DIM; ++b)
#pragma unroll
        for (int k = 0; k < DM; ++k)
          if (k < D) gl[b][k] = gin[b][e * ies + l + NL * k];
      T dq[QM], wq[QM];
#pragma unroll
      for (int q = 0; q < QM; ++q)
        if (q < Q1) {
          T gr[DIM];
#pragma unroll
          for (int b = 0; b < DIM; ++b) {
            T acc = T(0);
#pragma unroll
            for (int k = 0; k < DM; ++k)
              if (k < D) acc = fmaT(gl[b][k], gtab[b][q * D + k], acc);
            gr[b] = acc;
          }
          const int qp = l + NL * q;
          T duq = T(0), wd = T(1);
          if (e < ne) {
            T va[DIM];
            g.volume(e, e_base + e, qp, va, wd);
#pragma unroll
            for (int b = 0; b < DIM; ++b)
              duq = b == 0 ? va[b] * gr[b] : duq + va[b] * gr[b];
          }
          s_w[e * Qv + qp] = wd;
          dq[q] = duq;
          wq[q] = wd;
        }
#pragma unroll
      for (int k = 0; k < DM; ++k)
        if (k < D) {
          T av = T(0), ad = T(0), am = T(0);
#pragma unroll
          for (int q = 0; q < QM; ++q)
            if (q < Q1) {
              av = fmaT(dq[q], tb.Bw[q * D + k], av);
              ad = fmaT(wq[q], tb.Bgl2[q * D + k], ad);
              if (need_ml) am = fmaT(wq[q], tb.B[q * D + k], am);
            }
          const int o = e * S2 + l + NL * k;
          kv[o] = av;
          kd[o] = ad;
          if (need_ml) km[o] = am;
        }
    }
  }
  if constexpr (DIM == 2) {
    if (face) face_flux();
  }
  // face (3D; 2D: next pass): the transpose along the face's first axis
  auto face_back = [&]() {
    const T* in[1] = {fr};
    const T* tab[1] = {tb.wBf};
    T* out[1] = {s_cf};
    // fr per element: [nf][DF][Q1]; out cf: [nf][DF][D]
    axis_pass<T, 0, QM, DM, true, 1>(te, Q1, DF, nf, D, in, FT, tab,
                                     Store<T, 1>{out, NFD});
  };
  if constexpr (DIM == 3) {
    if (face) face_back();
  }
  __syncthreads();

  // 3a. (3D) transposed contractions along axis 1: [Q1, D, D] in A
  T* rv = sA;
  T* rd = sA + te * S1;
  T* rm = sA + 2 * te * S1;
  const bool ml = a.need_ml != 0;
  if constexpr (DIM == 3) {
    if (ml) {
      const T* in[3] = {kv, kd, km};
      const T* tab[3] = {tb.Bw, tb.Bgl2, tb.B};
      T* out[3] = {rv, rd, rm};
      axis_pass<T, 1, QM, DM, true, 3>(te, Q1, Q1, D, D, in, S2, tab,
                                       Store<T, 3>{out, S1});
    } else {
      const T* in[2] = {kv, kd};
      const T* tab[2] = {tb.Bw, tb.Bgl2};
      T* out[2] = {rv, rd};
      axis_pass<T, 1, QM, DM, true, 2>(te, Q1, Q1, D, D, in, S2, tab,
                                       Store<T, 2>{out, S1});
    }
    __syncthreads();
  } else {
    if (face) face_back();
  }

  // 3b. transposed contractions along axis 0: the volume part of Ku, the
  // Jacobi diagonal (into inv) and ml
  {
    const int ies = DIM == 3 ? S1 : S2;
    const int n2 = DIM == 3 ? D : 1;
    const T* src[3] = {DIM == 3 ? rv : kv, DIM == 3 ? rd : kd,
                       DIM == 3 ? rm : km};
    if (ml) {
      const T* tab[3] = {tb.Bw, tb.Bgl2, tb.B};
      T* out[3] = {s_ku, s_inv, s_ml};
      axis_pass<T, 0, QM, DM, true, 3>(te, Q1, D, n2, D, src, ies, tab,
                                       Store<T, 3>{out, V});
    } else {
      const T* in[2] = {src[0], src[1]};
      const T* tab[2] = {tb.Bw, tb.Bgl2};
      T* out[2] = {s_ku, s_inv};
      axis_pass<T, 0, QM, DM, true, 2>(te, Q1, D, n2, D, in, ies, tab,
                                       Store<T, 2>{out, V});
    }
  }
  __syncthreads();

  // 3c. Ku = volume part + the face contributions of each dof, in face
  // order; the inverse Jacobi diagonal
  for (int i = tid; i < te * V; i += NT) {
    if (face) {
      const int e = i / V, j = i - e * V;
      T acc = s_ku[i];
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        const int sl = __ldg(a.dof_faces + j * DIM + m);
        if (sl >= 0) acc += s_cf[e * NFD + sl];
      }
      s_ku[i] = acc;
    }
    s_inv[i] = T(1) / s_inv[i];
  }
  if (a.n_cg == 0) return s_ku;
  __syncthreads();

  // 4. b = Ku A (A[k, l] = prod A1[k_a, l_a]: the transposed use of A1),
  // and x = D^-1 b
  chain_dd<T, DIM, DM, true>(te, D, s_ku, tb.A, sA, sB,
                             [&](int, int e, int off, T v) {
                               const int i = e * V + off;
                               s_b[i] = v;
                               s_x[i] = s_inv[i] * v;
                             });
  __syncthreads();

  // 5. Jacobi sweeps x += D^-1 (b - M_gl x)
  for (int it = 0; it < a.n_cg; ++it) {
    gl_mass_action<T, DIM, DM, QM>(te, D, Q1, s_x, s_w, tb.Bgl, sA, sB, sC,
                                   [&](int, int e, int off, T v) {
                                     const int i = e * V + off;
                                     s_x[i] = s_x[i] + s_inv[i] * (s_b[i] - v);
                                   });
    __syncthreads();
  }

  // 6. du_HO = x A^T (AT[k, l] = prod A1[l_a, k_a]: the forward use of A1)
  chain_dd<T, DIM, DM, false>(te, D, s_x, tb.A, sA, sB,
                              [&](int, int e, int off, T v) {
                                s_ku[e * V + off] = v;
                              });
  return s_ku;
}

// Pointers and sizes of the C interface: ptrs in the order u, u_nbr, P, sf,
// bdr, dof_faces (P, which PolyGeom reads, keeps its slot: the three stage
// libraries share the order); sizes E, nd, Q, Qf, nf, fd, n_cg, D, Q1.
constexpr int N_CORE_PTRS = 6;
constexpr int N_CORE_SIZES = 9;

template <typename T>
inline void fill_core_args(CoreArgs<T>& a, const void* const* p,
                           const int* sz) {
  a.u = static_cast<const T*>(p[0]);
  a.unbr = static_cast<const T*>(p[1]);
  a.sf = static_cast<const T*>(p[3]);
  a.bdr = static_cast<const int*>(p[4]);
  a.dof_faces = static_cast<const int*>(p[5]);
  a.E = sz[0]; a.nd = sz[1]; a.Q = sz[2]; a.Qf = sz[3]; a.nf = sz[4];
  a.fd = sz[5]; a.n_cg = sz[6]; a.D = sz[7]; a.Q1 = sz[8];
  a.with_face = 1;
  a.need_ml = 0;
  a.te = 1;
}

// Refuse sizes the core does not take: a tensor-product element (nd = D^dim,
// Q = Q1^dim, one face rule of Q1 points per axis) within the runtime-size
// instantiation's bounds.
inline int check_core_sizes(int dim, const int* sz) {
  const int nd = sz[1], Q = sz[2], Qf = sz[3], nf = sz[4], fd = sz[5];
  const int D = sz[7], Q1 = sz[8];
  if (D < 1 || Q1 < 1 || D > DMAX || Q1 > QMAX) return -5;
  const int V = dim == 3 ? D * D * D : D * D;
  const int Qv = dim == 3 ? Q1 * Q1 * Q1 : Q1 * Q1;
  const int DF = dim == 3 ? D : 1;
  if (nd != V || Q != Qv || fd != D * DF || Qf != Qv / Q1 || nf != 2 * dim)
    return -5;
  return 0;
}

// PolyGeom from the same arrays (P in slot 2), the bf16 P16 (null without)
// and the stage time t.
template <typename T, int DIM, bool BF16>
inline PolyGeom<T, DIM, BF16> poly_geom(const void* const* p,
                                        const void* p16, double t,
                                        const int* sz) {
  PolyGeom<T, DIM, BF16> g;
  g.P = static_cast<const T*>(p[2]);
  g.P16 = static_cast<const __nv_bfloat16*>(p16);
  g.t = static_cast<T>(t);
  g.Q = sz[2];
  g.FQ = sz[4] * sz[3];
  return g;
}

// The instantiation of a stage kernel for the 1D sizes (D, Q1): D for the
// compile-time sizes of the orders p = 2..4 at the rules the structured
// meshes give (3D: Q1 = D + 2, 2D: Q1 = D + 1, mesh order 2), 0 for the
// runtime-size code. The launchers switch on it.
inline int size_case(int dim, int D, int Q1) {
  const int X = dim == 3 ? 2 : 1;
  return D >= 3 && D <= 5 && Q1 == D + X ? D : 0;
}

// Shared memory a block may take: two blocks fit on an SM.
constexpr size_t SMEM_BUDGET = 110 * 1024;

constexpr size_t SMEM_MAX = 227 * 1024;

// Elements per tile: enough that the pointwise pass (te x Q1^(dim-1) lines)
// fills the block once, within SMEM_BUDGET; `extra` is the caller's shared
// entries per element beyond the core's.
inline int tile_elements(int dim, int D, int Q1, int nf, size_t elem_bytes,
                         int extra, CoreLayout* L, size_t* bytes) {
  const int NL = dim == 3 ? Q1 * Q1 : Q1;
  auto b = [&](int te) {
    return (size_t)(core_layout(dim, D, Q1, nf, te).end + te * extra) *
           elem_bytes;
  };
  const int te = choose_te(NT / NL, SMEM_BUDGET, b);
  *L = core_layout(dim, D, Q1, nf, te);
  *bytes = b(te);
  return te;
}

}  // namespace remhos
