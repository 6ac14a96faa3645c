// Element-local Jacobi-preconditioned CG for the Gauss-Legendre mass inverse,
// sum-factorized, with the Krylov state of a tile of elements in shared
// memory.
//
// Replaces: fused_gl_cg / _gl_cg_kernel in
//   remhos_tpu/ops/pallas_kernels.py (:209 / :162).
//
// What it computes, for every element independently (MFEM's DGMassInverse
// local CG, remhos_ho.cpp:79-80): b = rhs A (Bernstein -> GL), the Jacobi
// diagonal D = wdet Bgl2, then n_iter CG iterations on M_gl g = Bgl^T
// (wdet (Bgl g)), each masked per element by the relative test rr >
// rel_tol2 rr0 taken from the previous iteration's residual: a stopped
// element gets alpha = beta = 0, so its state is frozen. pAp == 0 and
// rz == 0 are guarded as in the TPU kernel. Out: x A^T.
//
// Design. Every product runs axis by axis on the 1D tables A1, Bgl1 and
// Bgl21 (ops/tables.sum_factor_tables) with the stage core's passes
// (stage_core.cuh): b = rhs A and x A^T are chain_dd; M_gl p is
// gl_mass_action, whose last-axis pass fuses Bgl, wdet and Bgl^T (run in
// place here); the diagonal is three transposed passes of Bgl21 over wdet.
// Persistent blocks walk over tiles of te elements. A tile's x, r, p, Ap,
// D^-1, wdet and the pass scratch stay in shared memory for the whole
// solve. The scalar part of an iteration (pAp, alpha, x, r, rz, rr, beta,
// p) gives one warp to each element: its dots are warp_sum butterflies in
// a fixed order, and it needs no block barrier. A tile leaves its loop
// once none of its elements is live (__syncthreads_or), since alpha = 0
// would change nothing.
//
// What bounds it on the H100: at N=24, p=3 in f32 it reads rhs (3.5 MB)
// and wdet (11.9 MB) and writes x (3.5 MB): 19.2 MB, 5.7 us at 3.35 TB/s
// (f64 11.5 us). Its sum-factorized products at 2.0 iterations an element
// take less (utils/cost.gl_cg_cost): bytes bound it. The first tiling of
// this design took 0.0561 ms in f32 and 0.1445 in f64 (CUDA events). Each
// multiply-add of its passes read a table entry from shared memory, so
// the shared-memory pipe, not the FMA units, set the pace. What the design
// does about it:
//   - at the compiled sizes (p = 2..4) the three 1D tables are kernel
//     parameters (CgTables), so the passes read them through the constant
//     cache and take no table entry from shared memory;
//   - a tile's rows come in with 8 loads in flight a thread (stage_rows);
//   - half a block's threads cover the smallest passes (8 elements a tile
//     at p=3 in 3D), at 4 blocks an SM in f32 and 3 in f64.
// Now (H100 80GB HBM3, 700 W, tools/kernel_variants.py, device-paced):
// 0.0366 ms f32, 0.0904 f64, 6.4x and 7.9x the byte bound. Not measured
// by section (no ncu on the card), but likely what holds it: the passes'
// inputs and outputs still go through shared memory (~1300 accesses an
// element an iteration, some of them with bank conflicts), and a tile
// takes ~20 block barriers.
//
// Tried and slower (same card and setting, ms f32 / f64): the tables
// copied into register arrays, which ptxas put on the stack (208-992 bytes
// a thread): 0.0886 / 0.3049 (chip_smoke.check_gl_cg); 16 elements a tile
// (one line of the smallest passes a thread): 0.0395 / 0.0908; 4 elements:
// 0.0534 / 0.1150; 16 elements at 3 and 2 blocks an SM: 0.0395 / 0.0996;
// 3 and 2 blocks an SM at 8 elements: 0.0366 / 0.0903, no change
// (tools/kernel_variants.py). Not tried: one warp an element with
// __syncwarp between the passes (the tiled kernel met its required time).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "stage_core.cuh"

namespace {

using namespace remhos;

// At compiled sizes the three 1D tables the kernel reads are kernel
// parameters (constant memory): a pass's multiply-add takes its table entry
// as a constant-bank operand, where a table in shared memory costs one
// shared-memory load a multiply-add (the passes' limit). At runtime sizes
// (DT == 0) they are read from shared memory.
template <typename T, int DT, int QT>
struct CgTables {
  T Bgl[QT * DT], Bgl2[QT * DT], A[DT * DT];
};
template <typename T>
struct CgTables<T, 0, 0> {};

template <typename T, int DT, int QT>
struct Args {
  const T* rhs;     // [E, nd]
  const T* wdet;    // [E, Q]
  const T* sf;      // the packed 1D tables (ops/tables.SF_TABLES)
  T* out;           // [E, nd]
  T rel_tol2;
  int E, nd, Q, n_iter, D, Q1, te;
  // offsets of the shared arrays, in entries of T
  int o_tab, o_x, o_r, o_p, o_ap, o_inv, o_w, o_A, o_B, o_s;
  CgTables<T, DT, QT> tab;
};

// Resident blocks an SM the kernel is built for (its launch bounds) and
// sizes its tile for (the shared memory of that many blocks): at compiled
// sizes CG_BLOCKS_F32 / _F64, which their registers allow; at runtime sizes
// the stage kernels' min_blocks.
constexpr int CG_BLOCKS_F32 = 4, CG_BLOCKS_F64 = 3;
// The threads of a block that the smallest passes (D^(dim-1) lines an
// element) fill: te = CG_TILE_THREADS / lines elements a tile
constexpr int CG_TILE_THREADS = NT / 2;
template <typename T, int DT>
constexpr int cg_blocks() {
  return DT == 0 ? min_blocks<T>()
                 : (sizeof(T) == 4 ? CG_BLOCKS_F32 : CG_BLOCKS_F64);
}

// The shared memory of a tile of te elements: the 1D tables (runtime
// sizes), x, r, p, Ap, D^-1 [te][nd], wdet [te][Q], the pass scratch A
// [te][max(S1, nd)] and B [te][max(S2, nd)] (the mass action's fused pass
// runs in place in its input, B in 3D, A in 2D: each thread reads its
// line whole before it writes it), the per-element scalars rz, rr, tol
// [3][te]. Sets the offsets in *a; returns the bytes.
template <typename T, int DT, int QT>
size_t layout(Args<T, DT, QT>* a, int dim, int te) {
  const int D = a->D, Q1 = a->Q1, V = a->nd;
  const int S1 = Q1 * (dim == 3 ? D * D : D);
  const int S2 = dim == 3 ? Q1 * Q1 * D : S1;
  int o = 0;
  auto take = [&](int* off, int n) { *off = o; o += al4(n); };
  take(&a->o_tab, DT ? 0 : 7 * Q1 * D + D * D);
  take(&a->o_x, te * V);
  take(&a->o_r, te * V);
  take(&a->o_p, te * V);
  take(&a->o_ap, te * V);
  take(&a->o_inv, te * V);
  take(&a->o_w, te * a->Q);
  take(&a->o_A, te * (S1 > V ? S1 : V));
  take(&a->o_B, te * (S2 > V ? S2 : V));
  take(&a->o_s, 3 * te);
  return (size_t)o * sizeof(T);
}

// dst[i] = src[i] for i < n and fill for n <= i < nt, with U loads in
// flight a thread (a tile's rows come in a few round trips, not nt / NT).
template <typename T, int U = 8>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int n, int nt, T fill) {
  for (int b = threadIdx.x; b < nt; b += U * NT) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = b + u * NT;
      v[u] = i < n ? __ldg(src + i) : fill;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = b + u * NT;
      if (i < nt) dst[i] = v[u];
    }
  }
}

template <typename T, int DIM, int DT, int QT>
__global__ void __launch_bounds__(NT, cg_blocks<T, DT>())
gl_cg_kernel(const __grid_constant__ Args<T, DT, QT> a) {
  using SZ = Sizes1D<DT, QT>;
  constexpr int DM = SZ::DM, QM = SZ::QM;
  const SZ sz{a.D, a.Q1};
  const int D = sz.D(), Q1 = sz.Q1();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int te = a.te, E = a.E, Q = a.Q;
  const int V = DIM == 3 ? D * D * D : D * D;
  const int n2 = DIM == 3 ? Q1 : 1;
  const Tab1D<T> tb = tab1d<T>(sm + a.o_tab, D, Q1);
  const T* Bgl = tb.Bgl;
  const T* Bgl2 = tb.Bgl2;
  const T* A1 = tb.A;
  if constexpr (DT != 0) {
    Bgl = a.tab.Bgl;
    Bgl2 = a.tab.Bgl2;
    A1 = a.tab.A;
  }
  T* s_x = sm + a.o_x;
  T* s_r = sm + a.o_r;
  T* s_p = sm + a.o_p;
  T* s_ap = sm + a.o_ap;
  T* s_inv = sm + a.o_inv;
  T* s_w = sm + a.o_w;
  T* sA = sm + a.o_A;
  T* sB = sm + a.o_B;
  T* sC = DIM == 3 ? sB : sA;     // the fused pass in place
  T* s_rz = sm + a.o_s;
  T* s_rr = s_rz + te;
  T* s_tol = s_rr + te;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  if constexpr (DT == 0) stage_tables(a.sf, D, Q1, sm + a.o_tab);
  const int ntiles = (E + te - 1) / te;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int e_base = tile * te;
    const int ne = min(te, E - e_base);
    // the tile's rhs (into Ap) and wdet; rows e >= ne hold rhs = 0 and
    // wdet = 1, so they start (and stay) stopped with finite values
    stage_rows(s_ap, a.rhs + (size_t)e_base * V, ne * V, te * V, T(0));
    stage_rows(s_w, a.wdet + (size_t)e_base * Q, ne * Q, te * Q, T(1));
    __syncthreads();

    // the Jacobi diagonal D = wdet Bgl2 (Bgl21 along every axis,
    // transposed), inverted
    {
      const T* tab[1] = {Bgl2};
      auto inv = [&](int, int e, int off, T v) {
        s_inv[e * V + off] = T(1) / v;
      };
      const T* in0[1] = {s_w};
      if constexpr (DIM == 3) {
        const int S1 = Q1 * D * D, S2 = Q1 * Q1 * D;
        T* o0[1] = {sB};
        axis_pass<T, 0, QM, DM, true, 1>(te, Q1, Q1, n2, D, in0, Q, tab,
                                         Store<T, 1>{o0, S2});
        __syncthreads();
        const T* in1[1] = {sB};
        T* o1[1] = {sA};
        axis_pass<T, 1, QM, DM, true, 1>(te, D, Q1, Q1, D, in1, S2, tab,
                                         Store<T, 1>{o1, S1});
        __syncthreads();
        const T* in2[1] = {sA};
        axis_pass<T, 2, QM, DM, true, 1>(te, D, D, Q1, D, in2, S1, tab, inv);
      } else {
        const int S1 = Q1 * D;
        T* o0[1] = {sA};
        axis_pass<T, 0, QM, DM, true, 1>(te, Q1, Q1, 1, D, in0, Q, tab,
                                         Store<T, 1>{o0, S1});
        __syncthreads();
        const T* in1[1] = {sA};
        axis_pass<T, 1, QM, DM, true, 1>(te, D, Q1, 1, D, in1, S1, tab, inv);
      }
    }
    __syncthreads();

    // b = rhs A (the transposed use of A1), kept in r; x = 0, p = z = D^-1 r
    chain_dd<T, DIM, DM, true>(te, D, s_ap, A1, sA, sB,
                               [&](int, int e, int off, T v) {
                                 const int i = e * V + off;
                                 s_r[i] = v;
                                 s_x[i] = T(0);
                                 s_p[i] = s_inv[i] * v;
                               });
    __syncthreads();
    // rz = r . z, rr = r . r and the stopping level, one warp an element;
    // `live`: whether an element of this thread's warp goes on
    int live = 0;
    for (int e = warp; e < te; e += NWARPS) {
      T rz = T(0), rr = T(0);
      for (int j = lane; j < V; j += 32) {
        const T r = s_r[e * V + j];
        rz += r * (s_inv[e * V + j] * r);
        rr += r * r;
      }
      rz = warp_sum(rz);
      rr = warp_sum(rr);
      const T tol = a.rel_tol2 * rr;
      live |= rr > tol;
      if (lane == 0) {
        s_rz[e] = rz;
        s_rr[e] = rr;
        s_tol[e] = tol;
      }
    }

    for (int it = 0; it < a.n_iter; ++it) {
      // an element is live while its previous rr > tol; the tile leaves the
      // loop once none is (alpha = 0 would change nothing). The barrier
      // also orders the previous phase's updates before Ap.
      if (!__syncthreads_or(live)) break;
      live = 0;
      // Ap = M_gl p
      gl_mass_action<T, DIM, DM, QM>(te, D, Q1, s_p, s_w, Bgl, sA, sB, sC,
                                     Store<T, 1>{&s_ap, V});
      __syncthreads();
      // the scalar part, one warp an element: pAp, alpha, x, r, z, rz, rr,
      // beta, p (each lane updates the same entries in both of its loops)
      for (int e = warp; e < te; e += NWARPS) {
        const bool on = s_rr[e] > s_tol[e];
        T* x = s_x + e * V;
        T* r = s_r + e * V;
        T* p = s_p + e * V;
        const T* ap = s_ap + e * V;
        const T* inv = s_inv + e * V;
        T pap = T(0);
        for (int j = lane; j < V; j += 32) pap += p[j] * ap[j];
        pap = warp_sum(pap);
        const T rz = s_rz[e];
        const T alpha = on ? rz / (pap != T(0) ? pap : T(1)) : T(0);
        T rzn = T(0), rrn = T(0);
        for (int j = lane; j < V; j += 32) {
          x[j] = x[j] + alpha * p[j];
          const T rj = r[j] - alpha * ap[j];
          r[j] = rj;
          rzn += rj * (inv[j] * rj);
          rrn += rj * rj;
        }
        rzn = warp_sum(rzn);
        rrn = warp_sum(rrn);
        if (on) {
          const T beta = rzn / (rz != T(0) ? rz : T(1));
          for (int j = lane; j < V; j += 32) p[j] = inv[j] * r[j] + beta * p[j];
          if (lane == 0) {
            s_rz[e] = rzn;
            s_rr[e] = rrn;
          }
          live |= rrn > s_tol[e];
        }
      }
    }
    __syncthreads();

    // out = x A^T (the forward use of A1), straight to the output rows
    T* og = a.out + (size_t)e_base * V;
    chain_dd<T, DIM, DM, false>(te, D, s_x, A1, sA, sB,
                                [&](int, int e, int off, T v) {
                                  if (e < ne) og[e * V + off] = v;
                                });
    __syncthreads();     // the next tile reuses the shared arrays
  }
}

template <typename T, int DIM, int DT, int QT>
int launch_sized(Args<T, DT, QT>& a, const T* sf_host, cudaStream_t stream) {
  if constexpr (DT != 0) {
    // the tables into the parameters, from the host copy of sf
    const int n = QT * DT;
    for (int i = 0; i < n; ++i) {
      a.tab.Bgl[i] = sf_host[3 * n + i];
      a.tab.Bgl2[i] = sf_host[4 * n + i];
    }
    for (int i = 0; i < DT * DT; ++i) a.tab.A[i] = sf_host[7 * n + i];
  }
  // elements a tile: CG_TILE_THREADS / lines, within the shared memory of
  // cg_blocks blocks an SM (1 KB of the SM's 228 KB kept for each)
  const int lines = DIM == 3 ? a.D * a.D : a.D;
  a.te = choose_te(CG_TILE_THREADS / lines,
                   (228 * 1024) / cg_blocks<T, DT>() - 1024,
                   [&](int te) { return layout(&a, DIM, te); });
  const size_t smem = layout(&a, DIM, a.te);
  if (smem > SMEM_MAX) return -3;
  const void* fn = reinterpret_cast<const void*>(&gl_cg_kernel<T, DIM, DT, QT>);
  int grid = 0;
  const int rc = persistent_grid(fn, smem, (a.E + a.te - 1) / a.te, &grid);
  if (rc != 0) return rc;
  gl_cg_kernel<T, DIM, DT, QT><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DIM>
int launch(const void* const* p, double rel_tol2, const int* sz,
           cudaStream_t stream) {
  const int rc = check_core_sizes(DIM, sz);
  if (rc != 0) return rc;
  if (sz[0] <= 0) return 0;
  if (sz[6] < 0) return -4;
  auto fill = [&](auto& a) {
    a.rhs = static_cast<const T*>(p[0]);
    a.wdet = static_cast<const T*>(p[1]);
    a.sf = static_cast<const T*>(p[2]);
    a.out = static_cast<T*>(const_cast<void*>(p[4]));
    a.rel_tol2 = static_cast<T>(rel_tol2);
    a.E = sz[0]; a.nd = sz[1]; a.Q = sz[2]; a.n_iter = sz[6];
    a.D = sz[7]; a.Q1 = sz[8];
  };
  const T* sf_host = static_cast<const T*>(p[3]);
  constexpr int X = DIM == 3 ? 2 : 1;
  switch (size_case(DIM, sz[7], sz[8])) {
    case 3: { Args<T, 3, 3 + X> a; fill(a); return launch_sized<T, DIM>(a, sf_host, stream); }
    case 4: { Args<T, 4, 4 + X> a; fill(a); return launch_sized<T, DIM>(a, sf_host, stream); }
    case 5: { Args<T, 5, 5 + X> a; fill(a); return launch_sized<T, DIM>(a, sf_host, stream); }
    default: { Args<T, 0, 0> a; fill(a); return launch_sized<T, DIM>(a, sf_host, stream); }
  }
}

}  // namespace

extern "C" {

// ptrs: rhs, wdet, sf (the packed 1D tables, on the device), sf_host (the
// same on the host: the compiled sizes pass the tables as kernel
// parameters), out; sizes: the stage core's
// (E, nd, Q, Qf, nf, fd, n_iter in the sweeps' slot, D, Q1); rel_tol2 is
// the square of the relative tolerance. Returns 0, a CUDA error code (> 0),
// or < 0 for a bad argument (-1: counts; -2: type or dimension; -3: shared
// memory; -4: n_iter; -5: not a tensor-product element within DMAX, QMAX).
int remhos_gl_cg(int dtype_bytes, int dim, const void* const* ptrs, int nptrs,
                 double rel_tol2, const int* sizes, int nsizes,
                 void* stream) {
  if (nptrs != 5 || nsizes != N_CORE_SIZES) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4 && dim == 3) return launch<float, 3>(ptrs, rel_tol2, sizes, s);
  if (dtype_bytes == 8 && dim == 3) return launch<double, 3>(ptrs, rel_tol2, sizes, s);
  if (dtype_bytes == 4 && dim == 2) return launch<float, 2>(ptrs, rel_tol2, sizes, s);
  if (dtype_bytes == 8 && dim == 2) return launch<double, 2>(ptrs, rel_tol2, sizes, s);
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
