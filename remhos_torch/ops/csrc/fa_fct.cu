// The assembled stage's flux-based (Zalesak) FCT, `-fct 1`, in one launch.
//
// No TPU counterpart: the JAX package forms the flux blocks and runs the
// sweeps in XLA ops (remhos_tpu/fct_flux.py:39-78), as the port's plain
// chain does (fct_flux._flux_blocks and fct_flux._fct_iterations, run by
// ops/fa_fct.fa_fct_reference).
//
// What it computes (FluxBasedFCT::CalcFCTSolution, remhos_fct.cpp:155-181,
// 307-446): for every element e, from its K_elem, M, upwind face blocks
// bdr[nf, fd, fd], u, du_HO, du_LO, the dof bounds u_min, u_max and ml,
//   Dk      = K_elem minus bdr at each face's own-own dof pairs, face by face
//             in face order (fct_flux.k_ho_diag_blocks' index_add_ order: an
//             edge or corner pair accumulates across faces);
//   d_ij    = max(0, -Dk_ij, -Dk_ji);
//   F_ij    = dt d_ij (u_i - u_j) + dt M_ij (duHO_i - duHO_j), 0 for i = j;
// then `iters` Zalesak sweeps from du = du_LO: the sums gp_i, gm_i of the
// positive and negative F_ij, max_pos_i = max(0, (u_max - u - dt du) ml) and
// min_neg_i = min(0, (u_min - u - dt du) ml), cp_i = max_pos / gp where gp >
// max_pos (else 1), cn_i = min_neg / gm where gm < min_neg (else 1), a_ij =
// min(cp_i, cn_j) where F_ij >= 0, else min(cn_i, cp_j), du_i += sum_j a_ij
// F_ij / ml_i / dt and F_ij -= a_ij F_ij. It writes du[e, nd]; Dk, d and F
// live in shared memory only. The elementwise steps round as the plain
// chain's ATen ops do (no contracted multiply-adds); only the sums over j
// run in another order (nine partial sums, added pairwise).
//
// What bounds it on the H100: bytes. At 64^3, p=2, f64 one launch reads K,
// M (1.53 GB each), the face blocks (1.02 GB) and the six vectors, and
// writes du: 4.47 GB, 1.34 ms at 3.35 TB/s; its ~3.9 GFLOP take 0.06 ms
// (utils/cost.fa_fct_cost). The plain chain moved each [E, nd, nd]
// intermediate (Dk, d, F, the sweep's a_ij and a_ij F_ij) through memory
// several times.
//
// Design. Each element's K and M are contiguous runs of nd^2 values and its
// face blocks one run of nf fd^2, so a tile of te consecutive elements is
// nine contiguous runs with the six vectors. A persistent block (grid = SMs
// x resident blocks) walks the tiles: it copies a tile's runs into shared
// memory with 16-byte cp.async, each run at the offset that keeps its
// source's 16-byte alignment, works on it, and copies the next. Several
// resident blocks an SM (six in f64 at p=2: 36 KB each) keep one block's
// copy beside another's work; a second tile region in each block, copied
// while the first is worked on, halves the resident blocks and was slower
// on an H100 (2.68 against 1.89 ms at 64^3, p=2, f64, with one running sum
// a row). One thread owns one row i of one element (te = 2 at nd <= 32, 64
// threads a block):
//   1. the face pass: row i's own-own pairs on every face that holds dof i,
//      face by face in face order (the face-pair table gives each face's
//      dofs and each dof's place on it); a face's entries of one row are
//      distinct, so they load together, and no thread touches another's
//      row, so no barrier between faces;
//   2. the F pass: row i's F_ij from Dk_ij, Dk_ji (column i: consecutive
//      across the lanes), M_ij, u_j and duHO_j, written in M_ij's place, with
//      gp and gm in registers; nine columns load together, each into its
//      own partial sum;
//   3. the sweeps: cp and cn to shared memory, then row i's limited sum; F
//      is written back only where another sweep follows.
// Row i's row reads have stride nd across the lanes, free of bank
// conflicts at odd nd; at even nd (p=3) every row is visited from the
// diagonal on (j = i + k mod nd), which keeps the lanes on distinct banks.
// In f64 at nd = 125 K and M do not fit together: M's rows are then read
// from global memory, and a d pass (d_ij for j > i at both places, each
// pair with one owner) lets F take d's place.
// Measured on an H100 80GB HBM3 at 700 W (64^3, p=2): f64 2.02 ms by CUDA
// events, 1.92 ms in a trace (70% of its bound; the plain chain 30.4 ms);
// f32 1.19 ms (1.16; 58%).
// Compiled for the tensor-product elements of p = 2..4 in 2D and 3D, f32 and
// f64; the operator launches it only there (ops/fa_fct.engages) and keeps
// the plain chain elsewhere.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t SMEM_MAX = 227 * 1024;    // a block's dynamic shared memory
constexpr int MAX_DEV = 64;
constexpr int NVEC = 6;                    // u, du_HO, du_LO, u_min, u_max, ml

// The sizes of one instance: nd dofs, nf faces of fd dofs; R threads an
// element (whole warps), NT a block, TE elements a tile.
template <int ND_, int NF_, int FD_>
struct Shape {
  static constexpr int ND = ND_, NF = NF_, FD = FD_;
  static constexpr int NN = ND * ND;
  static constexpr int NBE = NF * FD * FD;
  static constexpr int R = (ND + 31) / 32 * 32;
  static constexpr int NT = R < 64 ? 64 : R;
  static constexpr int TE = NT / R;
};

// A run of n values with room for its 16-byte alignment shift (sl values
// a 16-byte piece), rounded to whole pieces.
constexpr int run_len(int n, int sl) { return (n + 2 * sl - 1) / sl * sl; }

// The shared memory of one instance, in values of T: the tile's runs W (K,
// then Dk, and without M d and F), M (where it fits; then F), B (the face
// blocks) and the NVEC vectors; then cp and cn of the tile and, as int,
// the dofs' face positions and the faces' dofs (EXTRA bytes).
template <typename T, class S>
struct Layout {
  static constexpr int SL = 16 / (int)sizeof(T);
  static constexpr int NW = run_len(S::TE * S::NN, SL);
  static constexpr int NB = run_len(S::TE * S::NBE, SL);
  static constexpr int NV = run_len(S::TE * S::ND, SL);
  static constexpr size_t EXTRA =
      2 * S::TE * S::ND * sizeof(T) + (S::ND + S::FD) * S::NF * sizeof(int);
  // M staged beside K where both fit
  static constexpr bool MS =
      (2 * NW + NB + NVEC * NV) * sizeof(T) + EXTRA <= SMEM_MAX;
  static constexpr int OM = NW;
  static constexpr int OB = OM + (MS ? NW : 0);
  static constexpr int OV = OB + NB;
  static constexpr int TILE = OV + NVEC * NV;
  static constexpr size_t SMEM = TILE * sizeof(T) + EXTRA;
};

template <typename T>
struct Args {
  const T* K;       // [E, nd, nd]
  const T* M;       // [E, nd, nd]
  const T* bdr;     // [E, nf, fd, fd]
  const T* vec[NVEC];  // [E, nd] each: u, du_HO, du_LO, u_min, u_max, ml
  const int* pairs;    // [nf, fd, fd]: bdr_dofs[f, a] nd + bdr_dofs[f, b]
  T* du;            // [E, nd] out
  T dt;
  int E, iters;
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

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a run that starts at src lands in its shared region at base: the
// offset (in values) that gives it src's alignment modulo 16 bytes.
template <typename T>
__device__ __forceinline__ T* landing(T* base, const T* src) {
  return base + (reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T);
}

// Copy n values from src to landing(base, src), the block's threads
// together: single values up to the first 16-byte boundary, 16-byte pieces,
// single values after the last.
template <typename T, int NT>
__device__ __forceinline__ void copy_run(T* base, const T* src, int n) {
  constexpr int SL = 16 / (int)sizeof(T);
  T* dst = landing(base, src);
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  const int head = mis == 0 ? 0 : (SL - mis < n ? SL - mis : n);
  const int nv = (n - head) / SL;
  for (int k = threadIdx.x; k < head; k += NT)
    cp_async<sizeof(T)>(dst + k, src + k);
  for (int k = threadIdx.x; k < nv; k += NT)
    cp_async<16>(dst + head + k * SL, src + head + k * SL);
  for (int k = head + nv * SL + threadIdx.x; k < n; k += NT)
    cp_async<sizeof(T)>(dst + k, src + k);
}

// Start the copies of tile `tile` into the tile region at st (no commit).
template <typename T, class S, class L>
__device__ __forceinline__ void load_tile(const Args<T>& a, T* st,
                                          int tile) {
  const size_t e0 = (size_t)tile * S::TE;
  const int ne = a.E - (int)e0 < S::TE ? a.E - (int)e0 : S::TE;
  copy_run<T, S::NT>(st, a.K + e0 * S::NN, ne * S::NN);
  if constexpr (L::MS) copy_run<T, S::NT>(st + L::OM, a.M + e0 * S::NN,
                                          ne * S::NN);
  copy_run<T, S::NT>(st + L::OB, a.bdr + e0 * S::NBE, ne * S::NBE);
#pragma unroll
  for (int v = 0; v < NVEC; ++v)
    copy_run<T, S::NT>(st + L::OV + v * L::NV, a.vec[v] + e0 * S::ND,
                       ne * S::ND);
}

// d = max(0, -x, -y): the plain chain's clamp(-Dk, min=0) and maximum
template <typename T>
__device__ __forceinline__ T dmax(T x, T y) {
  T d = -x;
  if (d < T(0)) d = T(0);
  if (-y > d) d = -y;
  return d;
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return a < b ? a : b;
}

// The sum of x[0..N) pairwise: a row's sums are kept as N partial sums
// (every N-th column), whose rounding grows as nd / N + log2 N, near the
// plain chain's tree reductions, where one running sum grows as nd.
template <typename T, int N>
__device__ __forceinline__ T pair_sum(T (&x)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int q = 0; q + w < N; q += 2 * w) x[q] = addR(x[q], x[q + w]);
  return x[0];
}

// Row i's j-th column visited k-th: from the diagonal on at even nd.
template <int ND>
__device__ __forceinline__ int col(int i, int k) {
  if constexpr (ND % 2 == 0) {
    const int j = i + k;
    return j < ND ? j : j - ND;
  } else {
    return k;
  }
}

template <typename T, int ND, int NF, int FD>
__global__ void __launch_bounds__(Shape<ND, NF, FD>::NT)
fa_fct_kernel(const __grid_constant__ Args<T> a) {
  using S = Shape<ND, NF, FD>;
  using L = Layout<T, S>;
  // columns a thread loads together; unrolling of the loops over them
  constexpr int CH = ND < 9 ? ND : 9;
  constexpr int UNR = ND <= 32 ? ND : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* s_cp = sm + L::TILE;
  T* s_cn = s_cp + S::TE * ND;
  int* s_rf = reinterpret_cast<int*>(s_cn + S::TE * ND);  // [NF][ND]
  int* s_fc = s_rf + NF * ND;                              // [NF][FD]
  const int tid = threadIdx.x;
  const int el = tid / S::R, i = tid - el * S::R;
  const int ntiles = (a.E + S::TE - 1) / S::TE;
  const T dt = a.dt;

  // from the face pairs (pair (f, p, b) is bdr_dofs[f, p] nd + bdr_dofs[f,
  // b]): each dof's position on each face, -1 off it, and each face's dofs
  for (int k = tid; k < NF * ND; k += S::NT) s_rf[k] = -1;
  __syncthreads();
  for (int k = tid; k < NF * FD; k += S::NT) {
    const int f = k / FD, p = k - f * FD;
    s_rf[f * ND + __ldg(a.pairs + k * FD) / ND] = p;
    s_fc[k] = __ldg(a.pairs + f * FD * FD + p) % ND;
  }

  T* st = sm;
  if (blockIdx.x < ntiles) load_tile<T, S, L>(a, st, blockIdx.x);
  cp_commit();
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    cp_wait<0>();
    __syncthreads();

    const size_t e0 = (size_t)tile * S::TE;
    const bool on = i < ND && el < a.E - (int)e0;
    T* W = landing(st, a.K + e0 * S::NN) + el * S::NN;
    T* wi = W + i * ND;
    // row i of M: staged (then F takes its place) or in global memory
    T* Mr = nullptr;
    const T* Mg = nullptr;
    if constexpr (L::MS)
      Mr = landing(st + L::OM, a.M + e0 * S::NN) + el * S::NN + i * ND;
    else
      Mg = a.M + (e0 + el) * S::NN + (size_t)i * ND;
    T* Fr = L::MS ? Mr : wi;
    const T* Bt = landing(st + L::OB, a.bdr + e0 * S::NBE) + el * S::NBE;
    const T* V[NVEC];
#pragma unroll
    for (int v = 0; v < NVEC; ++v)
      V[v] = landing(st + L::OV + v * L::NV, a.vec[v] + e0 * ND) + el * ND;

    // 1. Dk: row i's own-own face terms, face by face in face order; a
    // face's entries of the row are distinct, so they load together
    if (on) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int p = s_rf[f * ND + i];
        if (p >= 0) {
          const T* b = Bt + (f * FD + p) * FD;
          const int* c = s_fc + f * FD;
          T w[FD];
#pragma unroll
          for (int q = 0; q < FD; ++q) w[q] = wi[c[q]];
#pragma unroll
          for (int q = 0; q < FD; ++q) wi[c[q]] = subR(w[q], b[q]);
        }
      }
    }
    __syncthreads();

    // 2. without M staged, d_ij = d_ji for j > i in Dk's place, at both
    // places (each pair has one owner); with M staged, step 3 forms d
    if constexpr (!L::MS) {
      if (on) {
#pragma unroll (UNR)
        for (int k0 = 1; k0 < ND; k0 += CH) {
          T x[CH], y[CH];
#pragma unroll
          for (int q = 0; q < CH; ++q) {
            const int j = col<ND>(i, k0 + q);
            if (k0 + q < ND && j > i) {
              x[q] = wi[j];
              y[q] = W[j * ND + i];
            }
          }
#pragma unroll
          for (int q = 0; q < CH; ++q) {
            const int j = col<ND>(i, k0 + q);
            if (k0 + q < ND && j > i) {
              const T d = dmax(x[q], y[q]);
              wi[j] = d;
              W[j * ND + i] = d;
            }
          }
        }
      }
      __syncthreads();
    }

    // 3. F_ij over row i (in M's place, else in d's), with its sums; CH
    // columns load together
    T gp = T(0), gm = T(0), du = T(0), ui = T(0), m = T(0);
    T umin = T(0), umax = T(0);
    T gpq[CH], gmq[CH];
#pragma unroll
    for (int q = 0; q < CH; ++q) gpq[q] = gmq[q] = T(0);
    if (on) {
      ui = V[0][i];
      const T hi = V[1][i];
      du = V[2][i];
      umin = V[3][i];
      umax = V[4][i];
      m = V[5][i];
#pragma unroll (UNR)
      for (int k0 = 0; k0 < ND; k0 += CH) {
        T x[CH], y[CH], mj[CH], uj[CH], hj[CH];
#pragma unroll
        for (int q = 0; q < CH; ++q) {
          const int j = col<ND>(i, k0 + q);
          if (k0 + q < ND) {
            x[q] = wi[j];
            if constexpr (L::MS) {
              y[q] = W[j * ND + i];
              mj[q] = Mr[j];
            } else {
              mj[q] = __ldg(Mg + j);
            }
            uj[q] = V[0][j];
            hj[q] = V[1][j];
          }
        }
#pragma unroll
        for (int q = 0; q < CH; ++q) {
          const int j = col<ND>(i, k0 + q);
          if (k0 + q < ND) {
            T F = T(0);
            if (j != i) {
              T d;
              if constexpr (L::MS) d = dmax(x[q], y[q]);
              else d = x[q];
              F = addR(mulR(mulR(dt, d), subR(ui, uj[q])),
                       mulR(mulR(dt, mj[q]), subR(hi, hj[q])));
            }
            Fr[j] = F;
            gpq[q] = addR(gpq[q], F > T(0) ? F : T(0));
            gmq[q] = addR(gmq[q], F < T(0) ? F : T(0));
          }
        }
      }
      gp = pair_sum(gpq);
      gm = pair_sum(gmq);
    }

    // 4. the sweeps
    for (int sw = 0; sw < a.iters; ++sw) {
      if (sw > 0) {
        if (on) {
#pragma unroll
          for (int q = 0; q < CH; ++q) gpq[q] = gmq[q] = T(0);
#pragma unroll (UNR)
          for (int k0 = 0; k0 < ND; k0 += CH) {
#pragma unroll
            for (int q = 0; q < CH; ++q) {
              if (k0 + q < ND) {
                const T F = Fr[col<ND>(i, k0 + q)];
                gpq[q] = addR(gpq[q], F > T(0) ? F : T(0));
                gmq[q] = addR(gmq[q], F < T(0) ? F : T(0));
              }
            }
          }
          gp = pair_sum(gpq);
          gm = pair_sum(gmq);
        }
        __syncthreads();            // the last sweep's reads of cp, cn
      }
      T cp = T(1), cn = T(1);
      if (on) {
        const T ulo = addR(ui, mulR(dt, du));
        T mp = mulR(subR(umax, ulo), m);
        T mn = mulR(subR(umin, ulo), m);
        if (mp < T(0)) mp = T(0);
        if (mn > T(0)) mn = T(0);
        if (gp > mp) cp = mp / gp;
        if (gm < mn) cn = mn / gm;
        s_cp[el * ND + i] = cp;
        s_cn[el * ND + i] = cn;
      }
      __syncthreads();
      if (on) {
        const T* cpe = s_cp + el * ND;
        const T* cne = s_cn + el * ND;
        // F is written back only where another sweep follows
        const bool keep = sw + 1 < a.iters;
        T sq[CH];
#pragma unroll
        for (int q = 0; q < CH; ++q) sq[q] = T(0);
#pragma unroll (UNR)
        for (int k0 = 0; k0 < ND; k0 += CH) {
          T F[CH], c[CH];
#pragma unroll
          for (int q = 0; q < CH; ++q) {
            const int j = col<ND>(i, k0 + q);
            if (k0 + q < ND) {
              F[q] = Fr[j];
              c[q] = F[q] >= T(0) ? tmin(cp, cne[j]) : tmin(cn, cpe[j]);
            }
          }
#pragma unroll
          for (int q = 0; q < CH; ++q) {
            if (k0 + q < ND) {
              const T fij = mulR(c[q], F[q]);
              sq[q] = addR(sq[q], fij);
              if (keep) Fr[col<ND>(i, k0 + q)] = subR(F[q], fij);
            }
          }
        }
        du = addR(du, (pair_sum(sq) / m) / dt);
      }
    }
    if (on) a.du[(e0 + el) * ND + i] = du;
    __syncthreads();                // the tile region is free again
    if (tile + gridDim.x < ntiles)
      load_tile<T, S, L>(a, st, tile + gridDim.x);
    cp_commit();
  }
}

struct Ptrs {
  const void *K, *M, *bdr;
  const void* vec[NVEC];
  const int* pairs;
  void* du;
};

template <typename T, int ND, int NF, int FD>
int launch_sized(const Ptrs& p, int E, int iters, double dt,
                 cudaStream_t stream) {
  using S = Shape<ND, NF, FD>;
  using L = Layout<T, S>;
  static_assert(L::SMEM <= SMEM_MAX, "the tile does not fit");
  // the persistent grid of each device: SMs x resident blocks
  static int grid_of[MAX_DEV];
  const void* fn =
      reinterpret_cast<const void*>(&fa_fct_kernel<T, ND, NF, FD>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEV) return -6;
  if (grid_of[dev] == 0) {
    if (L::SMEM > 48 * 1024) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::SMEM);
      if (e != cudaSuccess) return (int)e;
    }
    int occ = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, S::NT,
                                                      L::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return -3;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    grid_of[dev] = sms * occ;
  }
  Args<T> a;
  a.K = static_cast<const T*>(p.K);
  a.M = static_cast<const T*>(p.M);
  a.bdr = static_cast<const T*>(p.bdr);
  for (int v = 0; v < NVEC; ++v) a.vec[v] = static_cast<const T*>(p.vec[v]);
  a.pairs = p.pairs;
  a.du = static_cast<T*>(p.du);
  a.dt = T(dt);
  a.E = E;
  a.iters = iters;
  const int tiles = (E + S::TE - 1) / S::TE;
  const int grid = tiles < grid_of[dev] ? tiles : grid_of[dev];
  fa_fct_kernel<T, ND, NF, FD><<<grid, S::NT, L::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Ptrs& p, int E, int nd, int nf, int fd, int iters,
           double dt, cudaStream_t stream) {
  if (E < 0 || iters < 0) return -1;
  if (E == 0) return 0;
#define REMHOS_FCT(ND_, NF_, FD_) \
  if (nd == ND_ && nf == NF_ && fd == FD_) \
    return launch_sized<T, ND_, NF_, FD_>(p, E, iters, dt, stream)
  REMHOS_FCT(27, 6, 9);
  REMHOS_FCT(64, 6, 16);
  REMHOS_FCT(125, 6, 25);
  REMHOS_FCT(9, 4, 3);
  REMHOS_FCT(16, 4, 4);
  REMHOS_FCT(25, 4, 5);
#undef REMHOS_FCT
  return -5;                         // no instance for these sizes
}

}  // namespace

extern "C" {

// K, M [E, nd, nd], bdr [E, nf, fd, fd], u, du_HO, du_LO, u_min, u_max, ml
// [E, nd], pairs (int32 [nf, fd, fd], ops/fa_fct.fa_fct_tables) -> du [E, nd];
// dt; sizes: E, nd, nf, fd, iters. Returns 0, a CUDA error code (> 0), or
// < 0 for a bad argument (-1: sizes; -2: type; -3: shared memory; -5: not a
// compiled element; -6: device index).
int remhos_fa_fct(int dtype_bytes, const void* K, const void* M,
                  const void* bdr, const void* u, const void* du_ho,
                  const void* du_lo, const void* u_min, const void* u_max,
                  const void* ml, const int* pairs, void* du, double dt,
                  const int* sizes, int nsizes, void* stream) {
  if (nsizes != 5) return -1;
  const Ptrs p{K, M, bdr, {u, du_ho, du_lo, u_min, u_max, ml}, pairs, du};
  const int E = sizes[0], nd = sizes[1], nf = sizes[2], fd = sizes[3],
            iters = sizes[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4)
    return launch<float>(p, E, nd, nf, fd, iters, dt, s);
  if (dtype_bytes == 8)
    return launch<double>(p, E, nd, nf, fd, iters, dt, s);
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
