// The assembled stage's element data from the mesh nodes, in one launch.
//
// No TPU counterpart: the JAX package assembles the element matrices of its
// full-assembly path in XLA ops (remhos_tpu/operator.py:270-319, assembly.py),
// as the port's plain version does (ops/fa_assemble.fa_assemble_reference).
//
// What it computes: for every element e, at the moved nodes xs = x0 + t v
// with the nodal mesh velocity v of remap, the tensors the assembled stage
// reads (remhos.cpp:1598-1676):
//   detJ[e, q]           det J at the Q volume points;
//   M[e, i, j]           sum_q w_q det J Bu[q, i] Bu[q, j]   (MassIntegrator);
//   ml[e, i]             sum_j M[e, i, j]                      (its row sums);
//   K[e, i, j]           sum_q w_q Bu[q, i] (adj J v) . Gu[q, j]
//                        (ConvectionIntegrator, sign +1 in remap);
//   bdr[e, f, i, j]      sum_fq wvn[f, fq] Bf[fq, i] Bf[fq, j] on each face,
//                        wvn = w_fq max(0, v . n)  (the upwind face blocks).
// J, adj J, v at the points, the normals and every partial sum stay in
// registers and shared memory; each output is written once.
//
// Design. The geometry is the MeshGeom provider of mesh_geom.cuh with the
// velocity, the face pass and det J (VEL, FACE, DET): the tile's nodes and
// velocity go to shared memory, J, v_q and the face tangents come out of
// axis-by-axis contractions with the 1D Gauss-Lobatto tables, and the
// provider leaves va = adj(J) v and w_q det J at the volume points, vn = v . n
// at the face points and det J in shared memory (kernel 3's face variant
// forms the same vn; kernels 4 and 5 the same va). The matrices are tensor
// contractions too: with the 1D Bernstein tables B1, G1 [Q1, D] of the
// rule, M = sum over the points of w det J times B1[q_a, i_a] B1[q_a, j_a]
// on every axis a, K_b the same with w va_b and G1 in place of the second
// B1 on axis b, each face block the same on the face rule. They contract
// one rule axis at a time (3D: axis 2, then 1, then 0), so the work is
// yardstick_fa.matrix_macs's, ~31k multiply-adds an element at p=2 in 3D
// where the dense quadrature sums take ~370k:
//   stage A, one thread per (element, field, point line along axis 2): the
//     field's Q1 values contracted with both tables of axis 2 into the D^2
//     pairs (i2, j2) ([q0 q1][pair]); fields w det J, w va_0, w va_1 (B1
//     B1) and w va_2 (B1 G1). The faces: one thread per (element, face,
//     point line) contracts wvn along the face's second axis;
//   stage B (3D), one thread per (element, sum, q0, pair 2): along axis 1
//     into [q0][pair 1][pair 2], three sums: M's, K_0's (B1 B1) and K_1 +
//     K_2 (B1 G1 and B1 B1: both meet B1 B1 on axis 0, so they add here).
//     The faces' second contraction, into the staged blocks;
//   stage C, one thread per (element, i1, i2, column j): along axis 0 into
//     the D rows i0 of column j of M (or of K: G1 for K_0's sum, B1 for the
//     other), stored straight to global memory: the lanes of a warp hold
//     consecutive columns, so a row's nd entries are one contiguous run.
// ml follows M's rows: the same three contractions of w det J with S1[q, i]
// = B1[q, i] sum_j B1[q, j] (one row of the pair table summed over j), so no
// thread waits for a whole row of M. det J, the face blocks and ml are
// staged in shared memory and stored as the tile's contiguous rows, with
// 16-byte stores where aligned. Plain FMA in the working type, every sum in
// a fixed order; no tensor cores, no TF32.
//
// Tile and thread map. 256 threads a block, one tile of te elements a block
// (te = NT / Q1^(dim-1), the provider's point lines, as far as 110 KB of
// shared memory allow: 4 elements in f64 at p=2, 8 in f32), two blocks an
// SM. The shared arrays reuse three regions an element: the geometry,
// then stage B's sums; the provider's scratch, then stage A's partials; the
// staged outputs. Pair arrays are padded to an odd stride (D^2 | 1), so the
// stores of stage A, one thread a point line, fall in distinct banks.
// Compiled for mesh order 2 at the rules of p = 2..4 (Q1 = D + 2 in 3D,
// D + 1 in 2D), f32 and f64, dim 2 and 3; the operator launches it only
// there (ops/fa_assemble.engages) and keeps the plain version elsewhere.
//
// What bounds it on the H100: bytes. One launch at 64^3, p=2, f64 writes
// 2,096 values an element (M and K 729 each, the face blocks 486, det J
// 125, ml 27), 4.40 GB, and reads the nodes and the velocity: 4.74 GB,
// 1.41 ms at 3.35 TB/s; its 26.9 GFLOP take 0.40 ms at the f64 peak
// (utils/cost.fa_assemble_cost). Measured on an H100 80GB HBM3 at 700 W:
// 3.56 ms in f64 (40% of the bound; the plain chain 92.4 ms), 2.42 ms in
// f32 (29%). What holds it: a tile's load, provider passes, three
// contraction stages and stores run one after another between barriers,
// two blocks an SM, the provider's point-line pass on 100 of a block's
// 256 threads in f64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/build.py does this at first use).

#include "mesh_geom.cuh"

namespace {

using namespace remhos;

// The 1D Bernstein tables at the rule, [Q1][D] each, in the order of the
// packed block (ops/fa_assemble.BERNSTEIN_TABLES): values, derivatives, and
// the values times their row sums.
constexpr int NBT = 3;

// The compile-time sizes of one instance: DIM, Q1 points and D Bernstein
// functions per axis (mesh order 2: m1 = 3 nodes per axis).
template <int DIM, int QT>
struct Sz {
  static constexpr int Q1 = QT;
  static constexpr int D = QT - (DIM == 3 ? 2 : 1);
  static constexpr int M1 = 3;
  static constexpr int QV = DIM == 3 ? Q1 * Q1 * Q1 : Q1 * Q1;
  static constexpr int ND = DIM == 3 ? D * D * D : D * D;
  static constexpr int NF = 2 * DIM;
  static constexpr int QF = DIM == 3 ? Q1 * Q1 : Q1;
  static constexpr int FD = DIM == 3 ? D * D : D;
  static constexpr int NL = DIM == 3 ? Q1 * Q1 : Q1;   // point lines, stage A
  static constexpr int PP = (D * D) | 1;                // padded pair stride
  // stage A: 4 fields (3 in 2D) of [NL][PP], ml's partials [NL][D], the
  // faces' first contraction [NF][Q1][PP] (3D)
  static constexpr int NFLD = DIM + 1;
  static constexpr int NA = NFLD * NL * PP;
  static constexpr int NAML = NL * D;
  static constexpr int NF1 = DIM == 3 ? NF * Q1 * PP : 0;
  // stage B (3D): three sums of [Q1][D^2][PP], ml's [Q1][D^2]
  static constexpr int NB = DIM == 3 ? 3 * Q1 * D * D * PP : 0;
  static constexpr int NBML = DIM == 3 ? Q1 * D * D : 0;
  // the provider's arrays: va [DIM][QV], w det J [QV], vn [NF][QF]
  static constexpr int NGEO = (DIM + 1) * QV + NF * QF;
  static constexpr int NBD = NF * FD * FD;              // the face blocks
};

template <typename T, int DIM, int QT>
struct Args {
  MeshGeom<T, DIM, 3, QT, true, true, true> g;
  const T* bsf;    // [B1 | G1 | S1], [Q1][D] each
  const T* w_fq;   // [Qf]
  T* detJ;         // [E, Q] out
  T* M;            // [E, nd, nd] out
  T* ml;           // [E, nd] out
  T* K;            // [E, nd, nd] out
  T* bdr;          // [E, nf, fd, fd] out
  int E, te;
  int o_bt, o_r1, o_r3, o_r5;
};

// The shared memory of a tile of te elements: the mesh tables, the
// Bernstein tables, then three regions of te elements each (R1: the
// provider's va, w det J and vn, then stage B's sums; R3: the provider's
// scratch, then stage A's partials and the faces' first contraction; R5:
// the staged det J, face blocks and ml). Sets the offsets in *a; returns
// the bytes.
template <typename T, int DIM, int QT>
size_t layout(Args<T, DIM, QT>* a, int te) {
  using S = Sz<DIM, QT>;
  const int r1 = S::NGEO > S::NB + S::NBML ? S::NGEO : S::NB + S::NBML;
  const int sx = a->g.sx;
  const int r3a = S::NA + S::NAML + S::NF1;
  int o = al4(2 * S::Q1 * S::M1);
  a->o_bt = o;
  o += al4(NBT * S::Q1 * S::D);
  a->o_r1 = o;
  o += al4(te * r1);
  a->o_r3 = o;
  o += al4(te * (sx > r3a ? sx : r3a));
  a->o_r5 = o;
  o += al4(te * S::QV) + al4(te * S::NBD) + al4(te * S::ND);
  return (size_t)o * sizeof(T);
}

// n entries from shared src to global dst, 16 bytes a store where both are
// 16-byte aligned and n fills whole stores.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const T* src, int n) {
  constexpr int VEC = 16 / sizeof(T);
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src) |
        (size_t)n * sizeof(T)) % 16) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < n / VEC; i += NT) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
  }
}

// out[i][j] += sum_q in[q] B1[q][i] X[q][j], the pair contraction of one
// line of Q1 values with two 1D tables (row B1, column X).
template <typename T, int Q1, int D>
__device__ __forceinline__ void pair_sum(const T (&in)[Q1], const T* B1,
                                         const T* X, T (&out)[D][D]) {
#pragma unroll
  for (int q = 0; q < Q1; ++q) {
    T xj[D];
#pragma unroll
    for (int j = 0; j < D; ++j) xj[j] = X[q * D + j];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const T t = in[q] * B1[q * D + i];
#pragma unroll
      for (int j = 0; j < D; ++j) out[i][j] = fmaT(t, xj[j], out[i][j]);
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void zero(T (&out)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out[i][j] = T(0);
}

template <typename T, int DIM, int QT>
__global__ void __launch_bounds__(NT, 2)
fa_assemble_kernel(const __grid_constant__ Args<T, DIM, QT> a) {
  using S = Sz<DIM, QT>;
  constexpr int Q1 = S::Q1, D = S::D, QV = S::QV, ND = S::ND, NF = S::NF;
  constexpr int QF = S::QF, FD = S::FD, NL = S::NL, PP = S::PP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int te = a.te, tid = threadIdx.x;
  T* r1 = sm + a.o_r1;
  T* r3 = sm + a.o_r3;
  T* r5 = sm + a.o_r5;
  MeshGeom<T, DIM, 3, QT, true, true, true> g = a.g;
  g.s_tab = sm;
  g.s_va = r1;
  g.s_wd = r1 + te * DIM * QV;
  g.s_vn = r1 + te * (DIM + 1) * QV;
  g.s_scr = r3;
  g.s_dj = r5;                                   // the staged det J
  T* s_bdr = r5 + al4(te * QV);
  T* s_ml = s_bdr + al4(te * S::NBD);
  T* bt = sm + a.o_bt;
  const T* B1 = bt;
  const T* G1 = bt + Q1 * D;
  const T* S1 = bt + 2 * Q1 * D;
  g.init();
  for (int i = tid; i < NBT * Q1 * D; i += NT) bt[i] = __ldg(a.bsf + i);
  const int e_base = blockIdx.x * te;
  const int ne = min(te, a.E - e_base);
  g.load(e_base, ne);                            // its barriers cover bt
  __syncthreads();

  // stage A: the fields along the last axis; the faces' first contraction
  T* sA = r3;
  T* sAml = r3 + te * S::NA;
  T* sF1 = sAml + te * S::NAML;
  {
    const int nA = ne * S::NFLD * NL;
    const int nFace = ne * NF * (DIM == 3 ? Q1 : D);
    for (int idx = tid; idx < nA + nFace; idx += NT) {
      if (idx < nA) {
        const int e = idx / (S::NFLD * NL), r = idx - e * S::NFLD * NL;
        const int f = r / NL, l = r - f * NL;
        T in[Q1];
#pragma unroll
        for (int k = 0; k < Q1; ++k) {
          const int q = l + NL * k;
          in[k] = f == 0 ? g.s_wd[e * QV + q]
                         : __ldg(g.w_q + q) *
                               g.s_va[(e * DIM + f - 1) * QV + q];
        }
        T out[D][D];
        zero(out);
        pair_sum<T, Q1, D>(in, B1, f == DIM ? G1 : B1, out);
        T* o = sA + e * S::NA + (f * NL + l) * PP;
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = 0; j < D; ++j) o[i * D + j] = out[i][j];
        if (f == 0) {
#pragma unroll
          for (int i = 0; i < D; ++i) {
            T m = T(0);
#pragma unroll
            for (int k = 0; k < Q1; ++k) m = fmaT(in[k], S1[k * D + i], m);
            sAml[e * S::NAML + l * D + i] = m;
          }
        }
      } else if constexpr (DIM == 3) {
        // (element, face, q0): wvn along the face's second axis
        const int k = idx - nA;
        const int e = k / (NF * Q1), r = k - e * NF * Q1;
        const int f = r / Q1, q0 = r - f * Q1;
        T in[Q1];
#pragma unroll
        for (int q1 = 0; q1 < Q1; ++q1) {
          const int fq = q0 + Q1 * q1;
          const T vn = g.s_vn[(e * NF + f) * QF + fq];
          in[q1] = __ldg(a.w_fq + fq) * (vn > T(0) ? vn : T(0));
        }
        T out[D][D];
        zero(out);
        pair_sum<T, Q1, D>(in, B1, B1, out);
        T* o = sF1 + e * S::NF1 + (f * Q1 + q0) * PP;
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = 0; j < D; ++j) o[i * D + j] = out[i][j];
      } else {
        // 2D (element, face, column j0): the face block's column
        const int k = idx - nA;
        const int e = k / (NF * D), r = k - e * NF * D;
        const int f = r / D, j0 = r - f * D;
        T out[D];
#pragma unroll
        for (int i = 0; i < D; ++i) out[i] = T(0);
#pragma unroll
        for (int q = 0; q < Q1; ++q) {
          const T vn = g.s_vn[(e * NF + f) * QF + q];
          const T c = __ldg(a.w_fq + q) * (vn > T(0) ? vn : T(0)) *
                      B1[q * D + j0];
#pragma unroll
          for (int i = 0; i < D; ++i) out[i] = fmaT(c, B1[q * D + i], out[i]);
        }
        T* o = s_bdr + e * S::NBD + f * FD * FD + j0;
#pragma unroll
        for (int i = 0; i < D; ++i) o[i * FD] = out[i];
      }
    }
  }
  __syncthreads();

  // stage B (3D): along axis 1; the faces' blocks
  T* sB = r1;
  T* sBml = r1 + te * S::NB;
  if constexpr (DIM == 3) {
    constexpr int P2 = D * D;
    const int nB = ne * 3 * Q1 * P2;
    const int nMl = ne * Q1 * D;
    const int nFace = ne * NF * D * FD;
    for (int idx = tid; idx < nB + nMl + nFace; idx += NT) {
      if (idx < nB) {
        // (element, sum s, q0, pair 2): s 0 M's, 1 K_0's, 2 K_1 + K_2
        const int e = idx / (3 * Q1 * P2), r = idx - e * 3 * Q1 * P2;
        const int s = r / (Q1 * P2), r2 = r - s * Q1 * P2;
        const int q0 = r2 / P2, p2 = r2 - q0 * P2;
        const T* A = sA + e * S::NA + p2;
        T in[Q1];
        T out[D][D];
        zero(out);
#pragma unroll
        for (int q1 = 0; q1 < Q1; ++q1)
          in[q1] = A[(s * NL + q0 + Q1 * q1) * PP];
        pair_sum<T, Q1, D>(in, B1, s == 2 ? G1 : B1, out);
        if (s == 2) {
#pragma unroll
          for (int q1 = 0; q1 < Q1; ++q1)
            in[q1] = A[(3 * NL + q0 + Q1 * q1) * PP];
          pair_sum<T, Q1, D>(in, B1, B1, out);
        }
        T* o = sB + e * S::NB + ((s * Q1 + q0) * P2) * PP + p2;
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = 0; j < D; ++j) o[(i * D + j) * PP] = out[i][j];
      } else if (idx < nB + nMl) {
        // ml's (element, q0, i2): along axis 1 into [q0][i1 + D i2]
        const int k = idx - nB;
        const int e = k / (Q1 * D), r = k - e * Q1 * D;
        const int q0 = r / D, i2 = r - q0 * D;
        T out[D];
#pragma unroll
        for (int i = 0; i < D; ++i) out[i] = T(0);
#pragma unroll
        for (int q1 = 0; q1 < Q1; ++q1) {
          const T x = sAml[e * S::NAML + (q0 + Q1 * q1) * D + i2];
#pragma unroll
          for (int i = 0; i < D; ++i) out[i] = fmaT(x, S1[q1 * D + i], out[i]);
        }
#pragma unroll
        for (int i = 0; i < D; ++i)
          sBml[e * S::NBML + q0 * D * D + i + D * i2] = out[i];
      } else {
        // the faces' (element, face, i1, column j = j0 + D j1): rows i0
        const int k = idx - nB - nMl;
        const int e = k / (NF * D * FD), r = k - e * NF * D * FD;
        const int f = r / (D * FD), r2 = r - f * D * FD;
        const int i1 = r2 / FD, j = r2 - i1 * FD;
        const int j1 = j / D, j0 = j - j1 * D;
        const T* F1 = sF1 + e * S::NF1 + f * Q1 * PP + i1 * D + j1;
        T out[D];
#pragma unroll
        for (int i = 0; i < D; ++i) out[i] = T(0);
#pragma unroll
        for (int q0 = 0; q0 < Q1; ++q0) {
          const T c = F1[q0 * PP] * B1[q0 * D + j0];
#pragma unroll
          for (int i = 0; i < D; ++i) out[i] = fmaT(c, B1[q0 * D + i], out[i]);
        }
        T* o = s_bdr + e * S::NBD + f * FD * FD + (D * i1) * FD + j;
#pragma unroll
        for (int i = 0; i < D; ++i) o[i * FD] = out[i];
      }
    }
    __syncthreads();
  }

  // stage C: along axis 0, columns of M and K straight to global memory;
  // ml's rows into shared memory. In 2D stage A's partials are the input.
  {
    constexpr int NR = ND / D;                   // (i1[, i2]) row groups
    const int nM = ne * NR * ND;
    const int nMl = ne * NR;
    const T* src = DIM == 3 ? sB : sA;
    const int stride = DIM == 3 ? S::NB : S::NA;
    // a sum's [q0] stride and the offset of (pair 1, pair 2) in it
    constexpr int SQ = DIM == 3 ? D * D * PP : PP;
    constexpr int SS = DIM == 3 ? Q1 * SQ : NL * PP;
    for (int idx = tid; idx < 2 * nM + nMl; idx += NT) {
      if (idx < 2 * nM) {
        const bool isK = idx >= nM;
        const int k = isK ? idx - nM : idx;
        const int e = k / (NR * ND), r = k - e * NR * ND;
        const int rg = r / ND, j = r - rg * ND;  // rg = i1 + D i2
        const int j0 = j % D, jr = j / D;        // jr = j1 + D j2
        int off;
        if constexpr (DIM == 3) {
          const int i1 = rg % D, i2 = rg / D;
          const int j1 = jr % D, j2 = jr / D;
          off = (i1 * D + j1) * PP + i2 * D + j2;
        } else {
          off = rg * D + jr;
        }
        const T* b = src + e * stride + off;
        T out[D];
#pragma unroll
        for (int i = 0; i < D; ++i) out[i] = T(0);
        if (!isK) {
#pragma unroll
          for (int q0 = 0; q0 < Q1; ++q0) {
            const T c = b[q0 * SQ] * B1[q0 * D + j0];
#pragma unroll
            for (int i = 0; i < D; ++i)
              out[i] = fmaT(c, B1[q0 * D + i], out[i]);
          }
        } else {
#pragma unroll
          for (int q0 = 0; q0 < Q1; ++q0) {
            const T c = fmaT(b[SS + q0 * SQ], G1[q0 * D + j0],
                             b[2 * SS + q0 * SQ] * B1[q0 * D + j0]);
#pragma unroll
            for (int i = 0; i < D; ++i)
              out[i] = fmaT(c, B1[q0 * D + i], out[i]);
          }
        }
        T* o = (isK ? a.K : a.M) + (size_t)(e_base + e) * ND * ND +
               (size_t)(rg * D) * ND + j;
#pragma unroll
        for (int i = 0; i < D; ++i) o[i * ND] = out[i];
      } else {
        const int k = idx - 2 * nM;
        const int e = k / NR, rg = k - e * NR;
        const T* b = DIM == 3 ? sBml + e * S::NBML + rg
                              : sAml + e * S::NAML + rg;
        constexpr int SM = DIM == 3 ? D * D : D;
        T out[D];
#pragma unroll
        for (int i = 0; i < D; ++i) out[i] = T(0);
#pragma unroll
        for (int q0 = 0; q0 < Q1; ++q0) {
          const T x = b[q0 * SM];
#pragma unroll
          for (int i = 0; i < D; ++i) out[i] = fmaT(x, S1[q0 * D + i], out[i]);
        }
#pragma unroll
        for (int i = 0; i < D; ++i) s_ml[e * ND + rg * D + i] = out[i];
      }
    }
  }
  __syncthreads();

  // the staged rows: det J, the face blocks, ml
  store_rows(a.detJ + (size_t)e_base * QV, g.s_dj, ne * QV);
  store_rows(a.bdr + (size_t)e_base * S::NBD, s_bdr, ne * S::NBD);
  store_rows(a.ml + (size_t)e_base * ND, s_ml, ne * ND);
}

template <typename T, int DIM, int QT>
int launch_as(Args<T, DIM, QT>& a, cudaStream_t stream) {
  using S = Sz<DIM, QT>;
  a.te = choose_te(NT / S::NL, SMEM_BUDGET,
                   [&](int te) { return layout(&a, te); });
  const size_t smem = layout(&a, a.te);
  if (smem > SMEM_MAX) return -3;
  const void* fn =
      reinterpret_cast<const void*>(&fa_assemble_kernel<T, DIM, QT>);
  if (smem > 48 * 1024) {
    const int rc = allow_smem(fn, smem);
    if (rc != 0) return rc;
  }
  const int blocks = (a.E + a.te - 1) / a.te;
  fa_assemble_kernel<T, DIM, QT><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

struct Ptrs {
  const void *xs, *v, *msf, *bsf, *w_q, *w_fq;
  const int* fdesc;
  void *detJ, *M, *ml, *K, *bdr;
};

template <typename T, int DIM, int QT>
int launch_sized(const Ptrs& p, int E, cudaStream_t stream) {
  Args<T, DIM, QT> a;
  a.g.xs = static_cast<const T*>(p.xs);
  a.g.v = static_cast<const T*>(p.v);
  a.g.msf = static_cast<const T*>(p.msf);
  a.g.w_q = static_cast<const T*>(p.w_q);
  a.g.fdesc = p.fdesc;
  a.g.mode = T(1);
  a.g.m1_ = 3;
  a.g.Q1_ = QT;
  a.g.with_det = 1;
  a.g.sx = mesh_scratch(DIM, 3, QT, true, true);
  a.g.s_tab = a.g.s_va = a.g.s_wd = a.g.s_scr = a.g.s_vn = a.g.s_dj =
      nullptr;
  a.bsf = static_cast<const T*>(p.bsf);
  a.w_fq = static_cast<const T*>(p.w_fq);
  a.detJ = static_cast<T*>(p.detJ);
  a.M = static_cast<T*>(p.M);
  a.ml = static_cast<T*>(p.ml);
  a.K = static_cast<T*>(p.K);
  a.bdr = static_cast<T*>(p.bdr);
  a.E = E;
  return launch_as(a, stream);
}

template <typename T, int DIM>
int launch(const Ptrs& p, int E, int nm, int Q, int m1, int Q1, int D,
           cudaStream_t stream) {
  if (E <= 0) return 0;
  int rc = check_mesh_sizes(DIM, nm, Q, m1, Q1);
  if (rc != 0) return rc;
  constexpr int X = DIM == 3 ? 2 : 1;
  if (D != Q1 - X) return -5;
  switch (mesh_size_case(DIM, m1, Q1)) {
    case 3 + X: return launch_sized<T, DIM, 3 + X>(p, E, stream);
    case 4 + X: return launch_sized<T, DIM, 4 + X>(p, E, stream);
    case 5 + X: return launch_sized<T, DIM, 5 + X>(p, E, stream);
    default: return -5;                  // no runtime-size instance
  }
}

}  // namespace

extern "C" {

// xs, v [E, nm, dim] (the moved nodes and the nodal mesh velocity), msf
// (the packed 1D mesh tables, ops/tables.MESH_TABLES), bsf (the packed 1D
// Bernstein tables, ops/fa_assemble.BERNSTEIN_TABLES), w_q[Q], the face
// descriptors fdesc (int32 [2 dim, 5], ops/tables.face_descriptors), w_fq[Qf]
// -> detJ[E, Q], M[E, nd, nd], ml[E, nd], K[E, nd, nd], bdr[E, 2 dim, fd,
// fd]; sizes: E, nm, Q, m1, Q1, D. Returns 0, a CUDA error code (> 0), or
// < 0 for a bad argument (-1: sizes; -2: type or dimension; -3: shared
// memory; -5: not mesh order 2 at a compiled rule).
int remhos_fa_assemble(int dtype_bytes, int dim, const void* xs,
                       const void* v, const void* msf, const void* bsf,
                       const void* w_q, const int* fdesc, const void* w_fq,
                       void* detJ, void* M, void* ml, void* K, void* bdr,
                       const int* sizes, int nsizes, void* stream) {
  if (nsizes != 6) return -1;
  const Ptrs p{xs, v, msf, bsf, w_q, w_fq, fdesc, detJ, M, ml, K, bdr};
  const int E = sizes[0], nm = sizes[1], Q = sizes[2], m1 = sizes[3],
            Q1 = sizes[4], D = sizes[5];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REMHOS_FA(T, DM) return launch<T, DM>(p, E, nm, Q, m1, Q1, D, s)
  if (dtype_bytes == 4 && dim == 3) REMHOS_FA(float, 3);
  if (dtype_bytes == 8 && dim == 3) REMHOS_FA(double, 3);
  if (dtype_bytes == 4 && dim == 2) REMHOS_FA(float, 2);
  if (dtype_bytes == 8 && dim == 2) REMHOS_FA(double, 2);
#undef REMHOS_FA
  return -2;
}

const char* remhos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
