// The sum-factorized mesh geometry from the nodes: a geometry provider of
// stage_core.cuh (kernel 4, geom_conv.cu, the volume part; kernel 5,
// stage_ho_nodes.cu, the volume and the face part) whose load stage alone
// is kernel 3 (wdet.cu; its face variant with the face part).
//
// Counterpart of the geometry inside _geom_conv_kernel (:55),
// _stage_ho_kernel (:265) and _wdet_kernel (:1110) of
// remhos_tpu/ops/pallas_kernels.py.
//
// For one tile of elements, from the nodes xs (and the nodal velocity v)
// staged in shared memory, it computes at the Q1^dim volume points
//   J[d][b] = sum_n xs[n][d] Gm[q, n, b]     all dim^2 Jacobian entries,
//   v_q[d]  = sum_n v[n][d] Bm[q, n]         (with v),
// then, at every point, the closed-form cofactors cof[d][b],
//   va[b]   = mode sum_d cof[d][b] v_q[d]    (with v) and
//   wd      = w_q det J                      (with_det),
// into shared memory: va [te][dim][Qv], wd [te][Qv]; with the face part, at
// the Q1^(dim-1) points of each of the nf faces
//   T1, T2  = the face's tangents (3D; 2D: T1), from its nodes,
//   vn      = mode sign v . (T1 x T2)        (2D: v . (T1_1, -T1_0)),
// into vn [te][nf Qf]. volume() and face() read one point, as the core's
// passes ask.
//
// The mesh elements are tensor products too (remhos_torch/discretization.py:
// Bm and Gm are tensor_mixed of the 1D Gauss-Lobatto Lagrange tables Bm1,
// Gm1 [Q1, m1], m1 = mesh order + 1; ops/tables.mesh_factor_tables), so J
// and v_q come out of axis-by-axis contractions instead of a length-nm dot
// with a table load per entry and point (kernel 5's first geometry,
// 0.29 of its 0.43 ms at p=3, f32, 24^3):
//   pass 0, one thread per (element, node line along axis 0, point q0): for
//     each coordinate d, x contracted with Bm1 and with Gm1 along axis 0
//     (XB, XG) and v with Bm1 (VB), [te][a][d][m1^(dim-1)][Q1]; the nodes
//     relative to the element's first one (J does not change; f32 keeps
//     its relative accuracy where J is O(h) and the coordinates O(1));
//   pass 1, one thread per (element, point line along the last axis): in 3D
//     the axis-1 contractions at the thread's q1, XB -> XBB (Bm1), XBG (Gm1),
//     XG -> XGB (Bm1), VB -> VBB, kept in registers: each partial contraction
//     feeds the three derivative directions; then along the last axis, point
//     by point, J[d][0] = XGB Bm1, J[d][1] = XBG Bm1, J[d][2] = XBB Gm1, v_q =
//     VBB Bm1 and the pointwise algebra (2D: XG Bm1, XB Gm1, VB Bm1).
// The face part (face_pass, beside pass 0) uses that the nodes are
// Gauss-Lobatto: a face's trace is its m1^(dim-1) nodes (index 0 or m1 - 1
// along the normal axis), so the tangents are axis contractions of those
// nodes, Gm1 along the tangent's axis and Bm1 along the other. One thread
// per (element, face, point q0 along the face's first axis) keeps the
// axis-0 partials in registers and walks the points along the second. The
// face descriptors (ops/tables.face_descriptors, checked against the dense
// face tables when they are made) give each face its normal axis, side,
// tangent axes and reference-normal sign.
// At mesh order 2 and p=3 in 3D (Q = 216, nm = 27) this is ~13k
// multiply-adds an element for J and v_q and ~9k for the face tangents and
// velocities, where the dense dots take ~70k and ~52k. The 1D tables live
// in shared memory, staged once per block; a table row read inside a pass
// is the same for the whole warp (a broadcast) and each feeds dim^2 + dim
// multiply-adds. The sizes (m1, Q1) are template parameters MT, QT for mesh
// order 2 at the compiled orders of the core (p = 2..4); MT = QT = 0 runs
// the same code with runtime sizes up to DMAX, QMAX (they spill: kernel 4
// at mesh order 3 in f64 is no faster than its plain version); kernel 5
// also takes MT = 3, QT = 0 (mesh order 2 beside the core's runtime
// sizes). Plain FMA in the working type, every sum in a fixed order; no
// tensor cores, no TF32.
//
// What bounds its kernels on the H100, and what was tried: the head notes
// of wdet.cu, geom_conv.cu and stage_ho_nodes.cu.

#pragma once

#include "stage_core.cuh"

namespace remhos {

// Entries of T per element of the provider's scratch (the staged nodes and
// velocity and pass 0's results), dead once load() returns. The velocity
// is staged with `vel` or `face`; pass 0 contracts it only with `vel`.
__host__ __device__ inline int mesh_scratch(int dim, int m1, int Q1,
                                            bool vel, bool face = false) {
  const int nm = dim == 3 ? m1 * m1 * m1 : m1 * m1;
  const int nlm = dim == 3 ? m1 * m1 : m1;
  const int na = vel ? 3 : 2;
  return (vel || face ? 2 : 1) * nm * dim + na * dim * nlm * Q1;
}

// The entries of a face descriptor (ops/tables.face_descriptors): the
// normal axis k, the side (0: the low end, node 0 along k; 1: the high end,
// node m1 - 1), the axes of the first and second tangent (3D: (k+1)%3,
// (k+2)%3; 2D: 1 - k and -1) and the reference-normal sign (+-1).
constexpr int FACE_DESC = 5;

// VEL: with the velocity and va (kernels 4 and 5); without, J and w_q det J
// alone (kernel 3). FACE: also vn at the face points, from the staged nodes
// and velocity (kernel 5, with VEL; kernel 3's face variant, without). DET:
// also det J itself into s_dj (the element assembly, fa_assemble.cu, with
// VEL and FACE).
template <typename T, int DIM, int MT, int QT, bool VEL, bool FACE = false,
          bool DET = false>
struct MeshGeom {
  static constexpr int MM = MT ? MT : DMAX;    // register extents
  static constexpr int QM = QT ? QT : QMAX;
  const T* xs;     // [E, nm, DIM]
  const T* v;      // [E, nm, DIM] (VEL or FACE)
  const T* msf;    // [Bm1 | Gm1], [Q1, m1] each (ops/tables.MESH_TABLES)
  const T* w_q;    // [Q]
  const int* fdesc;  // [nf][FACE_DESC] the face descriptors (FACE; null:
                     // no face geometry, the core runs with_face == 0)
  T mode;          // the volume sign and flux mode: va is mode adj(J) v,
                   // vn mode v . n
  int m1_, Q1_;
  int with_det;    // also w_q det J into s_wd
  int sx;          // per-element stride of the scratch (mesh_scratch)
  // shared memory, set by the kernel
  T* s_tab;        // [2][Q1][m1]
  T* s_va;         // [te][DIM][Qv]
  T* s_wd;         // [te][Qv]
  T* s_scr;        // [te][sx] scratch
  T* s_vn;         // [te][nf Qf] (FACE)
  T* s_dj;         // [te][Qv] det J (DET)

  __device__ __forceinline__ int m1() const { return MT ? MT : m1_; }
  __device__ __forceinline__ int Q1() const { return QT ? QT : Q1_; }

  // The 1D tables into shared memory, once per block; load() places the
  // barrier before they are read.
  __device__ __forceinline__ void init() const {
    const int n = 2 * Q1() * m1();
    for (int i = threadIdx.x; i < n; i += NT) s_tab[i] = __ldg(msf + i);
  }

  // Passes 0 and 1 for the ne elements of the tile at e_base: s_va and s_wd
  // hold the tile's geometry at the end (the caller's barrier follows).
  __device__ __forceinline__ void load(int e_base, int ne) const {
    const int m1 = this->m1(), Q1 = this->Q1();
    const int nm = DIM == 3 ? m1 * m1 * m1 : m1 * m1;
    const int nlm = DIM == 3 ? m1 * m1 : m1;   // node lines along axis 0
    const int NL = DIM == 3 ? Q1 * Q1 : Q1;    // point lines, last axis
    const int Qv = NL * Q1;
    const int row = nm * DIM;
    constexpr bool vel = VEL;
    constexpr bool staged_v = VEL || FACE;     // v in the scratch
    const int tid = threadIdx.x;
    T* s_x = s_scr;                            // [nm][DIM] an element
    T* s_v = s_scr + row;
    T* s_p0 = s_scr + (staged_v ? 2 : 1) * row;  // [na][DIM][nlm][Q1]
    const T* Bt = s_tab;
    const T* Gt = s_tab + Q1 * m1;

    // the tile's rows, as stored
    {
      const size_t g0 = (size_t)e_base * row;
      for (int i = tid; i < ne * row; i += NT) {
        const int e = i / row, j = i - e * row;
        s_x[e * sx + j] = xs[g0 + i];
        if constexpr (staged_v) s_v[e * sx + j] = v[g0 + i];
      }
    }
    __syncthreads();

    // pass 0: axis 0, one thread per (element, node line, q0); q0 fastest,
    // so the lanes of a warp read the same nodes and store consecutively.
    // The nodes enter relative to the element's first node: every Jacobian
    // entry carries one derivative table, whose 1D factor sums to 0, so J
    // is unchanged, but the contracted values are O(h), not O(1), and f32
    // rounds J (O(h)) to O(h) eps where absolute coordinates cost O(eps).
    {
      const int per = nlm * Q1;
      for (int idx = tid; idx < ne * per; idx += NT) {
        const int e = idx / per, r = idx - e * per;
        const int nl = r / Q1, q0 = r - nl * Q1;
        T b[MM], g[MM];
#pragma unroll
        for (int k = 0; k < MM; ++k)
          if (k < m1) {
            b[k] = Bt[q0 * m1 + k];
            g[k] = Gt[q0 * m1 + k];
          }
        const T* xe = s_x + e * sx + nl * m1 * DIM;
        const T* ve = s_v + e * sx + nl * m1 * DIM;
        T* pe = s_p0 + e * sx + nl * Q1 + q0;
        const int sa = DIM * nlm * Q1, sd = nlm * Q1;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const T xo = s_x[e * sx + d];
          T ab = T(0), ag = T(0), av = T(0);
#pragma unroll
          for (int k = 0; k < MM; ++k)
            if (k < m1) {
              const T x = xe[k * DIM + d] - xo;
              ab = fmaT(x, b[k], ab);
              ag = fmaT(x, g[k], ag);
              if constexpr (vel) av = fmaT(ve[k * DIM + d], b[k], av);
            }
          pe[d * sd] = ab;
          pe[sa + d * sd] = ag;
          if constexpr (vel) pe[2 * sa + d * sd] = av;
        }
      }
    }
    if constexpr (FACE) {
      if (fdesc != nullptr) face_pass(ne);
    }
    __syncthreads();

    // pass 1: one thread per (element, point line along the last axis)
    for (int idx = tid; idx < ne * NL; idx += NT) {
      const int e = idx / NL, l = idx - e * NL;
      const int q0 = DIM == 3 ? l % Q1 : l;
      const T* pe = s_p0 + e * sx + q0;
      const int sa = DIM * nlm * Q1, sd = nlm * Q1;
      // the line's inputs along the last axis, per coordinate d and node k:
      // cb (B on the other axes), c0 (G on axis 0), c1 (3D: G on axis 1),
      // cv (the velocity, B on the other axes)
      T cb[DIM][MM], c0[DIM][MM], c1[DIM][MM], cv[DIM][MM];
      if constexpr (DIM == 3) {
        const int q1 = l / Q1;
        T b1[MM], g1[MM];
#pragma unroll
        for (int k = 0; k < MM; ++k)
          if (k < m1) {
            b1[k] = Bt[q1 * m1 + k];
            g1[k] = Gt[q1 * m1 + k];
          }
#pragma unroll
        for (int d = 0; d < DIM; ++d)
#pragma unroll
          for (int k2 = 0; k2 < MM; ++k2)
            if (k2 < m1) {
              T sbb = T(0), sbg = T(0), sgb = T(0), svb = T(0);
#pragma unroll
              for (int k1 = 0; k1 < MM; ++k1)
                if (k1 < m1) {
                  const int o = d * sd + (k1 + m1 * k2) * Q1;
                  const T xb = pe[o], xg = pe[sa + o];
                  sbb = fmaT(xb, b1[k1], sbb);
                  sbg = fmaT(xb, g1[k1], sbg);
                  sgb = fmaT(xg, b1[k1], sgb);
                  if constexpr (vel) svb = fmaT(pe[2 * sa + o], b1[k1], svb);
                }
              cb[d][k2] = sbb;
              c1[d][k2] = sbg;
              c0[d][k2] = sgb;
              cv[d][k2] = svb;
            }
      } else {
#pragma unroll
        for (int d = 0; d < DIM; ++d)
#pragma unroll
          for (int k = 0; k < MM; ++k)
            if (k < m1) {
              const int o = d * sd + k * Q1;
              cb[d][k] = pe[o];
              c0[d][k] = pe[sa + o];
              if constexpr (vel) cv[d][k] = pe[2 * sa + o];
              c1[d][k] = T(0);
            }
      }
      T* va_e = s_va + e * DIM * Qv;
      T* wd_e = s_wd + e * Qv;
#pragma unroll
      for (int q = 0; q < QM; ++q)
        if (q < Q1) {
          T bl[MM], gl[MM];
#pragma unroll
          for (int k = 0; k < MM; ++k)
            if (k < m1) {
              bl[k] = Bt[q * m1 + k];
              gl[k] = Gt[q * m1 + k];
            }
          T J[DIM][DIM], vq[DIM];
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            T j0 = T(0), j1 = T(0), j2 = T(0), vv = T(0);
#pragma unroll
            for (int k = 0; k < MM; ++k)
              if (k < m1) {
                j0 = fmaT(c0[d][k], bl[k], j0);
                if constexpr (DIM == 3) {
                  j1 = fmaT(c1[d][k], bl[k], j1);
                  j2 = fmaT(cb[d][k], gl[k], j2);
                } else {
                  j1 = fmaT(cb[d][k], gl[k], j1);
                }
                if constexpr (vel) vv = fmaT(cv[d][k], bl[k], vv);
              }
            J[d][0] = j0;
            J[d][1] = j1;
            if constexpr (DIM == 3) J[d][2] = j2;
            vq[d] = vv;
          }
          const int qp = l + NL * q;
          T det;
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
            det = J[0][0] * cof[0][0] + J[0][1] * cof[0][1] +
                  J[0][2] * cof[0][2];
            if constexpr (vel) {
#pragma unroll
              for (int b = 0; b < 3; ++b)
                va_e[b * Qv + qp] =
                    mode * (cof[0][b] * vq[0] + cof[1][b] * vq[1] +
                            cof[2][b] * vq[2]);
            }
          } else {
            // cof = ((J11, -J10), (-J01, J00))
            det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
            if constexpr (vel) {
              va_e[qp] = mode * (J[1][1] * vq[0] - J[0][1] * vq[1]);
              va_e[Qv + qp] = mode * (J[0][0] * vq[1] - J[1][0] * vq[0]);
            }
          }
          if (with_det) wd_e[qp] = __ldg(w_q + qp) * det;
          if constexpr (DET) s_dj[e * Qv + qp] = det;
        }
    }
  }

  // va[b] and w_q det J (1 without with_det) at volume point q of tile
  // element e
  __device__ __forceinline__ void volume(int e, int, int q, T* va,
                                         T& wd) const {
    const int Q1 = this->Q1();
    const int Qv = DIM == 3 ? Q1 * Q1 * Q1 : Q1 * Q1;
#pragma unroll
    for (int b = 0; b < DIM; ++b) va[b] = s_va[(e * DIM + b) * Qv + q];
    wd = with_det ? s_wd[e * Qv + q] : T(1);
  }

  // vn = mode v . n at every face point of the tile's ne elements into
  // s_vn, from the staged nodes (called by load(), beside pass 0). One
  // thread per (element, face, point q0 along the face's first in-face
  // axis a0, the lower of its two: the face points are numbered q0 + Q1 q1,
  // a0 fastest, as the dense face tables and the core number them). The
  // face's nodes are the m1^(DIM-1) with index 0 (or m1 - 1) along the
  // normal axis (Gauss-Lobatto nodes: the trace of the element's
  // interpolant is theirs). 3D: the partial contractions along a0 at q0
  // (x with Bm1 and Gm1, v with Bm1) stay in registers; then at each q1
  // along a1: the derivatives along a0 and a1, v, the normal sign T1 x T2
  // with T1, T2 the derivatives along the descriptor's tangent axes, vn.
  // 2D: the derivative along the face's axis, rotated. Coordinates relative
  // to the element's first node, as in pass 0.
  __device__ __forceinline__ void face_pass(int ne) const {
    constexpr int NF = 2 * DIM;
    const int m1 = this->m1(), Q1 = this->Q1();
    const int Qf = DIM == 3 ? Q1 * Q1 : Q1;
    const int per = NF * Q1;
    const T* Bt = s_tab;
    const T* Gt = s_tab + Q1 * m1;
    auto stride = [&](int ax) {
      return ax == 0 ? 1 : (ax == 1 ? m1 : m1 * m1);
    };
    for (int idx = threadIdx.x; idx < ne * per; idx += NT) {
      const int e = idx / per, r = idx - e * per;
      const int f = r / Q1, q0 = r - f * Q1;
      const int* fd = fdesc + f * FACE_DESC;
      const int k = __ldg(fd), side = __ldg(fd + 1);
      const int t1 = __ldg(fd + 2), t2 = __ldg(fd + 3);
      const T sgn = mode * static_cast<T>(__ldg(fd + 4));
      const int a0 = DIM == 3 ? min(t1, t2) : t1;
      const int base = side ? (m1 - 1) * stride(k) : 0;
      const int s0 = stride(a0);
      const T* xe = s_scr + e * sx;                 // the staged nodes
      const T* ve = xe + (DIM == 3 ? m1 * m1 * m1 : m1 * m1) * DIM;
      T* vn = s_vn + (e * NF + f) * Qf + q0;
      T b0[MM], g0[MM];
#pragma unroll
      for (int i = 0; i < MM; ++i)
        if (i < m1) {
          b0[i] = Bt[q0 * m1 + i];
          g0[i] = Gt[q0 * m1 + i];
        }
      if constexpr (DIM == 3) {
        const int s1 = stride(max(t1, t2));
        const bool swap = t1 > t2;       // T1 along a1
        T pb[MM][DIM], pg[MM][DIM], pv[MM][DIM];
#pragma unroll
        for (int i1 = 0; i1 < MM; ++i1)
          if (i1 < m1) {
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
              T ab = T(0), ag = T(0), av = T(0);
#pragma unroll
              for (int i0 = 0; i0 < MM; ++i0)
                if (i0 < m1) {
                  const int n = (base + i0 * s0 + i1 * s1) * DIM + d;
                  const T x = xe[n] - xe[d];
                  ab = fmaT(x, b0[i0], ab);
                  ag = fmaT(x, g0[i0], ag);
                  av = fmaT(ve[n], b0[i0], av);
                }
              pb[i1][d] = ab;
              pg[i1][d] = ag;
              pv[i1][d] = av;
            }
          }
#pragma unroll
        for (int q1 = 0; q1 < QM; ++q1)
          if (q1 < Q1) {
            T d0[DIM], d1[DIM], vq[DIM];
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
              T a = T(0), b = T(0), c = T(0);
#pragma unroll
              for (int i1 = 0; i1 < MM; ++i1)
                if (i1 < m1) {
                  const T bq = Bt[q1 * m1 + i1];
                  a = fmaT(pg[i1][d], bq, a);
                  b = fmaT(pb[i1][d], Gt[q1 * m1 + i1], b);
                  c = fmaT(pv[i1][d], bq, c);
                }
              d0[d] = swap ? b : a;      // T1
              d1[d] = swap ? a : b;      // T2
              vq[d] = c;
            }
            const T n0 = d0[1] * d1[2] - d0[2] * d1[1];
            const T n1 = d0[2] * d1[0] - d0[0] * d1[2];
            const T n2 = d0[0] * d1[1] - d0[1] * d1[0];
            vn[Q1 * q1] = sgn * (vq[0] * n0 + vq[1] * n1 + vq[2] * n2);
          }
      } else {
        T tx[2], vq[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          T ag = T(0), av = T(0);
#pragma unroll
          for (int i0 = 0; i0 < MM; ++i0)
            if (i0 < m1) {
              const int n = (base + i0 * s0) * 2 + d;
              ag = fmaT(xe[n] - xe[d], g0[i0], ag);
              av = fmaT(ve[n], b0[i0], av);
            }
          tx[d] = ag;
          vq[d] = av;
        }
        vn[0] = sgn * (vq[0] * tx[1] - vq[1] * tx[0]);
      }
    }
  }

  // The upwind normal velocity at face point fq of tile element e (FACE;
  // without, kernel 4 runs the core with with_face == 0, which never asks).
  __device__ __forceinline__ T face(int e, int, int fq) const {
    if constexpr (FACE) {
      const int Q1 = this->Q1();
      return s_vn[e * 2 * DIM * (DIM == 3 ? Q1 * Q1 : Q1) + fq];
    } else {
      return T(0);
    }
  }
};

// The instantiation of the provider for (m1, Q1): Q1 for mesh order 2 (m1 =
// 3) at the rules of the core's compiled orders p = 2..4 (size_case: Q1 =
// p + 1 + (dim == 3 ? 2 : 1)), 0 for the runtime-size code.
inline int mesh_size_case(int dim, int m1, int Q1) {
  const int D = Q1 - (dim == 3 ? 2 : 1);
  return m1 == 3 && D >= 3 && D <= 5 ? Q1 : 0;
}

// Refuse mesh sizes the provider does not take.
inline int check_mesh_sizes(int dim, int nm, int Q, int m1, int Q1) {
  if (m1 < 2 || Q1 < 1 || m1 > DMAX || Q1 > QMAX) return -5;
  const int nmv = dim == 3 ? m1 * m1 * m1 : m1 * m1;
  const int Qv = dim == 3 ? Q1 * Q1 * Q1 : Q1 * Q1;
  return nm == nmv && Q == Qv ? 0 : -5;
}

}  // namespace remhos
