"""Discretization bundle: the static host tables of the remap path.

The port's copy of `remhos_tpu.discretization` for structured meshes of
dimension 1, 2 and 3 and for general quad and hex meshes (`umesh.py`,
`umesh3d.py`), whose dof maps carry per-element neighbour tables.
Integration rules mirror MFEM's defaults:
- volume: 2*p + mesh_order*dim - 1 (MassIntegrator / ConvectionIntegrator);
- face: mesh_order*dim - 1 + 2*p on the (dim-1)-face (DGTraceIntegrator).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import basis as B
from .dofmaps import DofMaps, build_dofmaps
from .mesh import StructuredMesh, faces_for_dim


@dataclasses.dataclass(frozen=True)
class Discretization:
    mesh: StructuredMesh
    p: int
    dofmaps: DofMaps
    w_q: np.ndarray        # [Q] volume quadrature weights
    Bu: np.ndarray         # [Q, nd] Bernstein values
    Gu: np.ndarray         # [Q, nd, dim] Bernstein reference gradients
    Bm: np.ndarray         # [Q, nm] mesh (GLL) values
    Gm: np.ndarray         # [Q, nm, dim] mesh reference gradients
    w_fq: np.ndarray       # [Qf] face (tangential) weights
    Bface: np.ndarray      # [Qf, fd] face trace of the solution basis
    Bmf: np.ndarray        # [nf, Qf, nm] mesh basis at face quad points
    Gmf: np.ndarray        # [nf, Qf, nm, dim]
    n_ref: np.ndarray      # [nf, dim] outward reference normals
    ref_nodes_u: np.ndarray   # [nd, dim] solution (closed-uniform) ref nodes
    Bm_at_unodes: np.ndarray  # [nd, nm] mesh basis at the uniform nodes
    Bm_at_glnodes: np.ndarray  # [nd, nm] mesh basis at the GL nodes
    T_gl_to_unif: np.ndarray  # [nd, nd] GL-nodal interpolant at the
    #                           uniform nodes (problem 7's inflow projection)
    Bgl: np.ndarray        # [Q, nd] GL nodal basis at the volume rule
    A_gl2b: np.ndarray     # [nd, nd] GL-nodal -> Bernstein coefficients

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def nd(self) -> int:
        return self.dofmaps.nd

    @property
    def fd(self) -> int:
        return self.dofmaps.fd


def build_discretization(mesh: StructuredMesh, p: int) -> Discretization:
    dim, mo = mesh.dim, mesh.mesh_order
    if getattr(mesh, "structured", True):
        dofmaps = build_dofmaps(dim, p)
    elif dim == 2:
        from .umesh import build_general_dofmaps
        dofmaps = build_general_dofmaps(mesh, p)
    else:
        from .umesh3d import build_general_dofmaps_3d
        dofmaps = build_general_dofmaps_3d(mesh, p)

    q1, w1 = B.gauss_legendre(B.min_gauss_points(2 * p + mo * dim - 1))
    Bu1, Gu1 = B.bernstein_vals(p, q1), B.bernstein_grads(p, q1)
    gll_m = B.gauss_lobatto(mo + 1)
    Bm1, Gm1 = B.lagrange_vals(gll_m, q1), B.lagrange_grads(gll_m, q1)
    Bu = B.tensor_mixed([Bu1] * dim)
    Gu = B.tensor_mixed_grads([Bu1] * dim, [Gu1] * dim)
    Bm = B.tensor_mixed([Bm1] * dim)
    Gm = B.tensor_mixed_grads([Bm1] * dim, [Gm1] * dim)
    w_q = B.tensor_mixed([w1[:, None]] * dim)[:, 0]

    qf1, wf1 = B.gauss_legendre(B.min_gauss_points(mo * dim - 1 + 2 * p))
    if dim == 1:
        # a point face: one point of weight 1, one face dof
        Bface, w_fq = np.ones((1, 1)), np.ones(1)
    else:
        Bface = B.tensor_mixed([B.bernstein_vals(p, qf1)] * (dim - 1))
        w_fq = B.tensor_mixed([wf1[:, None]] * (dim - 1))[:, 0]

    Bmt, Gmt = B.lagrange_vals(gll_m, qf1), B.lagrange_grads(gll_m, qf1)
    Bmf, Gmf, nrefs = [], [], []
    for axis, side in faces_for_dim(dim):
        end = np.array([0.0 if side == 0 else 1.0])
        Bme, Gme = B.lagrange_vals(gll_m, end), B.lagrange_grads(gll_m, end)
        vals = [(Bme if a == axis else Bmt) for a in range(dim)]
        grads = [(Gme if a == axis else Gmt) for a in range(dim)]
        Bmf.append(B.tensor_mixed(vals))
        Gmf.append(B.tensor_mixed_grads(vals, grads))
        n = np.zeros(dim)
        n[axis] = -1.0 if side == 0 else 1.0
        nrefs.append(n)

    unodes_1d = np.linspace(0.0, 1.0, p + 1)
    ref_nodes_u = np.stack(
        [g.ravel(order="F")
         for g in np.meshgrid(*[unodes_1d] * dim, indexing="ij")], axis=-1)
    Bm_at_unodes = B.tensor_mixed([B.lagrange_vals(gll_m, unodes_1d)] * dim)
    gl_nodes = B.gauss_legendre(p + 1)[0]
    Bm_at_glnodes = B.tensor_mixed([B.lagrange_vals(gll_m, gl_nodes)] * dim)
    T_gl_to_unif = B.tensor_mixed([B.lagrange_vals(gl_nodes, unodes_1d)]
                                  * dim)
    Bgl = B.tensor_mixed([B.lagrange_vals(gl_nodes, q1)] * dim)
    A1 = np.linalg.solve(B.bernstein_vals(p, unodes_1d),
                         B.lagrange_vals(gl_nodes, unodes_1d))
    A_gl2b = B.tensor_mixed([A1] * dim)

    return Discretization(
        mesh=mesh, p=p, dofmaps=dofmaps, w_q=w_q, Bu=Bu, Gu=Gu, Bm=Bm, Gm=Gm,
        w_fq=w_fq, Bface=Bface, Bmf=np.stack(Bmf), Gmf=np.stack(Gmf),
        n_ref=np.stack(nrefs), ref_nodes_u=ref_nodes_u,
        Bm_at_unodes=Bm_at_unodes, Bm_at_glnodes=Bm_at_glnodes,
        T_gl_to_unif=T_gl_to_unif, Bgl=Bgl,
        A_gl2b=A_gl2b)
