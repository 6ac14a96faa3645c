"""Discretization bundle: the static host tables of the remap path.

The port's copy of `remhos_tpu.discretization` for structured meshes.
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
    dofmaps = build_dofmaps(dim, p)

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
    Bgl = B.tensor_mixed([B.lagrange_vals(gl_nodes, q1)] * dim)
    A1 = np.linalg.solve(B.bernstein_vals(p, unodes_1d),
                         B.lagrange_vals(gl_nodes, unodes_1d))
    A_gl2b = B.tensor_mixed([A1] * dim)

    return Discretization(
        mesh=mesh, p=p, dofmaps=dofmaps, w_q=w_q, Bu=Bu, Gu=Gu, Bm=Bm, Gm=Gm,
        w_fq=w_fq, Bface=Bface, Bmf=np.stack(Bmf), Gmf=np.stack(Gmf),
        n_ref=np.stack(nrefs), ref_nodes_u=ref_nodes_u, Bm_at_unodes=Bm_at_unodes, Bgl=Bgl,
        A_gl2b=A_gl2b)
