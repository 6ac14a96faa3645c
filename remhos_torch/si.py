"""Smoothness indicator (`-si 1|2`): the port of `remhos_tpu.si`
(SmoothnessIndicator, remhos_tools.cpp:24-354).

u is projected onto the Q1 CG space on the subcell (Bernstein control
point) grid, an approximate Laplacian is applied (two-term Neumann-series
mass inversions), the 3^dim-neighbourhood min/max of the result is taken,
and the `-si 1|2` formulas map it to [0, 1].

The setup stays in host numpy, built once from the initial mesh as the
reference does ("TODO assemble SI matrices every RK stage for remap",
remhos_tools.cpp:34): the per-subcell Q1 mass and stiffness blocks (array
code over all elements at once), the domain-boundary face blocks and the
lumped CG mass. The actions are torch.
On the structured fine grid the sparse CG matrices become per-subcell dense
blocks applied as gather, elementwise product summed, and a sum onto the
fine nodes. That sum runs in a fixed order: each fine node reads its at most
2^dim (subcell, corner) contributions through a padded gather built at setup
and adds them one by one (`index_add_` sums with atomics in no fixed order
on the card). The neighbourhood min/max is a separable shift stencil.
"""

from __future__ import annotations

import numpy as np
import torch

from . import basis as B
from .dofmaps import cg_node_ids
from .structured import _shift
from .subcell import boundary_node_mask


Q1_MASS = np.array([[1 / 3, 1 / 6], [1 / 6, 1 / 3]])
Q1_STIFF = np.array([[1.0, -1.0], [-1.0, 1.0]])


def _q1_1d_mass(h):
    """The 1D Q1 mass block of a cell of width h; h[k] gives [k, 2, 2]."""
    return np.asarray(h)[..., None, None] * Q1_MASS


def _q1_1d_stiff(h):
    """The 1D Q1 stiffness block of a cell of width h; h[k] gives [k, 2,
    2]."""
    return (1 / np.asarray(h))[..., None, None] * Q1_STIFF


def fine_node_gather(corner_cg, n_cg):
    """[n_cg, K] long: for each fine node, the flat positions in
    corner_cg.reshape(-1) that land on it, ascending, padded with
    corner_cg.size (a zero slot the caller appends); K the most any node
    takes (2^dim on a grid of Q1 subcells)."""
    flat = np.asarray(corner_cg).reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_cg)
    K = int(counts.max())
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(flat.size) - np.repeat(start, counts)
    out = np.full((n_cg, K), flat.size, dtype=np.int64)
    out[flat[order], slot] = order
    return out


class SmoothnessIndicator:
    """The static tables on one device, in one dtype, and the actions."""

    # evaluations of `compute` (a program counter; the callers' span around
    # an evaluation and its dof values is `remhos.si`)
    evaluations = 0

    def __init__(self, si_type: int, disc, dtype=torch.float64,
                 device="cpu"):
        assert si_type in (1, 2), "Bad smoothness indicator id!"
        self.type = si_type
        self.param = 5.0 if si_type == 1 else 3.0
        dim, p = disc.dim, max(disc.p, 1)
        mesh = disc.mesh
        if not getattr(mesh, "structured", True):
            # the JAX package's si.py reads mesh.shape as well, and fails
            raise ValueError("the smoothness indicator (-si) runs on "
                             "structured meshes: its fine grid is the "
                             "element grid's")
        nsub = p ** dim                                  # subcells per element

        def T(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def L(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=device)

        # fine-grid node of each subcell corner: [E, nsub, 2^dim]
        cg_idx, self.n_cg = cg_node_ids(mesh.shape, mesh.periodic, disc.p)
        sub2ind = np.asarray(disc.dofmaps.sub2ind)       # [nsub, 2^dim]
        corner_cg = cg_idx[:, sub2ind]

        # per-element subcell sizes (uniform within an element)
        widths = [np.diff(b) / p for b in mesh.breaks]
        E = mesh.num_elements
        eidx = np.stack(np.unravel_index(np.arange(E), mesh.shape, order="F"),
                        axis=-1)
        hs = np.stack([widths[d][eidx[:, d]] for d in range(dim)], -1)

        # per-element Q1 mass and stiffness subcell blocks [E, 2^d, 2^d]
        Msub = np.ones((E, 1, 1))
        Lsub = np.zeros((E, 1, 1))
        for d in range(dim):
            m1, k1 = _q1_1d_mass(hs[:, d]), _q1_1d_stiff(hs[:, d])
            # lex tensor (axis d slower than the previous): kron(new, old)
            n2 = (E, 2 * Msub.shape[1], 2 * Msub.shape[2])
            Msub_new = np.einsum("eab,eij->eaibj", m1, Msub).reshape(n2)
            Lsub = (np.einsum("eab,eij->eaibj", k1, Msub).reshape(n2)
                    + np.einsum("eab,eij->eaibj", m1, Lsub).reshape(n2))
            Msub = Msub_new

        # DiffusionIntegrator(-1), i.e. minus the stiffness, plus the DG
        # boundary term +<(d_n psi_j), psi_i> on domain-boundary subcell faces
        Lop = -np.repeat(Lsub[:, None, :, :], nsub, axis=1)
        Lop = Lop + self._boundary_face_blocks(mesh, hs, eidx, p, dim)

        # lumped CG mass: row sums of the Q1 mass, assembled on the fine grid
        # (bincount adds in input order, as np.add.at does)
        lumped = np.bincount(corner_cg.reshape(-1),
                             np.repeat(Msub.sum(axis=2)[:, None, :], nsub,
                                       axis=1).reshape(-1),
                             minlength=self.n_cg)

        self.Msub, self.Lop, self.lumped = T(Msub), T(Lop), T(lumped)
        self.sub2ind, self.cg_idx = L(sub2ind), L(cg_idx)
        self.corner_cg = L(corner_cg)
        self.node_gather = L(fine_node_gather(corner_cg, self.n_cg))
        # ShapeEval: the Bernstein basis at the closed-uniform nodes
        un = np.linspace(0, 1, disc.p + 1)
        self.ShapeEval = T(B.tensor_mixed([B.bernstein_vals(disc.p, un)]
                                          * dim))
        # DG2CG is -1 at domain-boundary nodes (remhos_tools.cpp:98-108)
        self.dg2cg_valid = torch.as_tensor(
            ~boundary_node_mask(mesh, disc.ref_nodes_u), device=device)
        self.periodic = mesh.periodic
        # fine grid: nodes per axis, x fastest in the node ids
        self.gshape = tuple(p * s if per else p * s + 1
                            for s, per in zip(mesh.shape, mesh.periodic))
        # type 1's eps below: the reference's 1e-50 is 0 in f32, where a
        # flat g then gives 0/0; the dtype's smallest normal number keeps the
        # f32 value finite and leaves f64 (1e-50) as it is
        self.eps1 = max(1.0e-50, float(torch.finfo(dtype).tiny))

    # ------------------------------------------------------------------

    @staticmethod
    def _boundary_face_blocks(mesh, hs, eidx, p, dim):
        """DGDiffusionIntegrator(-1, 0, 0)'s boundary contribution as subcell
        blocks [E, nsub, 2^d, 2^d]: +int_face psi_i (d_n psi_j)."""
        E = mesh.num_elements
        nsub = p ** dim
        nc = 2 ** dim
        out = np.zeros((E, nsub, nc, nc))
        sidx = np.stack(np.unravel_index(np.arange(nsub), (p,) * dim,
                                         order="F"), -1)  # [nsub, dim]
        bits = np.stack([(np.arange(nc) >> d) & 1 for d in range(dim)], -1)
        for d in range(dim):
            if mesh.periodic[d]:
                continue
            for side in (0, 1):
                el_on = eidx[:, d] == (0 if side == 0 else mesh.shape[d] - 1)
                sc_on = sidx[:, d] == (0 if side == 0 else p - 1)
                # the 1D factors along d: the value v at the end point and
                # the outward normal derivative
                v = np.array([1.0, 0.0]) if side == 0 else np.array([0., 1.])
                for e in np.where(el_on)[0]:
                    g = np.array([-1.0, 1.0]) / hs[e, d]
                    dn = -g if side == 0 else g
                    blk = np.ones((nc, nc))
                    for a in range(dim):
                        f = np.outer(v, dn) if a == d else \
                            _q1_1d_mass(hs[e, a])
                        blk = blk * f[np.ix_(bits[:, a], bits[:, a])]
                    out[e, sc_on] += blk
        return out

    # ------------------------------------------------------------------
    # actions on fine-grid vectors
    # ------------------------------------------------------------------

    def _to_nodes(self, loc):
        """The fine-grid vector [n_cg] of per-corner contributions
        loc[E, nsub, 2^dim], summed per node in a fixed order."""
        flat = torch.cat([loc.reshape(-1), loc.new_zeros(1)])
        idx = self.node_gather
        out = flat[idx[:, 0]]
        for k in range(1, idx.shape[1]):
            out = out + flat[idx[:, k]]
        return out

    def _apply_blocks(self, blocks, y):
        """The sum over subcells of dense blocks [E, 2^d, 2^d] (shared by an
        element's subcells) or [E, nsub, 2^d, 2^d] applied to the fine
        vector y."""
        vals = y[self.corner_cg]                         # [E, nsub, 2^d]
        if blocks.ndim == 3:
            blocks = blocks[:, None]
        return self._to_nodes((blocks * vals[:, :, None, :]).sum(-1))

    def _neumann_project(self, rhs):
        """Two-term Neumann-series inversion of the CG mass
        (remhos_tools.cpp:269-293): y1 = rhs/l; y2 = y1 + (rhs - M y1)/l,
        with the reference's residual test folded in as a select (no
        read-back)."""
        tol = 1.0e-10
        y = torch.zeros_like(rhs)
        for _ in range(2):
            z = self._apply_blocks(self.Msub, y) - rhs
            resid = torch.sqrt((z * z).sum())
            y = torch.where(resid <= tol, y, y - z / self.lumped)
        return y

    def compute(self, u):
        """The indicator on the fine CG grid: [n_cg]."""
        self.evaluations += 1
        u_eval = u @ self.ShapeEval.T                    # values at nodes
        vals = u_eval[:, self.sub2ind]                   # [E, nsub, 2^d]
        rhs = self._to_nodes((self.Msub[:, None]
                              * vals[:, :, None, :]).sum(-1))
        g = self._neumann_project(rhs)
        g = self._neumann_project(self._apply_blocks(self.Lop, g))

        gmin, gmax = self._stencil_minmax(g)
        if self.type == 1:
            eps = self.eps1
            return 1.0 - ((torch.abs(gmin - gmax) + eps)
                          / (torch.abs(gmin) + torch.abs(gmax) + eps)
                          ) ** self.param
        eps = 1.0e-15
        return torch.clamp(self.param * torch.clamp(gmin * gmax, min=0.0)
                           / (torch.maximum(gmin * gmin, gmax * gmax) + eps),
                           max=1.0)

    def _stencil_minmax(self, g):
        """min/max over the CG mass sparsity, the 3^dim fine-node
        neighbourhood (ComputeFromSparsity, remhos_tools.cpp:325-354)."""
        dim = len(self.gshape)
        G = g.reshape(tuple(reversed(self.gshape)))
        gmin, gmax = G, G
        for d in range(dim):
            gdim = dim - 1 - d
            per = self.periodic[d]
            lo_min = _shift(gmin, gdim, 0, per, fill=float("inf"))
            hi_min = _shift(gmin, gdim, 1, per, fill=float("inf"))
            lo_max = _shift(gmax, gdim, 0, per, fill=-float("inf"))
            hi_max = _shift(gmax, gdim, 1, per, fill=-float("inf"))
            gmin = torch.minimum(gmin, torch.minimum(lo_min, hi_min))
            gmax = torch.maximum(gmax, torch.maximum(lo_max, hi_max))
        return gmin.reshape(-1), gmax.reshape(-1)

    def dof_values(self, si_fine):
        """The indicator at the DG dofs [E, nd], 1 at domain-boundary dofs
        (the DG2CG < 0 convention, remhos_tools.cpp:187)."""
        return torch.where(self.dg2cg_valid, si_fine[self.cg_idx], 1.0)

    def update_bounds(self, u_new_HO, u_min, u_max, si_dof):
        """UpdateBounds (remhos_tools.cpp:183-190): the bounds relaxed
        toward the HO value where the solution is smooth."""
        t = si_dof
        u_min = torch.clamp(t * u_new_HO + (1.0 - t) * u_min, min=0.0)
        u_max = torch.clamp(t * u_new_HO + (1.0 - t) * u_max, max=1.0)
        return u_min, u_max
