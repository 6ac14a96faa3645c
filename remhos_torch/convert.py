"""Carry state from the JAX package into the port's tensors and layout.

The tests give the JAX side and the port the same numbers: arrays from the
JAX side arrive here as numpy (np.asarray of a jax.Array) and leave as torch
tensors in the port's layout, with the TPU's lane padding stripped. This
module imports neither JAX nor the JAX package; it only knows their
layouts:

- `remhos_tpu` pads every quadrature segment of its stage tables and of P
  to S = 128 * ceil(max(Q, FQ) / 128) columns;
- its face tables are block-diagonal [nf*fd, nf*Qf] / [nf*Qf, nd] matrices;
- its bounds class expansion is a one-hot [3^dim, nd] matrix EXP.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.tables import _dof_faces, poly_layout

DISC_FIELDS = ("w_q", "Bu", "Gu", "Bm", "Gm", "w_fq", "Bface", "Bmf", "Gmf",
               "n_ref", "ref_nodes_u", "Bm_at_unodes", "Bgl", "A_gl2b")


def tensor(a, dtype=torch.float64, device="cpu"):
    """x0, v, u0 and other plain arrays: same layout, new container."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def discretization_tables(disc) -> dict:
    """The host tables of a Discretization (either package's), by name,
    with the dofmap tables as bdr_dofs, nbr_dof_local and sub2ind."""
    out = {k: np.asarray(getattr(disc, k)) for k in DISC_FIELDS}
    for k in ("bdr_dofs", "nbr_dof_local", "sub2ind"):
        out[k] = np.asarray(getattr(disc.dofmaps, k))
    return out


def stage_tables(tb, disc_tables, dtype=torch.float64, device="cpu"):
    """`pallas_kernels.stage_ho_tables` output (values as numpy) plus the
    matching `discretization_tables` -> the port's
    `ops.tables.stage_ho_tables` layout, padding stripped. Every float table
    is cut out of the JAX table; the int tables come from the dofmaps and
    from the one-hot EXP."""
    S, Q = int(tb["seg"]), int(tb["Q"])
    bdr = np.asarray(disc_tables["bdr_dofs"], dtype=np.int32)
    nf, fd = bdr.shape
    Qf = disc_tables["Bface"].shape[0]
    dim = disc_tables["Gu"].shape[2]
    nd = np.asarray(tb["A"]).shape[0]
    UT = np.asarray(tb["UT"])

    def F(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def I(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)

    return dict(
        GuT=F(np.concatenate([UT[:, b * S:b * S + Q] for b in range(dim)],
                             axis=1)),
        Buw=F(np.asarray(tb["Buw"])[:Q]),
        Bface=F(np.asarray(tb["BD"])[:fd, :Qf].T),     # first diagonal block
        SBf=F(np.asarray(tb["SB"])[:Qf][:, bdr[0]]),   # face 0's rows
        A=F(tb["A"]), AT=F(tb["AT"]),
        BglT=F(np.asarray(tb["BglT"])[:, :Q]), Bgl=F(np.asarray(tb["Bgl"])[:Q]),
        Bgl2=F(np.asarray(tb["Bgl2"])[:Q]), Bu=F(np.asarray(tb["BuP"])[:Q]),
        w_q=F(disc_tables["w_q"]), bdr=I(bdr),
        dof_faces=I(_dof_faces(bdr, nd, dim)),
        cls=I(np.asarray(tb["EXP"]).argmax(axis=0)),
        dim=dim, nd=nd, Q=Q, Qf=Qf, nf=nf, fd=fd)


def poly(P, dim, Q, FQ, S, dtype=torch.float64, device="cpu"):
    """`pallas_kernels.build_poly_tables(...)["P"]` [E, nseg*S] -> the
    port's P [E, width] (`ops.tables.poly_layout`), padding stripped."""
    P = np.asarray(P)
    lay = poly_layout(dim, Q, FQ)
    lens = [Q] * (lay["nkv"] * dim + lay["nkd"]) + [FQ] * lay["nkn"]
    out = np.concatenate([P[:, i * S:i * S + n] for i, n in enumerate(lens)],
                         axis=1)
    return tensor(out, dtype, device)
