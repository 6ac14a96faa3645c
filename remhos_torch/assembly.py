"""Face gather and scatter of the DG face terms: the `remhos_tpu.assembly`
subset the partial-assembly path uses. The assembled operators of that
module (element mass and convection matrices, `bdrInt`) belong to the
assembled path (ROADMAP.md Queue 1, item 4)."""

from __future__ import annotations


def gather_face(u, bdr_dofs):
    """u_face[E, nf, fd] from u[E, nd]; bdr_dofs[nf, fd] is a long tensor."""
    return u[:, bdr_dofs]


def scatter_face_add(y, contrib, bdr_dofs):
    """y[E, nd] plus contrib[E, nf, fd] scattered to bdr_dofs. An edge or
    corner dof lies on several faces, so the indices repeat and the
    contributions accumulate: `index_add`, never an indexed assignment."""
    return y.index_add(1, bdr_dofs.reshape(-1),
                       contrib.reshape(y.shape[0], -1))
