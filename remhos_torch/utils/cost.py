"""The least work of each kernel: bytes it must move and operations it must
do, from its shapes, and the bound they put on its time on an H100.

Bytes count each input read once (the operands and the static tables the
kernel reads) and each output written once. Operations count 2 per
multiply-add with every tensor-product table contraction at its
sum-factorized size (the tables are tensor products of 1D ones: n1 = p + 1
dofs, m1 = mesh order + 1 nodes and q1 points per direction; kernels 3 and
4 share the partial contractions of a gradient, `gradient_macs`), plus the
pointwise work. Where the work depends on the data (gl_cg's masked
iterations, the gather's reads), the caller passes what this run's data
takes. `bound` turns (bytes, flops) into the least time: the larger of
bytes over the memory rate and flops over the peak rate of the type.

`chip_smoke.py` holds each kernel's time against these bounds, and
`bench.run(..., trace=True)` reports the main path's bytes per stage.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 rate and the card's peak rate for each
# type: f32 outside the tensor cores (no tensor-core f32 keeps its
# accuracy), f64 through the tensor cores (DMMA), the faster of its two
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def tensor_macs(n, q, d):
    """Multiply-adds of one sum-factorized contraction between n^d values
    and q^d values (either way), one direction at a time."""
    lo, hi = min(n, q), max(n, q)
    return sum(hi ** k * lo ** (d - k + 1) for k in range(1, d + 1))


def bound(nbytes, flops, dtype):
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return dict(bound_ms=1e3 * max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, flops=flops)


def _root(n, dim):
    r = round(n ** (1 / dim))
    assert r ** dim == n, "the tables are not tensor products"
    return r


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _core_work(tb, n_cg, with_face=True):
    """(multiply-adds, pointwise ops) per element of the stage core
    (stage_core.cuh) without its geometry: reference gradients, the volume
    and face parts of Ku, the face traces, and with n_cg > 0 the mass
    inverse (b = Ku A, the diagonal, the sweeps, du = x A^T)."""
    dim, nd, Q, Qf, nf = (tb[k] for k in ("dim", "nd", "Q", "Qf", "nf"))
    n1, q1 = _root(nd, dim), _root(Q, dim)
    assert q1 ** (dim - 1) == Qf, "the face rule is not the volume rule's"
    FQ = nf * Qf
    vol = tensor_macs(n1, q1, dim)        # dofs <-> volume points
    face = nf * tensor_macs(n1, q1, dim - 1)
    mac = dim * vol + vol                 # gradients of u, volume part of Ku
    pointwise = 2 * dim * Q
    if with_face:
        mac += 3 * face                   # face part of Ku, own and nbr traces
        pointwise += 3 * FQ
    if n_cg > 0:
        mac += (2 * tensor_macs(n1, n1, dim)   # b = Ku A, du_HO = x A^T
                + vol                          # the Jacobi diagonal
                + n_cg * 2 * vol)              # Jacobi sweeps
        pointwise += n_cg * (Q + 3 * nd) + 2 * nd
    return mac, pointwise


def stage_cost(tb, P, n_cg, kind="mega", with_lo=False, P16=None):
    """(bytes, flops) of kernels 1 and 2, the stages with t-polynomial
    geometry. kind "mega": the limited stage with the class-major bounds
    stencil (reads its two [3^dim, E] arrays and the class table too,
    writes du); kind "mega_elem": the same with the element-major stencil
    [E, 3^dim] (the same bytes); kind "mega_dof": the same with per-dof
    bounds (reads two [E, nd] arrays, no class table). kind "ho": the HO
    stage (writes du_HO and wdet, and du_LO with `with_lo`). Reads u,
    u_nbr, P (and P16, the bf16 va/vn stream, where given: P then holds
    w_q det J alone, so the stream is the smaller byte count) and the
    tables in their least form: the 1D factors `sf` and the index tables
    (the dense tables are the plain versions')."""
    dim, nd, Q, Qf, nf, fd = (tb[k] for k in ("dim", "nd", "Q", "Qf", "nf",
                                               "fd"))
    FQ, NFD, ncls = nf * Qf, nf * fd, 3 ** dim
    E, itemsize = P.shape[0], P.element_size()
    stencil = kind in ("mega", "mega_elem")
    tables = _nbytes(tb[k] for k in ("sf", "bdr", "dof_faces", "cls")
                     if tb.get(k) is not None and (k != "cls" or stencil))
    mega = kind in ("mega", "mega_elem", "mega_dof")
    lo_work = mega or (with_lo and n_cg > 0)
    if stencil:
        per_el = 2 * nd + NFD + 2 * ncls
    elif kind == "mega_dof":
        per_el = 4 * nd + NFD
    else:
        per_el = 2 * nd + NFD + Q + (nd if with_lo else 0)
    nbytes = (E * per_el * itemsize + P.numel() * itemsize + tables
              + _nbytes([P16]))
    mac, pointwise = _core_work(tb, n_cg)
    mac += Q * dim * (dim - 1) + Q * dim + FQ * (dim - 1)   # Horner
    if lo_work:
        mac += tensor_macs(_root(nd, dim), _root(Q, dim), dim)   # ml = wdet Bu
        pointwise += 8 * nd           # the LO average
    if mega:
        pointwise += 20 * nd          # ClipScale
    return nbytes, E * (2 * mac + pointwise)


def gradient_macs(n, q, dim):
    """Multiply-adds of all dim reference derivatives of one field from n^dim
    values to q^dim points, axis by axis with the partial contractions
    shared (kernels 3 and 4, csrc/mesh_geom.cuh and the core): along axis k
    < dim - 1 the k + 2 partials with at most one derivative table, along
    the last axis the dim derivatives."""
    mac = sum((k + 2) * q ** (k + 1) * n ** (dim - k - 1) * n
              for k in range(dim - 1))
    return mac + dim * q ** dim * n


def wdet_cost(xs, tables, with_face=False):
    """(bytes, flops) of kernel 3: xs and the kernel's tables (the packed 1D
    mesh tables and w_q) read once, wdet written once; the dim*dim Jacobian
    entries as `gradient_macs` of each coordinate from m1^dim nodes to Q
    points, then the closed-form determinant times w_q. `with_face`, the
    face variant: also v, the face descriptors and w_fq read once and wvn
    written once; per face, kernel 5's face geometry (`stage_ho_nodes_cost`)
    and the upwind clamp times w_fq at each point."""
    E, nm, dim = xs.shape
    m1, q1 = tables["m1"], tables["Q1"]
    Q = q1 ** dim
    assert m1 ** dim == nm, "the nodes are not the tables' mesh order"
    itemsize = xs.element_size()
    nbytes = (xs.numel() + tables["msf"].numel() + Q + E * Q) * itemsize
    det = 14 if dim == 3 else 3
    flops = E * (2 * dim * gradient_macs(m1, q1, dim) + (det + 1) * Q)
    if with_face:
        nf, Qf = tables["fdesc"].shape[0], tables["w_fq"].shape[0]
        nbytes += ((xs.numel() + Qf + E * nf * Qf) * itemsize
                   + _nbytes((tables["fdesc"],)))
        per_point = dim * (dim - 1) + dim
        flops += E * nf * (2 * per_point * tensor_macs(m1, q1, dim - 1)
                           + (17 if dim == 3 else 7) * Qf)
    return nbytes, flops


def geom_conv_cost(xs, u, tables, with_wdet=True):
    """(bytes, flops) of kernel 4: xs, v, u and the kernel's tables (the
    packed 1D factors of the core and of the mesh, w_q) read once, Ku
    written once and wdet only `with_wdet`; the dim*dim Jacobian entries
    (`gradient_macs` of each coordinate) and the dim velocity components as
    sum-factorized contractions from m1^dim nodes to Q points, the dim
    reference gradients of u from nd dofs to Q points and Ku back from Q
    points to nd dofs, then the cofactor algebra at every point, with the
    determinant and w_q only `with_wdet`."""
    E, nm, dim = xs.shape
    nd = u.shape[1]
    m1, q1 = tables["m1"], tables["Q1"]
    Q, n1 = q1 ** dim, _root(nd, dim)
    assert m1 ** dim == nm, "the nodes are not the tables' mesh order"
    itemsize = xs.element_size()
    tb = sum(tables[k].numel() for k in ("sf", "msf", "w_q"))
    nbytes = (2 * xs.numel() + u.numel() + tb + E * nd
              + (E * Q if with_wdet else 0)) * itemsize
    mac = (dim * gradient_macs(m1, q1, dim) + dim * tensor_macs(m1, q1, dim)
           + gradient_macs(n1, q1, dim) + tensor_macs(n1, q1, dim))
    pointwise = (55 if dim == 3 else 14) * Q
    if not with_wdet:
        pointwise -= (6 if dim == 3 else 4) * Q     # det J and w_q det J
    return nbytes, E * (2 * mac + pointwise)


def stage_ho_nodes_cost(xs, u, tb, n_cg, with_face=True):
    """(bytes, flops) of kernel 5: xs, v, u (u_nbr with the face flux) and
    the tables it reads (the packed 1D factors sf and msf, w_q; with the
    face flux the face descriptors and the face index tables), du and wdet
    written once. The volume geometry is kernel 4's; the face part adds,
    per face, the dim-1 tangents and the velocity at the face points from
    the face's m1^(dim-1) nodes (Gauss-Lobatto: the trace is a subset of
    the nodes), the normal and v . n; then the core's face flux and mass
    inverse."""
    E, nm, dim = xs.shape
    nd, Q, Qf, nf, fd = (tb[k] for k in ("nd", "Q", "Qf", "nf", "fd"))
    FQ = nf * Qf
    m1, q1 = _root(nm, dim), _root(Q, dim)
    names = ["sf", "msf", "w_q"]
    reads = 2 * xs.numel() + u.numel()
    if with_face:
        names += ["fdesc", "bdr", "dof_faces"]
        reads += E * nf * fd
    itemsize = u.element_size()
    nbytes = ((reads + E * nd + E * Q) * itemsize
              + _nbytes(tb[k] for k in names))
    mac, pointwise = _core_work(tb, n_cg, with_face)
    mac += (dim * dim + dim) * tensor_macs(m1, q1, dim)   # J and v_q
    pointwise += (55 if dim == 3 else 14) * Q             # cofactors, va
    if with_face:
        per_point = dim * (dim - 1) + dim
        mac += nf * per_point * tensor_macs(m1, q1, dim - 1)
        pointwise += (15 if dim == 3 else 5) * FQ
    return nbytes, E * (2 * mac + pointwise)


def matrix_macs(n, q, dim):
    """Multiply-adds of one element matrix sum_q W(q) prod_a T_a(q_a, i_a,
    j_a) on a tensor rule of q^dim points with n^dim dofs, contracted one
    rule axis at a time: q^dim n^2 + q^(dim-1) n^4 + ... + q n^(2 dim)."""
    return sum(q ** (dim - k + 1) * n ** (2 * k) for k in range(1, dim + 1))


def fa_assemble_cost(xs, tables):
    """(bytes, flops) of the assembled stage's kernel: xs and v and the
    kernel's tables (the packed 1D mesh and Bernstein tables, w_q, the face
    descriptors, w_fq) read once, det J, M, ml, K and the face blocks
    written once. Operations, as perfbench/yardstick_fa.py counts the
    assembly (its parts geometry, faces and matrices): J and v at the
    volume points and 55 operations a point (cofactors, det J, w adj(J) v);
    at each face's points the tangents and v and 17 operations a point
    (the normal, v . n, w max(0, v . n)); M, the dim parts of K and each
    face block as `matrix_macs`, and ml as one tensor contraction."""
    E, nm, dim = xs.shape
    m1, q1, n1 = tables["m1"], tables["Q1"], tables["D"]
    Q, Qf = q1 ** dim, q1 ** (dim - 1)
    nd, nf, fd = n1 ** dim, tables["fdesc"].shape[0], n1 ** (dim - 1)
    assert m1 ** dim == nm, "the nodes are not the tables' mesh order"
    nbytes = ((2 * xs.numel() + E * (Q + 2 * nd * nd + nd + nf * fd * fd))
              * xs.element_size()
              + _nbytes(tables[k] for k in ("msf", "bsf", "w_q", "fdesc",
                                            "w_fq")))
    geometry = (2 * dim * (gradient_macs(m1, q1, dim)
                           + tensor_macs(m1, q1, dim)) + 55 * Q)
    faces = nf * (2 * dim * (gradient_macs(m1, q1, dim - 1)
                             + tensor_macs(m1, q1, dim - 1)) + 17 * Qf)
    matrices = 2 * ((1 + dim) * matrix_macs(n1, q1, dim)
                    + nf * matrix_macs(n1, q1, dim - 1)
                    + tensor_macs(n1, q1, dim))
    return nbytes, E * (geometry + faces + matrices)


def gl_cg_cost(rhs, wdet, tables, iterations):
    """(bytes, flops) of kernel 6: rhs and wdet read once, the result
    written once, the 1D tables sf read once; per element b = rhs A, the
    diagonal and x A^T, and per iteration in which the element is live
    (`iterations` [E], what this run's data takes) the two Bgl
    contractions, the three dots and the updates."""
    E, nd = rhs.shape
    Q = wdet.shape[1]
    dim = next(d for d in (3, 2, 1) if round(nd ** (1 / d)) ** d == nd
               and round(Q ** (1 / d)) ** d == Q)
    n1, q1 = _root(nd, dim), _root(Q, dim)
    vol = tensor_macs(n1, q1, dim)
    its = int(iterations.sum())
    nbytes = ((2 * rhs.numel() + wdet.numel()) * rhs.element_size()
              + _nbytes([tables["sf"]]))
    mac = E * (2 * tensor_macs(n1, n1, dim) + vol) + its * 2 * vol
    pointwise = E * 8 * nd + its * (Q + 13 * nd)
    return nbytes, 2 * mac + pointwise


def gather_nbr_index(shape, periodic, nbr_dof_local, nd, device):
    """Flat index [E, nf*fd] into u[E, nd] flattened with one zero slot
    appended (index E*nd): the gather as one index_select. Made from the
    plain gather of the entries' own numbers (exact in f64)."""
    from ..structured import gather_nbr_structured
    E = 1
    for n in shape:
        E *= n
    ids = torch.arange(1, E * nd + 1, dtype=torch.float64,
                       device=device).reshape(E, nd)
    g = gather_nbr_structured(ids, shape, periodic,
                              nbr_dof_local).reshape(E, -1).long()
    return torch.where(g == 0, E * nd, g - 1)


def gather_nbr_cost(u, index):
    """(bytes, 0) of kernel 7: u_nbr written once, each entry of u that the
    gather reads (the distinct entries of `index`, `gather_nbr_index`, less
    the zero slot) read once, and the [nf, fd] dof table."""
    E, nd = u.shape
    reads = int(torch.unique(index[index < E * nd]).numel())
    nf_fd = index.shape[1]
    return (index.numel() + reads) * u.element_size() + 4 * nf_fd, 0
