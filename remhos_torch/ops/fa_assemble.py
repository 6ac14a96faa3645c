"""The assembled stage's element data from the mesh nodes: wrapper, launch
count, tables and plain PyTorch version.

`fa_assemble` forms, in one launch of `csrc/fa_assemble.cu` (CUDA C++,
sm_90a), what the assembled (no `-pa`) remap stage reads at the moved nodes
xs = x0 + t v: det J [E, Q], the element mass matrices M [E, nd, nd], their
row sums ml [E, nd], the element convection matrices K [E, nd, nd] and the
upwind face blocks bdrInt [E, nf, fd, fd]. The mesh geometry is kernel 3's
sum-factorized provider (`csrc/mesh_geom.cuh`, with the velocity and the
face pass), the matrices its quadrature sums one rule axis at a time; no
Jacobian, normal or per-point temporary reaches memory. No TPU counterpart:
the JAX package assembles these in XLA ops (remhos_tpu/operator.py:
270-319), as `fa_assemble_reference` does.

`fa_assemble_reference` is the plain chain: the volume and face geometry
(`geometry.py`), then `assembly.element_convection`, `face_upwind_matrices`,
`element_mass` and `lumped_mass`. It is the CPU's path, the tests'
reference, and the path of every stage the kernel does not take: transport
(the velocity a function evaluated at the points, sign -1), 1D, mesh orders
other than 2 and rules outside the kernel's compiled sizes (`engages`).

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `fa_assemble_reference`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import assembly as asm
from .. import basis as B
from .. import geometry as geo
from . import build
from . import stage_core as core
from .tables import check_tables, face_descriptors, mesh_factor_block

_P = ctypes.c_void_p
# remhos_fa_assemble: xs, v, msf, bsf, w_q, fdesc, w_fq, detJ, M, ml, K, bdr
ARGTYPES = [ctypes.c_int, ctypes.c_int] + [_P] * 12 + [
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P]
# the kernel's tables, in the order of its table pointers
KERNEL_TABLES = ("msf", "bsf", "w_q", "fdesc", "w_fq")
# order of the 1D Bernstein tables in the packed `bsf` block
# (csrc/fa_assemble.cu reads them in this order)
BERNSTEIN_TABLES = ("B1", "G1", "S1")
# the Bernstein functions per axis the kernel is compiled for (p = 2..4)
COMPILED_D = (3, 4, 5)


def engages(device, exec_mode, dim, mesh_order, Q1, face_ok) -> bool:
    """Whether the assembled stage takes its element data from the kernel:
    on a CUDA device, in remap (exec_mode 1: the nodal mesh velocity), in 2D
    or 3D at mesh order 2, on a rule of Q1 points per axis that the kernel
    is compiled for (p = 2..4: Q1 = p + 3 in 3D, p + 2 in 2D), with
    axis-aligned reference normals (`face_ok`: the face descriptors can be
    made). Everything else keeps the plain chain."""
    X = 2 if dim == 3 else 1
    return (torch.device(device).type == "cuda" and exec_mode == 1
            and dim in (2, 3) and mesh_order == 2
            and Q1 - X in COMPILED_D and bool(face_ok))


def bernstein_factor_tables(disc):
    """The 1D Bernstein tables of the kernel (host numpy, float64): B1, G1
    [Q1, D], the values and derivatives at the rule's points per axis, and
    S1 = B1 times its row sums (ml as M's row sums, contracted axis by
    axis). Raises ValueError unless they rebuild disc.Bu, disc.Gu and
    disc.Bface and the rule's 1D weights rebuild w_q and w_fq to 1e-13 of
    their largest entries: the volume and the face rules must be one 1D
    rule."""
    dim, nd = disc.dim, disc.nd
    Q = len(disc.w_q)
    D = round(nd ** (1.0 / dim))
    Q1 = round(Q ** (1.0 / dim))
    if D ** dim != nd or Q1 ** dim != Q:
        raise ValueError("fa_assemble needs tensor-product elements with "
                         "one 1D rule on every axis")
    q1, w1 = B.gauss_legendre(Q1)
    B1, G1 = B.bernstein_vals(D - 1, q1), B.bernstein_grads(D - 1, q1)
    rebuilt = dict(
        Bu=(B.tensor_mixed([B1] * dim), disc.Bu),
        Gu=(B.tensor_mixed_grads([B1] * dim, [G1] * dim), disc.Gu),
        Bface=(B.tensor_mixed([B1] * (dim - 1)), disc.Bface),
        w_q=(B.tensor_mixed([w1[:, None]] * dim)[:, 0], disc.w_q),
        w_fq=(B.tensor_mixed([w1[:, None]] * (dim - 1))[:, 0], disc.w_fq))
    for name, (got, want) in rebuilt.items():
        want = np.asarray(want, np.float64)
        if (got.shape != want.shape or
                np.abs(got - want).max() > 1e-13 * np.abs(want).max()):
            raise ValueError(f"{name} is not a Kronecker product of the 1D "
                             "Bernstein tables on one Gauss-Legendre rule")
    return dict(B1=B1, G1=G1, S1=B1 * B1.sum(axis=1, keepdims=True), D=D,
                Q1=Q1)


def fa_assemble_tables(disc, dtype, device, exec_mode=1):
    """The static tables, made once per operator. The plain chain's, as the
    operator made them before: Bm, Gm, Bmf [nf, Qf, nm], Bu, Gu, w_q, Bface,
    w_fq and the face route, `face_tan` (`geometry.face_tangent_tables`,
    None in 1D, where Gmf and n_ref give the normals). `engaged`: whether
    the operator launches the kernel (`engages` on `device`); only then
    the kernel's tables too (`add_kernel_tables`)."""
    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    dim = disc.dim
    ft = geo.face_tangent_tables(disc.Gmf, disc.n_ref)
    tb = dict(Bm=T(disc.Bm), Gm=T(disc.Gm), Bmf=T(disc.Bmf), Bu=T(disc.Bu),
              Gu=T(disc.Gu), w_q=T(disc.w_q), Bface=T(disc.Bface),
              w_fq=T(disc.w_fq),
              face_tan=None if ft is None else (T(ft[0]), T(ft[1])))
    if ft is None:
        tb.update(Gmf=T(disc.Gmf), n_ref=T(disc.n_ref))
    Q, nm = tb["Bm"].shape
    m1, Q1 = round(nm ** (1.0 / dim)), round(Q ** (1.0 / dim))
    tb["engaged"] = engages(device, exec_mode, dim, m1 - 1, Q1,
                            ft is not None)
    if tb["engaged"]:
        add_kernel_tables(tb, disc)
    return tb


def add_kernel_tables(tb, disc):
    """Add the kernel's tables to `tb` (`fa_assemble_tables`'), in the
    dtype and on the device of its w_q: the packed 1D mesh tables `msf`
    (`tables.mesh_factor_block`), the packed 1D Bernstein tables `bsf`
    (`bernstein_factor_tables`, BERNSTEIN_TABLES order), the face
    descriptors `fdesc` (`tables.face_descriptors`) and the sizes m1, Q1,
    D; checked once (`tables.check_tables`). Raises ValueError where the
    element is not one the kernel takes."""
    dtype, device = tb["w_q"].dtype, tb["w_q"].device
    bf = bernstein_factor_tables(disc)
    Q, nf, Qf = len(disc.w_q), len(disc.n_ref), len(disc.w_fq)
    tb.update(bsf=torch.as_tensor(np.concatenate(
                  [bf[k].ravel() for k in BERNSTEIN_TABLES])).to(
                      device=device, dtype=dtype),
              fdesc=torch.as_tensor(face_descriptors(disc), device=device),
              D=bf["D"], **mesh_factor_block(disc, dtype, device))
    check_tables(tb, shapes=dict(
        w_q=(Q,), w_fq=(Qf,), msf=(2 * tb["Q1"] * tb["m1"],),
        bsf=(len(BERNSTEIN_TABLES) * tb["Q1"] * bf["D"],), fdesc=(nf, 5)))
    return tb


def fa_assemble_reference(x, tables, exec_mode, v_q=None, v_fq=None,
                          velocity=None):
    """Plain PyTorch version, on any device: (detJ[E, Q], M[E, nd, nd],
    ml[E, nd], K[E, nd, nd], bdrInt[E, nf, fd, fd]) at the nodes x. Remap
    (exec_mode 1, sign +1): v_q[E, Q, dim] and v_fq[E, nf, Qf, dim], the
    mesh velocity at the volume and face points. Transport (exec_mode 0,
    sign -1): `velocity`, the problem's velocity function, evaluated at the
    points."""
    tb = tables
    vol = geo.volume_geometry(x, tb["Bm"], tb["Gm"])
    # the normals from the face tangents, in 1D from the face Jacobians
    if tb["face_tan"] is not None:
        x_fq, nor = geo.face_geometry_tangent(x, tb["Bmf"], *tb["face_tan"])
    else:
        x_fq, nor = geo.face_geometry(x, tb["Bmf"], tb["Gmf"], tb["n_ref"])
    if exec_mode == 0:
        v_q, v_fq = velocity(vol["x_q"]), velocity(x_fq)
        sign = -1.0
    else:
        sign = 1.0
    K = asm.element_convection(v_q, vol["adjJ"], tb["Bu"], tb["Gu"],
                               tb["w_q"], sign)
    bdrInt = asm.face_upwind_matrices(v_fq, nor, tb["w_fq"], tb["Bface"],
                                      exec_mode)
    M = asm.element_mass(vol["detJ"], tb["Bu"], tb["w_q"])
    return vol["detJ"], M, asm.lumped_mass(M), K, bdrInt


def _launcher(tables):
    """The C entry bound once per table dict, with the kernel tables'
    pointers and the size array (E, nm, Q, m1, Q1, D; a launch writes E)."""
    lau = tables.get("launcher")
    if lau is None:
        lib = build.bind(build.load("fa_assemble"), "remhos_fa_assemble",
                         ARGTYPES)
        Q, nm = tables["Bm"].shape
        sizes = (ctypes.c_int * 6)(0, nm, Q, tables["m1"], tables["Q1"],
                                   tables["D"])
        lau = tables["launcher"] = (
            lib, lib.remhos_fa_assemble, sizes,
            tuple(tables[k].data_ptr() for k in KERNEL_TABLES))
    return lau


def fa_assemble(xs, v, tables):
    """(detJ[E, Q], M[E, nd, nd], ml[E, nd], K[E, nd, nd], bdrInt[E, nf,
    fd, fd]) of the remap stage at the moved nodes xs[E, nm, dim] with the
    nodal mesh velocity v[E, nm, dim]; `tables` from `fa_assemble_tables`
    with the kernel's tables (`add_kernel_tables`; raises ValueError
    without). Per call only xs and v are checked."""
    if "bsf" not in tables:
        raise ValueError("fa_assemble takes remap at mesh order 2 on a "
                         "compiled rule with axis-aligned reference normals "
                         "(fa_assemble.engages)")
    Q, nm = tables["Bm"].shape
    dim = tables["Gm"].shape[2]
    nd = tables["Bu"].shape[1]
    nf, Qf = tables["fdesc"].shape[0], tables["w_fq"].shape[0]
    fd = tables["Bface"].shape[1]
    E = xs.shape[0] if xs.dim() == 3 else -1
    core.check_operands("fa_assemble", ("xs", "v"), (xs, v),
                        ((E, nm, dim), (E, nm, dim)), tables)
    device = xs.device
    if device.type == "cpu":
        return fa_assemble_reference(
            xs, tables, 1, geo.interp_nodes(v, tables["Bm"]),
            geo.face_velocity(v, tables["Bmf"]))
    lib, fn, sizes, ptrs = _launcher(tables)
    sizes[0] = E
    out = (xs.new_empty((E, Q)), xs.new_empty((E, nd, nd)),
           xs.new_empty((E, nd)), xs.new_empty((E, nd, nd)),
           xs.new_empty((E, nf, fd, fd)))
    rc = build.call_on(device, fn, xs.element_size(), dim, xs.data_ptr(),
                       v.data_ptr(), *ptrs, *(o.data_ptr() for o in out),
                       sizes, 6)
    if rc:
        build.check(lib, rc, "fa_assemble")
    fa_assemble.launches += 1
    return out


fa_assemble.launches = 0
