"""w_q det J at the volume rule from nodal positions, and in the face
variant the upwind face weights as well: wrapper, launch counts and plain
PyTorch version.

`wdet` is the port of `fused_wdet` (remhos_tpu/ops/pallas_kernels.py:1130):
the Jacobian at every volume quadrature point, its closed-form determinant,
times the quadrature weight; J never reaches memory. The kernel is
`csrc/wdet.cu` (CUDA C++, sm_90a): the load stage of the sum-factorized
mesh geometry of `csrc/mesh_geom.cuh` (J by axis-by-axis contractions with
the 1D mesh tables), built by nvcc at first use and called through ctypes.

Given the nodal mesh velocity v and tables made with `face=True`, the same
kernel's face variant also returns the non-fused remap stage's upwind face
weights wvn[E, nf, Qf] = w_fq max(0, v . n), n the scaled outward normals
from the face tangents, with the face part of the mesh geometry (kernel
5's). `wdet.variant_launches` counts the launches of each variant ("wdet",
"face").

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `wdet_reference`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import geometry as geo
from . import build
from . import stage_core as core
from .tables import check_tables, face_descriptors, mesh_factor_block

_P = ctypes.c_void_p
_SIZES = ctypes.POINTER(ctypes.c_int)
ARGTYPES = [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _SIZES,
            ctypes.c_int, _P]
# remhos_wdet_face: xs, v, msf, w_q, fdesc, w_fq, wdet, wvn
ARGTYPES_FACE = [ctypes.c_int, ctypes.c_int] + [_P] * 8 + [
    _SIZES, ctypes.c_int, _P]


def wdet_tables(disc, dtype, device, face=False):
    """The static tables: Gm[Q, nm, dim] (the plain version reads it), the
    packed 1D mesh tables `msf` (`tables.mesh_factor_block`: the kernel
    reads them), w_q[Q] and the sizes m1, Q1. nm comes from the mesh order,
    not from the solution order. Raises ValueError where the mesh tables
    are not Kronecker products. With `face`, also the face variant's: the
    face descriptors fdesc[nf, 5] (`tables.face_descriptors`, which raises
    without axis-aligned reference normals) and w_fq[Qf], which the kernel
    reads, and the plain version's Bmf[nf Qf, nm] and face tangents
    `face_tan` = (Gt[nf, Qf, nm, dim-1], sign[nf]). Checked once here
    (`tables.check_tables`)."""
    def F(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    tb = dict(Gm=F(np.asarray(disc.Gm, np.float64)), w_q=F(disc.w_q),
              **mesh_factor_block(disc, dtype, device))
    Q, nm, dim = tb["Gm"].shape
    shapes = dict(Gm=(Q, nm, dim), w_q=(Q,), msf=(2 * tb["Q1"] * tb["m1"],))
    if face:
        fdesc = face_descriptors(disc)
        Gt, sgn = geo.face_tangent_tables(disc.Gmf, disc.n_ref)
        nf, Qf = Gt.shape[:2]
        tb.update(fdesc=torch.as_tensor(fdesc, device=device),
                  w_fq=F(disc.w_fq),
                  Bmf=F(np.asarray(disc.Bmf).reshape(nf * Qf, nm)),
                  face_tan=(F(Gt), F(sgn)))
        shapes.update(fdesc=(nf, 5), w_fq=(Qf,), Bmf=(nf * Qf, nm))
    check_tables(tb, shapes=shapes)
    return tb


def wdet_reference(xs, tables, v=None):
    """Plain PyTorch version, on any device: w_q det J [E, Q], from the dense
    Gm (a length-nm dot per Jacobian entry); with v, (wdet, wvn) with
    wvn = w_fq max(0, v . n), v at the face points from the nodal v, n from
    `geometry.face_normals_tangent` and v . n as elementwise products summed
    over the last axis."""
    wdet = tables["w_q"][None, :] * geo.volume_detj(xs, tables["Gm"])
    if v is None:
        return wdet
    nor = geo.face_normals_tangent(xs, *tables["face_tan"])
    v_fq = geo.interp_nodes(v, tables["Bmf"]).reshape(nor.shape)
    vn = (v_fq * nor).sum(-1)
    return wdet, tables["w_fq"] * vn.clamp(min=0.0)


def _launcher(tables, face):
    """The C entry bound once per table dict and variant, with the tables'
    pointers and the size array (E, nm, Q, m1, Q1; a launch writes E)."""
    key = ("launcher", face)
    lau = tables.get(key)
    if lau is None:
        if face:
            entry, argtypes = "remhos_wdet_face", ARGTYPES_FACE
            names = ("msf", "w_q", "fdesc", "w_fq")
        else:
            entry, argtypes, names = "remhos_wdet", ARGTYPES, ("msf", "w_q")
        lib = build.bind(build.load("wdet"), entry, argtypes)
        Q, nm, _ = tables["Gm"].shape
        sizes = (ctypes.c_int * 5)(0, nm, Q, tables["m1"], tables["Q1"])
        lau = tables[key] = (lib, getattr(lib, entry), sizes,
                             tuple(tables[n].data_ptr() for n in names))
    return lau


def wdet(xs, tables, v=None):
    """wdet[E, Q] = w_q det J at the volume rule for nodes xs[E, nm, dim];
    `tables` from `wdet_tables`. With the nodal mesh velocity v[E, nm, dim]
    (tables made with `face=True`), the face variant: (wdet, wvn[E, nf,
    Qf]). Per call only xs and v are checked."""
    Q, nm, dim = tables["Gm"].shape
    E = xs.shape[0] if xs.dim() == 3 else -1
    face = v is not None
    if face and "fdesc" not in tables:
        raise ValueError("the face variant needs tables made with "
                         "wdet_tables(..., face=True)")
    operands = (xs, v) if face else (xs,)
    core.check_operands("wdet", ("xs", "v"), operands,
                        ((E, nm, dim),) * len(operands), tables)
    device = xs.device
    if device.type == "cpu":
        return wdet_reference(xs, tables, v)
    lib, fn, sizes, ptrs = _launcher(tables, face)
    sizes[0] = E
    out = xs.new_empty((E, Q))
    if face:
        nf, Qf = tables["fdesc"].shape[0], tables["w_fq"].shape[0]
        wvn = xs.new_empty((E, nf, Qf))
        msf, w_q, fdesc, w_fq = ptrs
        rc = build.call_on(device, fn, xs.element_size(), dim, xs.data_ptr(),
                           v.data_ptr(), msf, w_q, fdesc, w_fq,
                           out.data_ptr(), wvn.data_ptr(), sizes, 5)
    else:
        rc = build.call_on(device, fn, xs.element_size(), dim, xs.data_ptr(),
                           *ptrs, out.data_ptr(), sizes, 5)
    if rc:
        build.check(lib, rc, "wdet")
    wdet.launches += 1
    wdet.variant_launches["face" if face else "wdet"] += 1
    return (out, wvn) if face else out


wdet.launches = 0
wdet.variant_launches = {"wdet": 0, "face": 0}
