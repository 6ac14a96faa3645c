"""w_q det J at the volume rule from nodal positions: wrapper, launch count
and plain PyTorch version.

`wdet` is the port of `fused_wdet` (remhos_tpu/ops/pallas_kernels.py:1130):
the Jacobian at every volume quadrature point, its closed-form determinant,
times the quadrature weight; J never reaches memory. The kernel is
`csrc/wdet.cu` (CUDA C++, sm_90a): the load stage of the sum-factorized
mesh geometry of `csrc/mesh_geom.cuh` (J by axis-by-axis contractions with
the 1D mesh tables), built by nvcc at first use and called through ctypes.

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
from .tables import check_tables, mesh_factor_block

_P = ctypes.c_void_p
ARGTYPES = [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P]


def wdet_tables(disc, dtype, device):
    """The static tables: Gm[Q, nm, dim] (the plain version reads it), the
    packed 1D mesh tables `msf` (`tables.mesh_factor_block`: the kernel
    reads them), w_q[Q] and the sizes m1, Q1. nm comes from the mesh order,
    not from the solution order. Raises ValueError where the mesh tables
    are not Kronecker products. Checked once here (`tables.check_tables`)."""
    def F(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    tb = dict(Gm=F(np.asarray(disc.Gm, np.float64)), w_q=F(disc.w_q),
              **mesh_factor_block(disc, dtype, device))
    Q, nm, dim = tb["Gm"].shape
    check_tables(tb, shapes=dict(Gm=(Q, nm, dim), w_q=(Q,),
                                 msf=(2 * tb["Q1"] * tb["m1"],)))
    return tb


def wdet_reference(xs, tables):
    """Plain PyTorch version, on any device: w_q det J [E, Q], from the dense
    Gm (a length-nm dot per Jacobian entry)."""
    return tables["w_q"][None, :] * geo.volume_detj(xs, tables["Gm"])


def _launcher(tables):
    """The C entry bound once per table dict, with the tables' pointers and
    the size array (E, nm, Q, m1, Q1; a launch writes E)."""
    lau = tables.get("launcher")
    if lau is None:
        lib = build.bind(build.load("wdet"), "remhos_wdet", ARGTYPES)
        Q, nm, _ = tables["Gm"].shape
        sizes = (ctypes.c_int * 5)(0, nm, Q, tables["m1"], tables["Q1"])
        lau = tables["launcher"] = (lib, lib.remhos_wdet, sizes,
                                    tables["msf"].data_ptr(),
                                    tables["w_q"].data_ptr())
    return lau


def wdet(xs, tables):
    """wdet[E, Q] = w_q det J at the volume rule for nodes xs[E, nm, dim];
    `tables` from `wdet_tables`. Per call only xs is checked."""
    Q, nm, dim = tables["Gm"].shape
    E = xs.shape[0] if xs.dim() == 3 else -1
    core.check_operands("wdet", ("xs",), (xs,), ((E, nm, dim),), tables)
    device = xs.device
    if device.type == "cpu":
        return wdet_reference(xs, tables)
    lib, fn, sizes, msf, w_q = _launcher(tables)
    sizes[0] = E
    out = xs.new_empty((E, Q))
    rc = build.call_on(device, fn, xs.element_size(), dim, xs.data_ptr(),
                       msf, w_q, out.data_ptr(), sizes, 5)
    if rc:
        build.check(lib, rc, "wdet")
    wdet.launches += 1
    return out


wdet.launches = 0
