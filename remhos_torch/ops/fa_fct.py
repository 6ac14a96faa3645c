"""The assembled stage's flux-based FCT (`-fct 1`) in one kernel: wrapper,
launch count, tables and plain PyTorch version.

`fa_fct` returns, in one launch of `csrc/fa_fct.cu` (CUDA C++, sm_90a),
the limited du[E, nd] of FluxBasedFCT (remhos_fct.cpp:155-181, 307-446)
from the stage's element data K_elem, M, bdrInt and ml (`geom`), u, du_HO,
du_LO and the dof bounds: the diagonal blocks of K_HO, the fluxes F_ij and
`iter_cnt` Zalesak sweeps, reading each input once and keeping every
[E, nd, nd] intermediate in shared memory. No TPU counterpart: the JAX
package runs these in XLA ops (remhos_tpu/fct_flux.py), as
`fa_fct_reference` does.

`fa_fct_reference` is the plain chain, `fct_flux._flux_blocks` (in its
`remhos.flux` span) then `fct_flux._fct_iterations`: the CPU's path, the
tests' reference, and the path of every element the kernel is not
compiled for (`engages`).

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `fa_fct_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import fct_flux
from . import build

_P = ctypes.c_void_p
# remhos_fa_fct: K, M, bdr, u, du_HO, du_LO, u_min, u_max, ml, pairs, du,
# dt, sizes, nsizes, stream
ARGTYPES = [ctypes.c_int] + [_P] * 11 + [
    ctypes.c_double, ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P]
# the dofs per axis of the elements the kernel is compiled for (p = 2..4)
COMPILED_D = (3, 4, 5)
FLOATS = (torch.float32, torch.float64)


def engages(device, dtype, nd, nf, fd) -> bool:
    """Whether the flux-based FCT of elements of nd dofs with nf faces of
    fd dofs runs in the kernel: on a CUDA device, in f32 or f64, for the
    tensor-product elements of p = 2..4 in 2D (nf = 4, nd = D^2, fd = D)
    and 3D (nf = 6, nd = D^3, fd = D^2), D = p + 1. Everything else keeps
    the plain chain."""
    dim = nf // 2
    return (torch.device(device).type == "cuda" and dtype in FLOATS
            and nf in (4, 6) and any(nd == D ** dim and fd == D ** (dim - 1)
                                     for D in COMPILED_D))


def fa_fct_tables(bdr_dofs, nd, device):
    """The static tables, made once per operator, on `device`: `bdr_dofs`
    [nf, fd] (long, the plain chain's) and the face-pair table `pairs`
    [nf, fd, fd] (int32) the kernel reads, whose entry (f, a, b) is the
    flat index bdr_dofs[f, a] nd + bdr_dofs[f, b] of an own-own pair in an
    [nd, nd] block (an edge or corner pair repeats across faces); the
    sizes nd, nf, fd."""
    bd = torch.as_tensor(bdr_dofs, dtype=torch.long, device=device)
    nf, fd = bd.shape
    pairs = (bd[:, :, None] * nd + bd[:, None, :]).to(torch.int32)
    return dict(bdr_dofs=bd, pairs=pairs.contiguous(), nd=nd, nf=nf, fd=fd)


def fa_fct_reference(geom, u, du_ho, du_lo, u_min, u_max, dt, bdr_dofs,
                     iter_cnt=1):
    """Plain PyTorch version, on any device: the flux blocks of K_elem, M
    and bdrInt (`geom`), then the Zalesak sweeps with geom's ml."""
    F, _ = fct_flux._flux_blocks(geom, bdr_dofs, u, du_ho, dt)
    return fct_flux._fct_iterations(F, u, du_lo, geom["ml"], u_min, u_max,
                                    dt, iter_cnt)


def _check(geom, vectors, tables):
    """Raise on operands the kernel does not take: K_elem, M [E, nd, nd],
    bdrInt [E, nf, fd, fd] and the vectors [E, nd], one float dtype (f32
    or f64) and one device; on the card, contiguous."""
    u = vectors[0]
    nd, nf, fd = tables["nd"], tables["nf"], tables["fd"]
    E = u.shape[0] if u.dim() == 2 else -1
    named = dict(K_elem=(geom["K_elem"], (E, nd, nd)),
                 M=(geom["M"], (E, nd, nd)),
                 bdrInt=(geom["bdrInt"], (E, nf, fd, fd)),
                 ml=(geom["ml"], (E, nd)))
    named.update({k: (x, (E, nd)) for k, x in zip(
        ("u", "du_ho", "du_lo", "u_min", "u_max"), vectors)})
    if u.dtype not in FLOATS:
        raise TypeError(f"fa_fct takes float32 or float64, got {u.dtype}")
    for name, (x, shape) in named.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != u.dtype:
            raise TypeError(f"{name} is {x.dtype}, must be {u.dtype}")
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, u on {u.device}")
        if u.device.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fa_fct(geom, u, du_ho, du_lo, u_min, u_max, dt, tables, iter_cnt=1):
    """The limited du[E, nd] of `iter_cnt` flux-based FCT sweeps from
    du_lo, with the fluxes of geom's K_elem, M and bdrInt at u, du_ho and
    dt, the bounds u_min, u_max and geom's ml; `tables` from
    `fa_fct_tables` on u's device."""
    vectors = (u, du_ho, du_lo, u_min, u_max)
    _check(geom, vectors, tables)
    dev = u.device
    if dev.type == "cpu":
        return fa_fct_reference(geom, u, du_ho, du_lo, u_min, u_max, dt,
                                tables["bdr_dofs"], iter_cnt)
    if dev.type != "cuda":
        raise ValueError(f"fa_fct runs on cuda or cpu, not {dev}")
    nd, nf, fd = tables["nd"], tables["nf"], tables["fd"]
    if not engages(dev, u.dtype, nd, nf, fd):
        raise ValueError(f"fa_fct is compiled for p = 2..4 in 2D and 3D, "
                         f"not nd={nd}, nf={nf}, fd={fd} (fa_fct.engages)")
    pairs = tables["pairs"]
    if pairs.device != dev:
        raise ValueError(f"the tables are on {pairs.device}, u on {dev}")
    lau = tables.get("launcher")
    if lau is None:
        lib = build.bind(build.load("fa_fct"), "remhos_fa_fct", ARGTYPES)
        lau = tables["launcher"] = (lib, lib.remhos_fa_fct,
                                    (ctypes.c_int * 5)(0, nd, nf, fd, 0))
    lib, fn, sizes = lau
    sizes[0], sizes[4] = u.shape[0], int(iter_cnt)
    du = torch.empty_like(u)
    rc = build.call_on(dev, fn, u.element_size(), geom["K_elem"].data_ptr(),
                       geom["M"].data_ptr(), geom["bdrInt"].data_ptr(),
                       *(x.data_ptr() for x in vectors),
                       geom["ml"].data_ptr(), pairs.data_ptr(),
                       du.data_ptr(), float(dt), sizes, 5)
    if rc:
        build.check(lib, rc, "fa_fct")
    fa_fct.launches += 1
    return du


fa_fct.launches = 0
