"""The monolithic solver's limited fluctuations (`-mono 1`) in one kernel:
wrapper, launch count, tables and plain PyTorch version.

`mono_rd` returns, in one launch of `csrc/mono_rd.cu` (CUDA C++, sm_90a),
the explicit part of MonoRDSolver (remhos_mono.cpp:60-260) from the stage's
element data K_elem, bdrInt and ml (`geom`), u, the dof bounds, the
smoothness indicator's dof values (with `-si`) and the neighbour face values
u_nbr: K u, the per-dof limiter alphas, the alpha-weighted nonlinear flux
lumping and the RD weights of the rest, an element at a time, every element
intermediate in registers or shared memory. Where the inner consistent-mass
loop follows (`final` false) it also returns d_full, K u plus the alpha = 1
lumping, which only that loop reads; on problems 6 and 7 (`final` true, no
loop, remhos.cpp:999) it returns the explicit part's rate (du + 0) / ml
and no d_full. No TPU counterpart: the JAX package runs these in XLA ops
(remhos_tpu/mono.py), as `mono_rd_reference` does.

`mono_rd_reference` is the plain chain, moved unchanged from
`mono.explicit_part`: the CPU's path, the tests' reference, `-mono 2`'s
path (the subcell RD) and the path of every element the kernel is not
compiled for (`engages`).

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `mono_rd_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import assembly as asm
from .. import lo as lom
from ..mono_lumping import BETA, EPS, GAMMA, nonlin_flux_lumping
from . import build

_P = ctypes.c_void_p
# remhos_mono_rd: K, bdr, u, xi_min, xi_max, si, ml, u_nbr, slots, fdofs,
# du, d_full, sizes, nsizes, stream
ARGTYPES = [ctypes.c_int] + [_P] * 12 + [
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P]
# the (dim, nd) of the elements the kernel is compiled for: 2D p = 1 (the
# benchmark's transport cell) and p = 2, the only `-mono 1` sizes that run
# and are timed against the plain chain on the card
COMPILED = ((2, 4), (2, 9))
FLOATS = (torch.float32, torch.float64)


def engages(device, dtype, dim, nd, mono_type) -> bool:
    """Whether the explicit part of `-mono <mono_type>` on elements of nd
    dofs in `dim` dimensions runs in the kernel: on a CUDA device, in f32 or
    f64, for `-mono 1`, on the quads of 2D p = 1 and 2. Everything else
    (`-mono 2`'s subcell RD among it) keeps the plain chain."""
    return (torch.device(device).type == "cuda" and dtype in FLOATS
            and mono_type == 1 and (dim, nd) in COMPILED)


def mono_rd_tables(bdr_dofs, nd, device):
    """The static tables, made once per operator, on `device`: `bdr_dofs`
    [nf, fd] (long, the plain chain's; int32 as `fdofs`, the kernel's) and
    the slot table `slots` [nd, dim] (int32) whose row i lists f fd + a for
    each face f that holds dof i at position a, in face order, padded with
    -1 (a dof lies on at most one face an axis); the sizes nd, nf, fd,
    dim."""
    bd = torch.as_tensor(bdr_dofs, dtype=torch.long)
    nf, fd = bd.shape
    dim = nf // 2
    slots = torch.full((nd, dim), -1, dtype=torch.int32)
    held = [0] * nd
    for k, i in enumerate(bd.reshape(-1).tolist()):
        if held[i] == dim:
            raise ValueError(f"dof {i} lies on more than {dim} faces")
        slots[i, held[i]] = k
        held[i] += 1
    return dict(bdr_dofs=bd.to(device),
                fdofs=bd.to(device=device, dtype=torch.int32).contiguous(),
                slots=slots.to(device), nd=nd, nf=nf, fd=fd, dim=dim)


def mono_rd_reference(geom, u, xi_min, xi_max, si_dof, u_nbr, bdr_dofs,
                      final, sub2ind=None):
    """Plain PyTorch version, on any device: (du, d_full) of the explicit
    part, du the limited fluctuations with the face terms and the RD
    weighting, d_full the unlimited ones; with `final` ((du + 0) / ml,
    None). si_dof None without -si; u_nbr [E, nf, fd]; sub2ind (with
    geom's sub_w) for `-mono 2`'s subcell RD."""
    K, bdrInt = geom["K_elem"], geom["bdrInt"]
    z = asm.matvec(K, u)
    d_full = z

    # the per-dof limiter alpha (remhos_mono.cpp:128-154)
    up = xi_max - u
    dn = u - xi_min
    alpha = torch.clamp(BETA * torch.minimum(up, dn)
                        / (torch.maximum(up, dn) + EPS), max=1.0)
    if si_dof is not None:
        t = si_dof
        bndN = torch.clamp(t * (2. * u - xi_max) + (1. - t) * xi_min,
                           min=0.0)
        bndP = torch.clamp(t * (2. * u - xi_min) + (1. - t) * xi_max,
                           max=1.0)
        aN = torch.clamp(BETA * (u - bndN) / (xi_max - u + EPS), max=1.0)
        aP = torch.clamp(BETA * (bndP - u) / (u - xi_min + EPS), max=1.0)
        mid = xi_min + xi_max
        alpha = torch.where(mid > 2. * u + EPS, aN,
                            torch.where(mid < 2. * u - EPS, aP, alpha))

    du = alpha * z
    z = z - alpha * z

    # the face terms: nonlinear lumping with alpha (du) and, where the inner
    # loop reads it, alpha = 1 (d_full)
    u_face = asm.gather_face(u, bdr_dofs)
    alpha_face = alpha[:, bdr_dofs]
    du = asm.scatter_face_add(
        du, nonlin_flux_lumping(u_face, u_nbr, bdrInt, alpha_face), bdr_dofs)
    if not final:
        d_full = asm.scatter_face_add(
            d_full, nonlin_flux_lumping(u_face, u_nbr, bdrInt,
                                        torch.ones_like(alpha_face)),
            bdr_dofs)

    # the residual distribution of the unsplit part z (remhos_mono.cpp:
    # 168-260): `residual_distribution_core`'s formulas without its face
    # accumulator and ml division, with the subcell blending GAMMA
    sub_kw = {}
    if sub2ind is not None:
        sub_kw = dict(subcell=True, subcell_weights=geom["sub_w"],
                      sub2ind=sub2ind, gamma=GAMMA)
    du = du + lom.residual_distribution_core(u, z, torch.zeros_like(u),
                                             torch.ones_like(u), **sub_kw)
    if final:
        return (du + torch.zeros_like(u)) / geom["ml"], None
    return du, d_full


def _check(geom, u, vectors, u_nbr, tables):
    """Raise on operands the kernel does not take: K_elem [E, nd, nd],
    bdrInt [E, nf, fd, fd], u_nbr [E, nf, fd] and the vectors [E, nd] (si
    None without -si), one float dtype (f32 or f64) and one device; on the
    card, contiguous, K_elem, bdrInt and u_nbr from 16-byte boundaries."""
    nd, nf, fd = tables["nd"], tables["nf"], tables["fd"]
    E = u.shape[0] if u.dim() == 2 else -1
    named = dict(K_elem=(geom["K_elem"], (E, nd, nd)),
                 bdrInt=(geom["bdrInt"], (E, nf, fd, fd)),
                 ml=(geom["ml"], (E, nd)), u=(u, (E, nd)),
                 u_nbr=(u_nbr, (E, nf, fd)))
    named.update({k: (x, (E, nd)) for k, x in zip(
        ("xi_min", "xi_max", "si_dof"), vectors) if x is not None})
    if u.dtype not in FLOATS:
        raise TypeError(f"mono_rd takes float32 or float64, got {u.dtype}")
    cuda = u.device.type == "cuda"
    for name, (x, shape) in named.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != u.dtype:
            raise TypeError(f"{name} is {x.dtype}, must be {u.dtype}")
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, u on {u.device}")
        if cuda and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if cuda and name in ("K_elem", "bdrInt", "u_nbr") \
                and x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def mono_rd(geom, u, xi_min, xi_max, si_dof, u_nbr, tables, final):
    """(du, d_full) of `-mono 1`'s explicit part, as `mono_rd_reference`
    gives them, from geom's K_elem, bdrInt and ml, u, the dof bounds xi_min,
    xi_max, the indicator's dof values si_dof (None without -si) and the
    neighbour values u_nbr [E, nf, fd]; `tables` from `mono_rd_tables` on
    u's device. With `final` (problems 6 and 7) ((du + 0) / ml, None)."""
    _check(geom, u, (xi_min, xi_max, si_dof), u_nbr, tables)
    dev = u.device
    if dev.type == "cpu":
        return mono_rd_reference(geom, u, xi_min, xi_max, si_dof, u_nbr,
                                 tables["bdr_dofs"], final)
    if dev.type != "cuda":
        raise ValueError(f"mono_rd runs on cuda or cpu, not {dev}")
    nd, nf, fd, dim = (tables[k] for k in ("nd", "nf", "fd", "dim"))
    if not engages(dev, u.dtype, dim, nd, 1):
        raise ValueError(f"mono_rd is compiled for 2D p = 1 and 2, not "
                         f"dim={dim}, nd={nd} (mono_rd.engages)")
    slots = tables["slots"]
    if slots.device != dev:
        raise ValueError(f"the tables are on {slots.device}, u on {dev}")
    lau = tables.get("launcher")
    if lau is None:
        lib = build.bind(build.load("mono_rd"), "remhos_mono_rd", ARGTYPES)
        lau = tables["launcher"] = (lib, lib.remhos_mono_rd,
                                    (ctypes.c_int * 6)(0, nd, nf, fd, 0, 0))
    lib, fn, sizes = lau
    sizes[0], sizes[4], sizes[5] = u.shape[0], si_dof is not None, not final
    du = torch.empty_like(u)
    d_full = None if final else torch.empty_like(u)
    rc = build.call_on(dev, fn, u.element_size(), geom["K_elem"].data_ptr(),
                       geom["bdrInt"].data_ptr(), u.data_ptr(),
                       xi_min.data_ptr(), xi_max.data_ptr(),
                       None if si_dof is None else si_dof.data_ptr(),
                       geom["ml"].data_ptr(), u_nbr.data_ptr(),
                       slots.data_ptr(), tables["fdofs"].data_ptr(),
                       du.data_ptr(),
                       None if d_full is None else d_full.data_ptr(),
                       sizes, 6)
    if rc:
        build.check(lib, rc, "mono_rd")
    mono_rd.launches += 1
    return du, d_full


mono_rd.launches = 0
