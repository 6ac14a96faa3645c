"""The limited remap stage in one kernel: wrapper, launch count and plain
PyTorch version.

`mega_stage` is the port of `fused_stage_mega_poly`
(remhos_tpu/ops/pallas_kernels.py:889): the whole -ho 3 -lo 5 -fct 2 stage
(polynomial stage geometry, HO solve, DG upwind face flux, Jacobi GL mass
inverse, MassBasedAvg LO, lumped mass, ClipScale) with only the limited du
written to memory. The kernel is `csrc/mega_stage.cu` (CUDA C++, sm_90a),
built by nvcc at first use and called through ctypes.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `mega_stage_reference`, the plain PyTorch version of
the same function built from `lo.mass_based_avg` and `fct.clip_scale`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import fct, lo
from . import build
from .tables import poly_layout

SOURCES = ["mega_stage.cu"]
FLOAT_TABLES = ("GuT", "Buw", "Bface", "SBf", "A", "AT", "BglT", "Bgl",
                "Bgl2", "Bu")
INT_TABLES = ("bdr", "dof_faces", "cls")


def default_sweeps(dtype) -> int:
    """Jacobi sweeps from the D^-1 b start: the start is within ~2.5e-3 and
    each sweep contracts ~2.5e-3, so 1 sweep reaches f32 round-off and 8
    reach f64 round-off (pallas_kernels.py:916-921)."""
    return 1 if dtype == torch.float32 else 8


def mega_stage_reference(t, dt, u, u_nbr, smin, smax, P, tables, n_cg):
    """Plain PyTorch version of the kernel, on any device.

    t, dt: stage time and limiter dt (rounded to u's dtype, as the kernel
    takes them); u[E, nd]; u_nbr[E, nf*fd]; smin/smax[3^dim, E] class-major
    stencil; P[E, width] (tables.poly_layout); tables from
    tables.stage_ho_tables."""
    tb = tables
    dim, nd, Q, Qf, nf, fd = (tb[k] for k in ("dim", "nd", "Q", "Qf", "nf",
                                               "fd"))
    E, FQ = u.shape[0], nf * Qf
    lay = poly_layout(dim, Q, FQ)
    t = float(torch.tensor(t, dtype=u.dtype))
    dt = float(torch.tensor(dt, dtype=u.dtype))

    def horner(offs, n):
        acc = P[:, offs[-1]:offs[-1] + n]
        for o in reversed(offs[:-1]):
            acc = P[:, o:o + n] + t * acc
        return acc

    grad = u @ tb["GuT"]                                   # [E, dim*Q]
    du_q = None
    for b in range(dim):
        va_b = horner([lay["va"] + (k * dim + b) * Q
                       for k in range(lay["nkv"])], Q)
        term = va_b * grad[:, b * Q:(b + 1) * Q]
        du_q = term if du_q is None else du_q + term
    wdet = horner([lay["wdet"] + k * Q for k in range(lay["nkd"])], Q)
    vn = horner([lay["vn"] + k * FQ for k in range(lay["nkn"])], FQ)

    bdr = tb["bdr"].long()
    Bface = tb["Bface"]
    un_q = u_nbr.reshape(E, nf, fd) @ Bface.T              # [E, nf, Qf]
    uo_q = u[:, bdr] @ Bface.T
    flux = vn.clamp(min=0.0).reshape(E, nf, Qf) * (un_q - uo_q)
    Ku = (du_q @ tb["Buw"]).index_add(1, bdr.reshape(-1),
                                      (flux @ tb["SBf"]).reshape(E, -1))

    b_ = Ku @ tb["A"]
    inv_diag = 1.0 / (wdet @ tb["Bgl2"])
    x = inv_diag * b_
    for _ in range(n_cg):
        x = x + inv_diag * (b_ - ((x @ tb["BglT"]) * wdet) @ tb["Bgl"])
    du_ho = x @ tb["AT"]

    w_q = tb["w_q"]
    du_lo = lo.mass_based_avg(u, du_ho, dt, wdet / w_q, w_q, tb["Bu"])
    ml = wdet @ tb["Bu"]
    cls = tb["cls"].long()
    return fct.clip_scale(u, ml, du_ho, du_lo, smin[cls].T, smax[cls].T, dt)


def _shapes(tb, E):
    """The shape the kernel indexes each operand and table with."""
    dim, nd, Q, Qf, nf, fd = (tb[k] for k in ("dim", "nd", "Q", "Qf", "nf",
                                               "fd"))
    ncls = 3 ** dim
    return dict(u=(E, nd), u_nbr=(E, nf * fd), smin=(ncls, E),
                smax=(ncls, E), P=(E, poly_layout(dim, Q, nf * Qf)["width"]),
                GuT=(nd, dim * Q), Buw=(Q, nd), Bface=(Qf, fd), SBf=(Qf, fd),
                A=(nd, nd), AT=(nd, nd), BglT=(nd, Q), Bgl=(Q, nd),
                Bgl2=(Q, nd), Bu=(Q, nd), bdr=(nf, fd), dof_faces=(nd, dim),
                cls=(nd,))


def _check(u, u_nbr, smin, smax, P, tables):
    """Raise on a dtype, shape or device the kernel does not take."""
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mega_stage takes float32 or float64, got {u.dtype}")
    ops = dict(u=u, u_nbr=u_nbr, smin=smin, smax=smax, P=P,
               **{k: tables[k] for k in FLOAT_TABLES + INT_TABLES})
    for name, shape in _shapes(tables, u.shape[0]).items():
        x = ops[name]
        want = torch.int32 if name in INT_TABLES else u.dtype
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != want:
            raise TypeError(f"{name} is {x.dtype}, must be {want}")
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, u on {u.device}")


def mega_stage(t, dt, u, u_nbr, smin, smax, P, tables):
    """du_limited[E, nd] for one stage, with default_sweeps(u.dtype) Jacobi
    sweeps; see the module docstring."""
    _check(u, u_nbr, smin, smax, P, tables)
    n_cg = default_sweeps(u.dtype)
    if u.device.type == "cpu":
        return mega_stage_reference(t, dt, u, u_nbr, smin, smax, P, tables,
                                    n_cg)
    if u.device.type != "cuda":
        raise ValueError(f"mega_stage runs on cuda or cpu, not {u.device}")
    tb = tables
    # pointer order of Args in csrc/mega_stage.cu
    names = ("u", "u_nbr", "P", "smin", "smax") + FLOAT_TABLES + INT_TABLES
    ops = [u, u_nbr, P, smin, smax] + [tb[k] for k in names[5:]]
    for name, x in zip(names, ops):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    du = torch.empty_like(u)
    lib = _library()
    ptrs = (ctypes.c_void_p * 19)(*[x.data_ptr() for x in ops + [du]])
    sizes = (ctypes.c_int * 7)(u.shape[0], tb["nd"], tb["Q"], tb["Qf"],
                               tb["nf"], tb["fd"], n_cg)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.remhos_mega_stage(u.element_size(), tb["dim"], ptrs, 19,
                                   float(t), float(dt), sizes, 7, stream)
    if rc != 0:
        msg = (lib.remhos_cuda_error_string(rc).decode() if rc > 0
               else f"bad argument ({rc})")
        raise RuntimeError(f"mega_stage launch failed: {msg}")
    mega_stage.launches += 1
    return du


mega_stage.launches = 0


def _library():
    lib = build.load("mega_stage", SOURCES)
    if not getattr(lib, "_remhos_bound", False):
        lib.remhos_mega_stage.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
        lib.remhos_mega_stage.restype = ctypes.c_int
        lib.remhos_cuda_error_string.argtypes = [ctypes.c_int]
        lib.remhos_cuda_error_string.restype = ctypes.c_char_p
        lib._remhos_bound = True
    return lib
