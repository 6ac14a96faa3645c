"""What the stage kernels share on the Python side: the plain PyTorch
version of their common core and the operand checks of their wrappers.

`poly_stage_core_reference` is the counterpart of `_poly_stage_core`
(remhos_tpu/ops/pallas_kernels.py:578), as `csrc/stage_core.cuh` is on the
CUDA side: the plain versions of `mega_stage` and `stage_ho` both call it,
and `jacobi_gl_inverse`, its mass inverse, also serves `stage_ho_nodes`.
"""

from __future__ import annotations

import ctypes

import torch

from .tables import poly_layout

FLOAT_TABLES = ("GuT", "Buw", "Bface", "SBf", "A", "AT", "BglT", "Bgl",
                "Bgl2", "Bu")
INT_TABLES = ("bdr", "dof_faces")
# pointer order of CoreArgs in csrc/stage_core.cuh
CORE_OPERANDS = ("u", "u_nbr", "P") + FLOAT_TABLES + INT_TABLES
SIZE_KEYS = ("nd", "Q", "Qf", "nf", "fd")

LAUNCH_ARGTYPES = [
    ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
    ctypes.c_int, ctypes.c_double, ctypes.c_double,
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]


def default_sweeps(dtype) -> int:
    """Jacobi sweeps from the D^-1 b start: the start is within ~2.5e-3 and
    each sweep contracts ~2.5e-3, so 1 sweep reaches f32 round-off and 8
    reach f64 round-off (pallas_kernels.py:916-921)."""
    return 1 if dtype == torch.float32 else 8


def as_dtype(x, dtype) -> float:
    """A Python float rounded to `dtype`, as the kernels take t and dt."""
    return float(torch.tensor(x, dtype=dtype))


def poly_stage_core_reference(t, u, u_nbr, P, tables, n_cg):
    """(du_HO[E, nd], wdet[E, Q]) in plain PyTorch, on any device; with
    n_cg == 0, (Ku, wdet).

    t: stage time, already rounded to u's dtype; u[E, nd]; u_nbr[E, nf*fd];
    P[E, width] (tables.poly_layout); tables from tables.stage_ho_tables."""
    tb = tables
    dim, Q, Qf, nf, fd = (tb[k] for k in ("dim", "Q", "Qf", "nf", "fd"))
    E, FQ = u.shape[0], nf * Qf
    lay = poly_layout(dim, Q, FQ)

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
    if n_cg == 0:
        return Ku, wdet
    return jacobi_gl_inverse(Ku, wdet, tb, n_cg), wdet


def jacobi_gl_inverse(Ku, wdet, tables, n_cg):
    """Steps 4-6 of the core: du_HO = x A^T after b = Ku A, x = D^-1 b and
    n_cg Jacobi sweeps x += D^-1 (b - M_gl x), M_gl x = ((x Bgl^T) wdet) Bgl.
    The plain versions of the three stage kernels share it."""
    tb = tables
    b_ = Ku @ tb["A"]
    inv_diag = 1.0 / (wdet @ tb["Bgl2"])
    x = inv_diag * b_
    for _ in range(n_cg):
        x = x + inv_diag * (b_ - ((x @ tb["BglT"]) * wdet) @ tb["Bgl"])
    return x @ tb["AT"]


def core_shapes(tb, E):
    """The shape the kernels index each core operand and table with."""
    dim, nd, Q, Qf, nf, fd = (tb[k] for k in ("dim", "nd", "Q", "Qf", "nf",
                                               "fd"))
    return dict(u=(E, nd), u_nbr=(E, nf * fd),
                P=(E, poly_layout(dim, Q, nf * Qf)["width"]),
                GuT=(nd, dim * Q), Buw=(Q, nd), Bface=(Qf, fd), SBf=(Qf, fd),
                A=(nd, nd), AT=(nd, nd), BglT=(nd, Q), Bgl=(Q, nd),
                Bgl2=(Q, nd), Bu=(Q, nd), bdr=(nf, fd), dof_faces=(nd, dim))


def check_operands(what, ops, shapes, int_names):
    """Raise on a dtype, shape or device the kernels do not take. `ops` and
    `shapes` are dicts by operand name; ops["u"] sets dtype and device."""
    u = ops["u"]
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, got {u.dtype}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {u.device}")
    for name, shape in shapes.items():
        x = ops[name]
        want = torch.int32 if name in int_names else u.dtype
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != want:
            raise TypeError(f"{name} is {x.dtype}, must be {want}")
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, u on {u.device}")
        if u.device.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch(lib, fn, tensors, u, tables, t, dt, n_cg):
    """Call a stage library's C entry `fn` on PyTorch's current stream with
    `tensors` (None -> a null pointer) in the kernel's pointer order.
    Returns the entry's return code."""
    tb = tables
    n = len(tensors)
    ptrs = (ctypes.c_void_p * n)(*[None if x is None else x.data_ptr()
                                   for x in tensors])
    sizes = (ctypes.c_int * 7)(u.shape[0], *[tb[k] for k in SIZE_KEYS], n_cg)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        return getattr(lib, fn)(u.element_size(), tb["dim"], ptrs, n,
                                float(t), float(dt), sizes, 7, stream)
