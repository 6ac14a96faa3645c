"""What the stage kernels share on the Python side: the plain PyTorch
version of their common core, the operand checks of their wrappers and
their launch path.

`poly_stage_core_reference` is the counterpart of `_poly_stage_core`
(remhos_tpu/ops/pallas_kernels.py:578), as `csrc/stage_core.cuh` is on the
CUDA side: the plain versions of `mega_stage` and `stage_ho` both call it,
and `jacobi_gl_inverse`, its mass inverse, also serves `stage_ho_nodes`.

The static tables are checked once, where `ops.tables` builds them
(`tables.check_tables` records the check in the table dict); a wrapper
checks per call only the operands that change between calls. `Launcher`
keeps each library's pointer and size arrays per table dict, so a launch
writes only the operands' pointers, E and n_cg.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .tables import check_tables, poly16_layout, poly_layout

# pointer order of CoreArgs in csrc/stage_core.cuh: the per-call operands,
# then the static tables the kernels read (the packed 1D factors and the
# face index tables)
CORE_OPERANDS = ("u", "u_nbr", "P", "sf", "bdr", "dof_faces")
# sizes of the C interface: E, then these, then n_cg, D, Q1
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


def poly_stage_core_reference(t, u, u_nbr, P, tables, n_cg, P16=None):
    """(du_HO[E, nd], wdet[E, Q]) in plain PyTorch, on any device; with
    n_cg == 0, (Ku, wdet).

    t: stage time, already rounded to u's dtype; u[E, nd]; u_nbr[E, nf*fd];
    P[E, width] (tables.poly_layout); tables from tables.stage_ho_tables.
    With P16 (bf16 [E, width16], tables.poly16_layout): P is WDET alone and
    va, vn come from P16, each coefficient converted to u's dtype first."""
    tb = tables
    dim, Q, Qf, nf, fd = (tb[k] for k in ("dim", "Q", "Qf", "nf", "fd"))
    E, FQ = u.shape[0], nf * Qf
    if P16 is None:
        lay, Pva = poly_layout(dim, Q, FQ), P
    else:
        lay, Pva = poly16_layout(dim, Q, FQ), P16.to(u.dtype)

    def horner(M, offs, n):
        acc = M[:, offs[-1]:offs[-1] + n]
        for o in reversed(offs[:-1]):
            acc = M[:, o:o + n] + t * acc
        return acc

    grad = u @ tb["GuT"]                                   # [E, dim*Q]
    du_q = None
    for b in range(dim):
        va_b = horner(Pva, [lay["va"] + (k * dim + b) * Q
                            for k in range(lay["nkv"])], Q)
        term = va_b * grad[:, b * Q:(b + 1) * Q]
        du_q = term if du_q is None else du_q + term
    wdet = horner(P, [lay["wdet"] + k * Q for k in range(lay["nkd"])], Q)
    vn = horner(Pva, [lay["vn"] + k * FQ for k in range(lay["nkn"])], FQ)

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


def operand_shapes(tb, E, p16=False):
    """The shapes the kernels index the per-call core operands u, u_nbr and
    P with (with `p16`, P's WDET-only shape), made once per (table dict, E,
    p16)."""
    key = ("operand_shapes", E, p16)
    shapes = tb.get(key)
    if shapes is None:
        dim, nd, Q, Qf, nf, fd = (tb[k] for k in ("dim", "nd", "Q", "Qf",
                                                   "nf", "fd"))
        lay = (poly16_layout if p16 else poly_layout)(dim, Q, nf * Qf)
        shapes = tb[key] = ((E, nd), (E, nf * fd), (E, lay["width"]))
    return shapes


def check_p16(what, P16, u, tables):
    """Raise unless P16 is the bf16 [E, width16] stream of an f32 stage on
    the tables' device, contiguous: the kernels take P16 in f32 only (the
    JAX package ignores poly_bf16 in f64)."""
    if u.dtype != torch.float32:
        raise TypeError(f"{what}: the bf16 P16 stream is float32 only, u is "
                        f"{u.dtype}")
    tb = tables
    shape = (u.shape[0], poly16_layout(tb["dim"], tb["Q"],
                                       tb["nf"] * tb["Qf"])["width16"])
    if tuple(P16.shape) != shape:
        raise ValueError(f"P16 must be {shape}, got {tuple(P16.shape)}")
    if P16.dtype != torch.bfloat16:
        raise TypeError(f"P16 is {P16.dtype}, must be torch.bfloat16")
    if P16.device != u.device:
        raise ValueError(f"P16 is on {P16.device}, u on {u.device}")
    if not P16.is_contiguous():
        raise ValueError("P16 must be contiguous")


def check_operands(what, names, tensors, shapes, tables, key="checked"):
    """Raise on a dtype, shape or device the kernels do not take. `names`,
    `tensors` and `shapes` list the per-call operands, u first: u must be
    float32 or float64, and every operand must have the shape given and the
    dtype and device of the tables (checked once: `tables.check_tables`);
    on the card, be contiguous."""
    dtype, device = tables.get(key) or check_tables(tables)
    cuda = device.type == "cuda"
    for x, shape in zip(tensors, shapes):
        if (x.shape != shape or x.dtype != dtype or x.device != device
                or (cuda and not x.is_contiguous())):
            _refuse(what, names, tensors, shapes, dtype, device)


def _refuse(what, names, tensors, shapes, dtype, device):
    """Raise the error of the first operand that fails the checks."""
    u = tensors[0]
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, got {u.dtype}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {u.device}")
    for name, x, shape in zip(names, tensors, shapes):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, must be {dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the tables on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class Launcher:
    """A stage library's C entry bound once per table dict: the pointer
    array holds the static tables' pointers from the start, the size array
    its fixed sizes; a launch writes the per-call pointers, E and n_cg and
    calls the entry on PyTorch's current stream (`build.call_on`)."""

    def __init__(self, name, entry, argtypes, tables, order, static, sizes):
        if tables.get("sf") is None:
            raise ValueError(f"{name}: the tables lack the 1D factors `sf` "
                             "(ops.tables.stage_ho_tables builds them)")
        lib = build.bind(build.load(name), entry, argtypes)
        self.name, self.lib, self.fn = name, lib, getattr(lib, entry)
        self.ptrs = (ctypes.c_void_p * len(order))()
        self.dynamic = [i for i, k in enumerate(order) if k not in static]
        for i, k in enumerate(order):
            if k in static and tables.get(k) is not None:
                self.ptrs[i] = tables[k].data_ptr()
        self.sizes = (ctypes.c_int * len(sizes))(*sizes)
        self.tables = tables            # keeps the static tensors alive

    @classmethod
    def get(cls, name, entry, argtypes, tables, order, static, sizes):
        """The launcher of `entry` for this table dict, made at first use."""
        key = ("launcher", entry)
        lau = tables.get(key)
        if lau is None:
            lau = tables[key] = cls(name, entry, argtypes, tables, order,
                                    static, sizes)
        return lau

    def __call__(self, device, head, tensors, tail, E, n_cg, *more):
        """Launch with `tensors` in the dynamic slots (None -> null), E and
        n_cg in size slots 0 and 6 and `more` from slot 9 on; the entry's
        arguments are `head`, the pointer array, `tail`, the size array.
        Raises on a nonzero return code."""
        for i, x in zip(self.dynamic, tensors):
            self.ptrs[i] = None if x is None else x.data_ptr()
        self.sizes[0], self.sizes[6] = E, n_cg
        for i, v in enumerate(more):
            self.sizes[9 + i] = v
        rc = build.call_on(device, self.fn, *head, self.ptrs, len(self.ptrs),
                           *tail, self.sizes, len(self.sizes))
        build.check(self.lib, rc, self.name)


def core_sizes(tb, E, n_cg):
    """The C interface's sizes: E, nd, Q, Qf, nf, fd, n_cg, D, Q1."""
    return [E] + [tb[k] for k in SIZE_KEYS] + [n_cg, tb["D"], tb["Q1"]]
