"""The limited remap stage in one kernel: wrapper, launch count and plain
PyTorch version.

`mega_stage` is the port of `fused_stage_mega_poly`
(remhos_tpu/ops/pallas_kernels.py:889): the whole -ho 3 -lo 5 -fct 2 stage
(polynomial stage geometry, HO solve, DG upwind face flux, Jacobi GL mass
inverse, MassBasedAvg LO, lumped mass, ClipScale) with only the limited du
written to memory. The kernel is `csrc/mega_stage.cu` (CUDA C++, sm_90a),
built by nvcc at first use and called through ctypes.

Three bounds layouts, one C entry each (`bounds=`):

- "T": the class-major overlap stencil smin/smax[3^dim, E] of `-bt 0` on an
  unsharded structured mesh (the JAX kernel's bounds_stencil="T"), expanded
  to dofs through the dof classes `cls` of the tables;
- "E": the element-major stencil smin/smax[E, 3^dim] of a shard of a
  sharded structured mesh (`parallel/sharded.py`'s compute_bounds_stencil;
  the JAX kernel's bounds_stencil=True), staged into the same shared slots
  as "T": on the same stencil values "E" equals "T" bit for bit;
- "dof": per-dof bounds smin/smax[E, nd] (`-bt 1`: `bounds.sparsity_bounds`,
  and a general mesh; the JAX kernel's bounds_stencil=False), contiguous on
  the card.

With `P16` (float32 only; the JAX package's poly_bf16): P holds w_q det J
alone and P16 the bf16 va and vn coefficients (`tables.poly16_layout`); the
kernel converts each to f32 before any arithmetic.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `mega_stage_reference`, the plain PyTorch version of
the same function built from `lo.mass_based_avg` and `fct.clip_scale`.
`mega_stage.launches` counts the launches of every variant (the trace names
them alike); `mega_stage.variant_launches` counts each layout's ("T", "E",
"dof": they sum to `launches`) and "P16", the launches that read the bf16
stream (of any layout).
"""

from __future__ import annotations

import torch

from .. import fct, lo
from . import stage_core as core
from .stage_core import default_sweeps  # noqa: F401  (part of this API)

# pointer order of Args in csrc/mega_stage.cu: the core's, then these
OPERANDS = core.CORE_OPERANDS + ("smin", "smax", "cls", "du", "P16")
STATIC = ("sf", "bdr", "dof_faces", "cls")
NAMES = ("u", "u_nbr", "P", "smin", "smax")       # the per-call operands
# the C entry of each bounds layout
ENTRIES = {"T": "remhos_mega_stage", "E": "remhos_mega_stage_elem",
           "dof": "remhos_mega_stage_dof"}


def expand_bounds(smin, smax, tables, bounds):
    """Per-dof bounds [E, nd] of a bounds layout: the stencils expanded
    through the dof classes (min and max only, so exact)."""
    if bounds == "dof":
        return smin, smax
    cls = tables["cls"].long()
    if bounds == "T":
        return smin[cls].T, smax[cls].T
    return smin[:, cls], smax[:, cls]


def mega_stage_reference(t, dt, u, u_nbr, smin, smax, P, tables, n_cg,
                         bounds="T", P16=None):
    """Plain PyTorch version of the kernel, on any device.

    t, dt: stage time and limiter dt (rounded to u's dtype, as the kernel
    takes them); u[E, nd]; u_nbr[E, nf*fd]; smin/smax: the class-major
    stencil [3^dim, E] (bounds "T"), the element-major stencil [E, 3^dim]
    ("E") or per-dof bounds [E, nd] ("dof"); P[E, width] (tables.poly_layout,
    or with P16 tables.poly16_layout); tables from tables.stage_ho_tables.
    Every layout ends in the same ClipScale: the stencils' expansions fed as
    per-dof bounds give the "T" and "E" results bit for bit."""
    tb = tables
    t, dt = core.as_dtype(t, u.dtype), core.as_dtype(dt, u.dtype)
    du_ho, wdet = core.poly_stage_core_reference(t, u, u_nbr, P, tb, n_cg,
                                                 P16)
    w_q = tb["w_q"]
    du_lo = lo.mass_based_avg(u, du_ho, dt, wdet / w_q, w_q, tb["Bu"])
    ml = wdet @ tb["Bu"]
    smin, smax = expand_bounds(smin, smax, tb, bounds)
    return fct.clip_scale(u, ml, du_ho, du_lo, smin, smax, dt)


def _check(u, u_nbr, smin, smax, P, tables, bounds, P16):
    """Raise on a bounds layout, dtype, shape or device the kernel does not
    take (the static tables are checked once, where they are built). On the
    card every operand must be contiguous: per-dof bounds broadcast from
    one value per element (an expanded view, stride 0) are refused."""
    if bounds not in ENTRIES:
        raise ValueError(f"mega_stage: bounds must be one of "
                         f"{sorted(ENTRIES)}, got {bounds!r}")
    E, p16 = u.shape[0], P16 is not None
    key = ("mega_shapes", bounds, E, p16)
    shapes = tables.get(key)
    if shapes is None:
        b = {"T": (3 ** tables["dim"], E), "E": (E, 3 ** tables["dim"]),
             "dof": (E, tables["nd"])}[bounds]
        shapes = tables[key] = core.operand_shapes(tables, E, p16) + (b, b)
    core.check_operands("mega_stage", NAMES, (u, u_nbr, P, smin, smax),
                        shapes, tables)
    if p16:
        core.check_p16("mega_stage", P16, u, tables)


def mega_stage(t, dt, u, u_nbr, smin, smax, P, tables, bounds="T",
               P16=None):
    """du_limited[E, nd] for one stage, with default_sweeps(u.dtype) Jacobi
    sweeps; bounds "T", "E" or "dof" (the layout of smin/smax); P16 the
    bf16 va/vn stream or None; see the module docstring."""
    _check(u, u_nbr, smin, smax, P, tables, bounds, P16)
    n_cg = default_sweeps(u.dtype)
    if u.device.type == "cpu":
        return mega_stage_reference(t, dt, u, u_nbr, smin, smax, P, tables,
                                    n_cg, bounds, P16)
    du = torch.empty_like(u)
    E = u.shape[0]
    lau = core.Launcher.get("mega_stage", ENTRIES[bounds],
                            core.LAUNCH_ARGTYPES, tables, OPERANDS, STATIC,
                            core.core_sizes(tables, E, n_cg))
    lau(u.device, (u.element_size(), tables["dim"]),
        (u, u_nbr, P, smin, smax, du, P16), (float(t), float(dt)), E, n_cg)
    mega_stage.launches += 1
    mega_stage.variant_launches[bounds] += 1
    if P16 is not None:
        mega_stage.variant_launches["P16"] += 1
    return du


mega_stage.launches = 0
mega_stage.variant_launches = dict.fromkeys(tuple(ENTRIES) + ("P16",), 0)
