"""The advection operator, mega-stage subset.

The port of `remhos_tpu.operator.Advection` for the one configuration the
main path runs: remap (problems 10-19), `-ho 3 -lo 5 -fct 2 -pa`, a single
field, no `-vb`, no dt control, overlap bounds on a structured mesh. A stage
is then one call of the mega stage kernel (`ops/mega_stage.py`) after three
pieces of glue that depend on u alone: the element extrema, the class-major
bounds stencil and the face-neighbour gather. Any other configuration raises
NotImplementedError naming the ROADMAP.md item that ports it.

The stage function returns du only. The TPU version also returns an aux
channel [dt ratio, -violations]; on this path it is the constant [inf, 0].
"""

from __future__ import annotations

import dataclasses

import torch

from . import bounds as bnd
from . import geometry as geo
from . import problems as prob
from . import resolve_device
from . import structured as strm
from .discretization import Discretization
from .ops import tables as tbl
from .ops.mega_stage import mega_stage


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver selection, mirroring the reference CLI (remhos.cpp:249-334)."""

    problem: int = 10
    ho: int = 3          # 3 LocalInverse
    lo: int = 5          # 5 MassBasedAvg
    fct: int = 2         # 2 ClipScale
    mono: int = 0
    ode_solver: int = 3
    bounds_type: int = 0
    dt_control: int = 0
    product_sync: bool = False
    smth_ind: int = 0
    pa: bool = True
    poly_bf16: bool = False
    verify_bounds: bool = False
    use_masks: bool = False

    @property
    def exec_mode(self) -> int:
        return prob.exec_mode_of(self.problem)


def _unported(cfg: SolverConfig, dim: int):
    """The ROADMAP.md item a configuration needs, or None on the mega path."""
    if cfg.exec_mode != 1:
        return "transport mode (Queue 1, item 9)"
    if (cfg.ho, cfg.lo, cfg.fct, cfg.mono, cfg.smth_ind) != (3, 5, 2, 0, 0) \
            or not cfg.pa:
        return "solver families other than -ho 3 -lo 5 -fct 2 -pa " \
               "(Queue 1, item 10)"
    if cfg.verify_bounds or cfg.dt_control or cfg.product_sync \
            or cfg.use_masks or cfg.ode_solver not in (1, 2, 3, 4):
        return "the non-mega stage: -vb, dt control, product remap, " \
               "IDP and tableau steppers (Queue 1, item 9)"
    if cfg.poly_bf16:
        return "the bf16 P16 stream (Queue 2, item 1)"
    if cfg.bounds_type != 0:
        return "bounds layouts other than the overlap stencil " \
               "(Queue 2, item 1)"
    if dim not in (2, 3):
        return "1D meshes (Queue 1, item 12)"
    return None


class Advection:
    """Static tables on one device, in one dtype, and the stage function."""

    def __init__(self, disc: Discretization, cfg: SolverConfig, x0_nodes,
                 v_nodes, dtype=torch.float32, device=None):
        why = _unported(cfg, disc.dim)
        if why is not None:
            raise NotImplementedError(
                f"remhos_torch runs the mega stage only; {why} is not ported "
                "yet (ROADMAP.md)")
        self.disc = disc
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        mesh = disc.mesh
        self.shape, self.periodic = mesh.shape, mesh.periodic

        def T(a):
            return torch.as_tensor(a).to(device=self.device, dtype=dtype)

        self.x0_nodes = T(x0_nodes)
        self.v_nodes = T(v_nodes)
        self.Gm, self.w_q, self.Bu = T(disc.Gm), T(disc.w_q), T(disc.Bu)
        self.nbr_dof_local = torch.as_tensor(
            disc.dofmaps.nbr_dof_local, dtype=torch.long, device=self.device)
        self.masks = strm.edge_masks(self.shape, self.device)
        self._stage_tables = tbl.stage_ho_tables(disc, dtype, self.device)
        # remap moves the mesh linearly, so va/wdet/vn are polynomials in t
        # whose coefficients are computed once (the per-stage geometry
        # compute disappears into Horner evaluations inside the kernel)
        self._poly = tbl.build_poly_tables(self.x0_nodes, self.v_nodes, disc)

    def gather_nbr(self, u):
        """u_nbr[E, nf, fd], 0 on physical boundaries."""
        return strm.gather_nbr_structured(u, self.shape, self.periodic,
                                          self.nbr_dof_local, self.masks)

    def lumped_mass(self, t):
        """ml[E, nd] at pseudotime t from the mesh geometry at x0 + t v."""
        x = self.x0_nodes + t * self.v_nodes
        wdet = self.w_q[None, :] * geo.volume_detj(x, self.Gm)
        return wdet @ self.Bu

    def _mega_stage(self, t, dt, u):
        """The limited stage: bounds and gather (functions of u alone) as
        torch glue, then HO + LO + lumped mass + ClipScale in one kernel."""
        el_min, el_max = bnd.elements_min_max(u)
        smin, smax = strm.overlap_stencil_T(el_min, el_max, self.shape,
                                            self.periodic, self.masks)
        u_nbr = self.gather_nbr(u).reshape(u.shape[0], -1)
        return mega_stage(t, dt, u, u_nbr, smin, smax, self._poly,
                          self._stage_tables)

    def stage_function(self):
        """f(t, dt, u) -> du for the standard RK path
        (LimitedTimeDependentOperator::Mult)."""
        return self._mega_stage
