"""The advection operator of the partial-assembly remap paths.

The port of `remhos_tpu.operator.Advection` for remap (problems 10-19) with
`-pa` on a structured 2D/3D mesh. Stage functions work on the block state
`S[nfields, E, nd]` (field 0 = u, field 1 = us for product remap) and return
`(dS, aux)` with `aux = [dt_ratio, -violations]`, a 2-element tensor on the
device that is never fetched inside a step.

The reference's own gate picks one of two stages. `-ho 3 [-lo 5] [-fct 2]`
is the "fused stage", whose geometry is polynomial in the pseudo-time and
lives inside the kernels. Two kernels carry it:

- the mega stage (`ops/mega_stage.py`): the whole limited stage in one
  launch, when nothing outside needs du_HO, du_LO or wdet (single field, no
  -vb, no dt control, standard RK). Its aux is the constant [inf, 0], given
  as None so that the steppers skip the combine;
- the HO stage (`ops/stage_ho.py`), once per field, followed by the LO
  solution, the bounds, ClipScale, the product-field limiter and the -vb
  checks in plain PyTorch: -vb, dt control, a product field, IDP-RK.

`ops/wdet.py` supplies w_q det J where `limit_mult` or `lumped_mass` run
before any HO stage kernel has (the driver's mass reports, a stand-alone
`limit_mult`).

Everything else in `-ho 2|3 -lo 0|3|4|5 -fct 0|2` is the non-fused stage,
which re-derives its geometry from the nodes x0 + t v at every stage:
`geometry(t)` makes the face normals and upwind weights in plain PyTorch and
launches the wdet kernel once; per field, `ops/geom_conv.py` fuses the
volume geometry with the convection action (once for the HO solution, once
more for a residual-distribution LO solution), the face terms are plain
PyTorch (`pa.py`), and the mass inverse is a global CG (`pa.mass_solve_gl`
for `-ho 3`, `pa.mass_solve_bern` for `-ho 2`) that reads one comparison
back from the device per iteration; `cg_stats` counts its solves and
iterations.

Any other configuration raises NotImplementedError naming the ROADMAP.md
item that ports it.
"""

from __future__ import annotations

import dataclasses

import torch

from . import assembly as asm
from . import bounds as bnd
from . import fct as fctm
from . import geometry as geo
from . import lo as lom
from . import pa as pam
from . import problems as prob
from . import resolve_device
from . import structured as strm
from . import subcell as subm
from . import sync as syncm
from . import verify as vfy
from .discretization import Discretization
from .ops import tables as tbl
from .ops.geom_conv import geom_conv, geom_conv_tables
from .ops.mega_stage import mega_stage
from .ops.stage_ho import stage_ho
from .ops.wdet import wdet as wdet_kernel
from .ops.wdet import wdet_tables

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver selection, mirroring the reference CLI (remhos.cpp:249-334)."""

    problem: int = 10
    ho: int = 3          # 2 CG, 3 LocalInverse
    lo: int = 5          # 0 none, 3 RD, 4 RD-subcell, 5 MassBasedAvg
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
    """The ROADMAP.md item a configuration needs, or None when one of the
    two remap PA stages runs it."""
    if cfg.exec_mode != 1:
        return "transport mode (Queue 1, item 9)"
    if cfg.ho not in (2, 3) or cfg.lo not in (0, 3, 4, 5) \
            or cfg.fct not in (0, 2) or cfg.mono != 0 or cfg.smth_ind != 0:
        return "solver families other than -ho 2|3 -lo 0|3|4|5 -fct 0|2 " \
               "(Queue 1, item 10)"
    if not cfg.pa:
        return "the assembled (non -pa) path (Queue 1, item 10)"
    if cfg.poly_bf16:
        return "the bf16 P16 stream (Queue 2, item 1)"
    if cfg.bounds_type != 0:
        return "bounds other than the overlap stencil (Queue 2, item 1)"
    if dim not in (2, 3):
        return "1D meshes (Queue 1, item 12)"
    return None


class Advection:
    """Static tables on one device, in one dtype, and the stage functions
    `mult_unlimited`, `limit_mult` and `stage_function`."""

    def __init__(self, disc: Discretization, cfg: SolverConfig, x0_nodes,
                 v_nodes, dtype=torch.float32, device=None):
        why = _unported(cfg, disc.dim)
        if why is not None:
            raise NotImplementedError(
                f"remhos_torch runs the remap PA stages only; {why} is "
                "not ported yet (ROADMAP.md)")
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
        self.w_q, self.Bu = T(disc.w_q), T(disc.Bu)
        self.nbr_dof_local = torch.as_tensor(
            disc.dofmaps.nbr_dof_local, dtype=torch.long, device=self.device)
        self.masks = strm.edge_masks(self.shape, self.device)
        self._wdet_tables = wdet_tables(disc, dtype, self.device)
        self._cls = torch.as_tensor(tbl.class_of_dofs(disc.nd, disc.dim),
                                    dtype=torch.long, device=self.device)
        # the constant halves of aux, made once: no fill launch per stage
        self._inf = torch.full((), INF, dtype=dtype, device=self.device)
        self._no_viol = torch.zeros((), dtype=torch.int32,
                                    device=self.device)
        # solves and iterations of the non-fused stage's global CG (the
        # fused stage solves inside its kernels and leaves them 0)
        self.cg_stats = dict(solves=0, iterations=0)
        # the reference's gate (its `_fused_stage`): the canonical family
        # runs the fused stage kernels, everything else the composition of
        # geom_conv with plain PyTorch
        self._fused_stage = (cfg.ho == 3 and cfg.lo in (0, 5)
                             and cfg.fct in (0, 2))
        if self._fused_stage:
            self._stage_tables = tbl.stage_ho_tables(disc, dtype,
                                                     self.device)
            # remap moves the mesh linearly, so va/wdet/vn are polynomials
            # in t whose coefficients are computed once (the per-stage
            # geometry compute disappears into Horner evaluations inside
            # the kernels)
            self._poly = tbl.build_poly_tables(self.x0_nodes, self.v_nodes,
                                               disc)
        else:
            self._init_nonfused(T)

    def _init_nonfused(self, T):
        """Static tables of the non-fused stage."""
        disc, dev = self.disc, self.device
        self._gc_tables = geom_conv_tables(disc, self.dtype, dev)
        self.Bface, self.w_fq = T(disc.Bface), T(disc.w_fq)
        self.Bgl, self.A_gl2b = T(disc.Bgl), T(disc.A_gl2b)
        self.bdr_dofs = torch.as_tensor(disc.dofmaps.bdr_dofs,
                                        dtype=torch.long, device=dev)
        Gt, sign = geo.face_tangent_tables(disc.Gmf, disc.n_ref)
        self._face_tan = (T(Gt), T(sign))
        # the mesh velocity does not depend on time, so its interpolation to
        # the face points is made once (the reference reassembles it every
        # stage, remhos.cpp:1612-1643)
        nf, Qf, nm = disc.Bmf.shape
        self._v_fq_static = geo.interp_nodes(
            self.v_nodes, T(disc.Bmf.reshape(nf * Qf, nm))).reshape(
                self.v_nodes.shape[0], nf, Qf, -1)
        self._sub2ind = None
        if self.cfg.lo == 4:
            self._sub2ind = torch.as_tensor(disc.dofmaps.sub2ind,
                                            dtype=torch.long, device=dev)
            self._q1_grads = T(subm.q1_center_grads(disc.dim))
            self._subcell_nodes = subm.subcell_node_setup(self)

    def gather_nbr(self, u):
        """u_nbr[E, nf, fd], 0 on physical boundaries."""
        return strm.gather_nbr_structured(u, self.shape, self.periodic,
                                          self.nbr_dof_local, self.masks)

    # ------------------------------------------------------------------
    # geometry at a stage time
    # ------------------------------------------------------------------

    def geometry(self, t):
        """The per-stage cache shared by `mult_unlimited` and `limit_mult`.

        Fused stage: everything stage-dependent happens inside the stage
        kernels (polynomial geometry keyed on t); wdet, detJ and ml are
        filled in as kernel by-products (`_stage_ho_fused`,
        `_ensure_stage_geom`). The nodes xs = x0 + t v, which the reference
        puts here, are formed only where the wdet kernel reads them.

        Non-fused stage (remhos.cpp:1598-1676): the moved nodes, the face
        normals from their tangents, the upwind face weights wvn >= 0, one
        wdet kernel launch with ml and detJ, and for `-lo 4` the subcell
        weights. J, adj J and va stay inside `geom_conv`, per field."""
        if self._fused_stage:
            return dict(t=t)
        xs = self.x0_nodes + t * self.v_nodes
        nor = geo.face_normals_tangent(xs, *self._face_tan)
        vn = torch.einsum("efqd,efqd->efq", self._v_fq_static, nor)
        wvn = -(self.w_fq[None, None, :] * (-vn.clamp(min=0.0)))
        geom = dict(t=t, xs=xs, wvn=wvn)
        self._set_wdet(geom, wdet_kernel(xs, self._wdet_tables))
        if self.cfg.lo == 4:
            geom["sub_w"] = subm.subcell_weights(self, t)
        return geom

    def _stage_ho_fused(self, geom, u, n_cg=None):
        """Run the HO stage kernel for one field; fill geom's wdet/detJ/ml
        on first use (one launch per field, same stage geometry). When the
        stage function marked this geom `fused_lo` (standard RK:
        limit_mult's du_HO is this kernel's unmodified output), the first
        launch also emits the MassBasedAvg LO solution of field 0."""
        u_nbr = self.gather_nbr(u).reshape(u.shape[0], -1)
        with_lo = (bool(geom.get("fused_lo")) and n_cg != 0
                   and "du_LO_fused" not in geom)
        res = stage_ho(geom["t"], u, u_nbr, self._poly, self._stage_tables,
                       n_cg=n_cg, dt=geom.get("dt"), with_lo=with_lo)
        if with_lo:
            geom["du_LO_fused"] = res[2]
        if "wdet" not in geom:
            self._set_wdet(geom, res[1])
        return res[0]

    def _set_wdet(self, geom, wdet):
        geom["wdet"] = wdet
        geom["detJ"] = wdet / self.w_q[None, :]
        geom["ml"] = pam.lumped_mass_pa(wdet, self.Bu)

    def _ensure_stage_geom(self, geom):
        """wdet/detJ/ml normally arrive as by-products of the HO stage
        kernel; if `limit_mult` or `lumped_mass` runs before any has
        (stand-alone), the wdet kernel derives them from the nodes."""
        if "wdet" not in geom:
            xs = self.x0_nodes + geom["t"] * self.v_nodes
            self._set_wdet(geom, wdet_kernel(xs, self._wdet_tables))
        return geom

    def lumped_mass(self, t):
        """ml[E, nd] at pseudotime t (the driver's mass reports)."""
        return self._ensure_stage_geom(self.geometry(t))["ml"]

    # ------------------------------------------------------------------
    # solvers
    # ------------------------------------------------------------------

    def conv_volume(self, geom, u):
        """The volume convection action K u of one field, geometry fused
        (the kernel's own wdet is not used: geom holds the stage's)."""
        return geom_conv(geom["xs"], self.v_nodes, u, self._gc_tables,
                         1.0)[0]

    def ho_solution(self, geom, u):
        """The HO solution du_HO[E, nd] of one field at the stage geometry."""
        if self._fused_stage:
            return self._stage_ho_fused(geom, u)
        u_nbr = self.gather_nbr(u)
        contrib = pam.face_full_apply(asm.gather_face(u, self.bdr_dofs),
                                      u_nbr, self.Bface, geom["wvn"])
        Ku = asm.scatter_face_add(self.conv_volume(geom, u), contrib,
                                  self.bdr_dofs)
        if self.cfg.ho == 3:
            return pam.mass_solve_gl(Ku, geom["wdet"], self.Bgl,
                                     self.A_gl2b, stats=self.cg_stats)
        return pam.mass_solve_bern(Ku, geom["wdet"], self.Bu,
                                   stats=self.cg_stats)

    def lo_solution(self, geom, u, du_HO=None, dt=None):
        """The LO solution du_LO[E, nd] of one field at the stage geometry."""
        cfg = self.cfg
        if cfg.lo == 5:
            if du_HO is not None and "du_LO_fused" in geom:
                # already computed inside the HO stage kernel (valid: the
                # stage function guarantees du_HO is the kernel's
                # unmodified output at the same dt)
                return geom["du_LO_fused"]
            if du_HO is None:
                du_HO = self.ho_solution(geom, u)
            return lom.mass_based_avg(u, du_HO, dt, geom["detJ"], self.w_q,
                                      self.Bu)
        if cfg.lo in (3, 4):
            # residual distribution: the same K u once more (IDP recombines
            # du_HO between the halves, so nothing is kept from the HO
            # solution), the lumped face terms, then the element-local
            # redistribution
            z = self.conv_volume(geom, u)
            contrib = pam.face_lumped_apply(
                asm.gather_face(u, self.bdr_dofs), self.gather_nbr(u),
                self.Bface, geom["wvn"])
            duf = asm.scatter_face_add(torch.zeros_like(u), contrib,
                                       self.bdr_dofs)
            return lom.residual_distribution_core(
                u, z, duf, geom["ml"], subcell=cfg.lo == 4,
                subcell_weights=geom.get("sub_w"),
                sub2ind=self._sub2ind)
        raise ValueError("no LO solver selected")

    def compute_bounds(self, el_min, el_max, active_el=None):
        """Per-dof bounds from the overlap stencil."""
        return strm.overlap_bounds_structured(
            el_min, el_max, self.shape, self.periodic, self.disc.p,
            active_el=active_el, masks=self.masks, cls=self._cls)

    def _dt_ratio(self, u, du, x_min, x_max, dt):
        """LO-bounds dt estimate (remhos.cpp:1968-1998): largest dt keeping
        x_min <= u + dt*du <= x_max, as a ratio to the current dt."""
        eps = 1e-12
        pos, neg = du > eps, du < -eps
        up = torch.where(pos, (x_max - u) / torch.where(pos, du, 1.0), INF)
        dn = torch.where(neg, (x_min - u) / torch.where(neg, du, 1.0), INF)
        return torch.minimum(up.min(), dn.min()) / dt

    # ------------------------------------------------------------------
    # stage functions (over the block state S[nfields, E, nd])
    # ------------------------------------------------------------------

    def mult_unlimited(self, t, dt, S, geom=None):
        """HO (or LO-only) update for all fields
        (AdvectionOperator::MultUnlimited, remhos.cpp:1596-1739)."""
        cfg = self.cfg
        if geom is None:
            geom = self.geometry(t)
        outs = []
        for k in range(S.shape[0]):
            if cfg.fct == 0 and cfg.lo != 0:
                outs.append(self.lo_solution(geom, S[k], dt=dt))
            else:
                outs.append(self.ho_solution(geom, S[k]))
        return torch.stack(outs)

    def _aux(self, ratio, viol):
        """Pack the per-stage side channel: [dt_ratio, -violations].
        Steppers combine stages with elementwise minimum, which takes the
        min ratio AND the max violation count (negated)."""
        return torch.stack([ratio, -viol.to(ratio.dtype)])

    def limit_mult(self, t, dt, S, dS, geom=None):
        """FCT limiting for all fields (AdvectionOperator::LimitMult,
        remhos.cpp:1798-1916). Returns (dS_limited, aux) with
        aux = [dt_ratio, -bounds_violations] (see _aux)."""
        cfg = self.cfg
        ratio, viol = self._inf, self._no_viol
        if cfg.fct == 0:
            if cfg.dt_control != 0 and cfg.lo != 0:
                u = S[0]
                el_min, el_max = bnd.elements_min_max(u)
                x_min, x_max = self.compute_bounds(el_min, el_max)
                ratio = self._dt_ratio(u, dS[0], x_min, x_max, dt)
            return dS, self._aux(ratio, viol)

        if geom is None:
            geom = self.geometry(t)
        self._ensure_stage_geom(geom)
        u, du_HO = S[0], dS[0]
        du_LO = self.lo_solution(geom, u, du_HO=du_HO, dt=dt)
        el_min, el_max = bnd.elements_min_max(u)
        x_min, x_max = self.compute_bounds(el_min, el_max)
        if cfg.verify_bounds:
            # "LimitMult LO u" (remhos.cpp:1824-1828)
            viol = viol + vfy.check_violation(u, dt, du_LO, x_min, x_max)
        du = self._fct_solution(geom, u, du_HO, du_LO, x_min, x_max, dt)
        if cfg.verify_bounds:
            # "LimitMult FCT solution u" (remhos.cpp:1833-1837)
            viol = viol + vfy.check_violation(u, dt, du, x_min, x_max)
        if cfg.dt_control != 0:
            ratio = self._dt_ratio(u, du_LO, x_min, x_max, dt)
        outs = [du]

        if S.shape[0] > 1:
            d_us, viol_p = self._limit_product(geom, t, dt, S, dS, du)
            outs.append(d_us)
            viol = viol + viol_p
        return torch.stack(outs), self._aux(ratio, viol)

    def _fct_solution(self, geom, u, du_HO, du_LO, x_min, x_max, dt):
        if self.cfg.fct != 2:
            raise ValueError(f"unsupported fct type {self.cfg.fct}")
        return fctm.clip_scale(u, geom["ml"], du_HO, du_LO, x_min, x_max, dt)

    def _limit_product(self, geom, t, dt, S, dS, d_u_limited):
        """Product-field block of LimitMult (remhos.cpp:1848-1915).
        Returns (d_us, violation_count). ClipScale needs no LO product
        input (only FluxBasedFCT does)."""
        us, d_us_HO = S[1], dS[1]
        u = S[0]

        # s = us/u on old active dofs; bounds for s on the active stencil
        s, s_el, s_dofs = syncm.compute_ratio(us, u)
        el_min, el_max = bnd.elements_min_max(s, active_el=s_el,
                                              active_dof=s_dofs)
        s_min, s_max = self.compute_bounds(el_min, el_max, active_el=s_el)

        # evolve u, new activity
        u_new = u + dt * d_u_limited
        el_new, dofs_new = syncm.bool_indicators(u_new)

        return self._fct_product(geom, us, d_us_HO, s_min, s_max, u_new,
                                 el_new, dofs_new, dt)

    def _fct_product(self, geom, us, d_us_HO, s_min, s_max, u_new,
                     active_el, active_dofs, dt):
        """CalcFCTProduct of ClipScale (remhos_fct.cpp:543-566). Returns
        (d_us, violations)."""
        cfg = self.cfg
        if cfg.fct != 2:
            raise ValueError(f"unsupported fct product type {cfg.fct}")
        m = geom["ml"]
        dus_lo_fct, s_min, s_max, viol = fctm.calc_compatible_lo_product(
            us, m, d_us_HO, s_min, s_max, u_new, active_el, active_dofs, dt)
        if not cfg.verify_bounds:
            viol = self._no_viol
        us_min, us_max = fctm.scale_product_bounds(s_min, s_max, u_new,
                                                   active_el, active_dofs)
        d_us = fctm.clip_scale(us, m, d_us_HO, dus_lo_fct, us_min, us_max, dt)
        d_us = syncm.zero_out_empty_dofs(active_el, active_dofs, d_us)
        if cfg.verify_bounds:
            # final product bounds check (remhos_fct.cpp:568-610)
            viol = viol + vfy.check_final_us(us, dt, d_us, us_min, us_max,
                                             active_el, active_dofs)
        return d_us, viol

    def compute_mask(self, S):
        """IDP stage mask (AdvectionOperator::ComputeMask,
        remhos.cpp:1741-1796): with a product field, a dof takes part in the
        high-order RK recombination only if EVERY dof of its element is
        active in u; the u mask is applied to all fields. Without a product
        field, everything is active."""
        if S.shape[0] <= 1:
            return torch.ones(S.shape, dtype=torch.bool, device=S.device)
        _, active_dofs = syncm.bool_indicators(S[0])
        el_fully_active = active_dofs.all(dim=1)
        return el_fully_active[None, :, None].expand(S.shape)

    # ------------------------------------------------------------------

    def _mega_stage_eligible(self):
        """The whole -ho 3 -lo 5 -fct 2 standard-RK stage collapses into
        ONE kernel when nothing outside it needs the intermediate
        du_HO/du_LO/wdet (no -vb checks, no dt control, single field)."""
        cfg = self.cfg
        return (self._fused_stage and cfg.lo == 5 and cfg.fct == 2
                and not cfg.verify_bounds and cfg.dt_control == 0)

    def _mega_stage(self, t, dt, S):
        """The limited stage of a single field: bounds and gather (functions
        of u alone) as torch glue, then HO + LO + lumped mass + ClipScale in
        one kernel. aux is None: the constant [inf, 0]."""
        u = S[0]
        el_min, el_max = bnd.elements_min_max(u)
        smin, smax = strm.overlap_stencil_T(el_min, el_max, self.shape,
                                            self.periodic, self.masks)
        u_nbr = self.gather_nbr(u).reshape(u.shape[0], -1)
        du = mega_stage(t, dt, u, u_nbr, smin, smax, self._poly,
                        self._stage_tables)
        return du[None], None

    def stage_function(self):
        """f(t, dt, S) -> (dS, aux) for the standard RK path
        (LimitedTimeDependentOperator::Mult). The stage cache is made once
        and shared by both halves."""
        def f(t, dt, S):
            if S.shape[0] == 1 and self._mega_stage_eligible():
                return self._mega_stage(t, dt, S)
            geom = self.geometry(t)
            if self._fused_stage and self.cfg.lo == 5 and self.cfg.fct == 2:
                # on this path limit_mult's du_HO is mult_unlimited's
                # output unchanged, so the kernel can emit du_LO too
                # (IDP recombines between the calls: no flag there)
                geom["fused_lo"] = True
                geom["dt"] = dt
            dS = self.mult_unlimited(t, dt, S, geom=geom)
            return self.limit_mult(t, dt, S, dS, geom=geom)
        return f
