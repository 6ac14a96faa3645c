"""The advection operator: stage geometry and the HO/LO/FCT dispatch.

The port of `remhos_tpu.operator.Advection` for remap (problems 10-17) and
transport (problems 0-7) on a structured 1D/2D/3D mesh or a general quad or
hex mesh (`umesh.py`, `umesh3d.py`), with and without `-pa`.
Stage functions work on the block state `S[nfields, E, nd]` (field 0 = u,
field 1 = us for product remap) and return `(dS, aux)` with `aux =
[dt_ratio, -violations]`, a 2-element tensor on the device that is never
fetched inside a step.

Partial assembly (`-pa`). The reference's own gate picks one of two stages.
`-ho 3 [-lo 5] [-fct 2]` in remap is the "fused stage", whose geometry is
polynomial in the pseudo-time and lives inside the kernels. Two kernels
carry it:

- the mega stage (`ops/mega_stage.py`): the whole limited stage in one
  launch, when nothing outside needs du_HO, du_LO or wdet (single field, no
  -vb, no dt control, standard RK). Its bounds are the class-major overlap
  stencil at `-bt 0` and per-dof sparsity bounds at `-bt 1` (the kernel's
  two variants; remhos_tpu/operator.py:713-737). Its aux is the constant
  [inf, 0], given as None so that the steppers skip the combine;
- the HO stage (`ops/stage_ho.py`), once per field, followed by the LO
  solution, the bounds, ClipScale, the product-field limiter and the -vb
  checks in plain PyTorch: -vb, dt control, a product field, IDP-RK.

`ops/wdet.py` supplies w_q det J where `limit_mult` or `lumped_mass` run
before any HO stage kernel has (the driver's mass reports, a stand-alone
`limit_mult`).

Every other `-pa` configuration is the non-fused stage, which re-derives
its geometry from the nodes x0 + t v at every stage: `geometry(t)`
launches the wdet kernel's face variant once, for w_q det J and the upwind
face weights (in 1D both are plain PyTorch); per field, `ops/geom_conv.py`
fuses the volume geometry with the convection action (once for the HO
solution, once more for a residual-distribution LO solution), the face
terms are plain PyTorch (`pa.py`), and the mass inverse is a global CG
(`pa.mass_solve_gl` for `-ho 3`, `pa.mass_solve_bern` for `-ho 2`) that
reads one comparison back from the device per iteration; `cg_stats` counts
its solves and iterations. Transport runs the non-fused stage on a
geometry made once, at construction (the mesh stands still), with
`pa.conv_action` on va = -(adj J v) and no kernel, as the JAX package
routes it (operator.py:291-293, 331-336).

Full assembly (no `-pa`, remhos_tpu/operator.py:270-319). Per stage the
element data are assembled as dense batches: det J, K_elem, bdrInt, M and
ml at the moved nodes, in remap on the card (mesh order 2, p = 2..4) by one
launch of `ops/fa_assemble`, elsewhere by its plain chain (`assembly.py`
on the volume and face geometry); the Cholesky factors of M for `-ho 3`
and every FCT; D for `-lo 1|2`; the subcell weights for `-lo 4`.
Transport assembles them once. The solvers are `ho.py` (`-ho 1|2|3`),
`lo.py` (`-lo 1|2|3|4|5`), `fct.py` (`-fct 2|4`), `fct_flux.py` (`-fct
1`), `fct_penalty.py` (`-fct 3`, with `-si` its sharpened bounds) and the
monolithic `mono.py` (`-mono 1|2`, which replaces the HO solution and
reads M, K_elem and bdrInt): batched dense products and factorizations in
plain PyTorch, as the JAX package runs them through XLA with no Pallas
kernel, but for `-fct 1` on the card at p = 2..4 in 2D and 3D: one launch
of `ops/fa_fct` a stage. No product runs in TF32. The smoothness indicator
(`si.py`, `-si 1|2`) is built once from the initial mesh.

1D meshes never reach the stage kernels, as in the JAX package: the driver
runs them assembled (the reference disables PA in 1D), and a 1D remap
operator built with `-pa` takes `geometry.volume_detj_va` and
`pa.conv_action` in plain PyTorch. Their face normals come from the face
Jacobians (`geometry.face_geometry`: a point face has no tangent).

The inflow values enter the LO solutions' (and the Neumann HO solution's)
neighbour gather on physical boundaries (`inflow_face`,
remhos_tools.cpp:891).

General meshes (remhos_tpu/operator.py:133-141, 371-380, 713-737): each
element has its own frame, so the neighbour gather reads per-element tables
(`assembly.gather_nbr_face`) and the `-bt 0` bounds are the CG-node overlap
(`bounds.overlap_bounds`); on the mega stage they reach kernel 1 through
its per-dof variant, as `-bt 1` does. The stage kernels themselves take the
same inputs as on a grid: each element's nodes in its own lexicographic
frame and the neighbour values at its own face dofs.

A configuration the JAX package rejects raises ValueError as it does
(`solver_rejected`).
"""

from __future__ import annotations

import dataclasses

import torch

from . import assembly as asm
from . import bounds as bnd
from . import dofmaps as dmm
from . import fct as fctm
from . import fct_flux
from . import fct_penalty
from . import geometry as geo
from . import ho as hom
from . import lo as lom
from . import mono as monom
from . import pa as pam
from . import problems as prob
from . import resolve_device
from . import structured as strm
from . import subcell as subm
from . import sync as syncm
from . import verify as vfy
from .discretization import Discretization
from .si import SmoothnessIndicator
from .ops import fa_assemble as fam
from .ops import fa_fct as ffm
from .ops import mono_rd as mrm
from .ops import tables as tbl
from .ops.geom_conv import geom_conv, geom_conv_tables
from .ops.mega_stage import mega_stage
from .ops.stage_ho import stage_ho
from .ops.wdet import wdet as wdet_kernel
from .ops.wdet import wdet_tables
from .utils.trace import span, spanned

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver selection, mirroring the reference CLI (remhos.cpp:249-334)."""

    problem: int = 10
    ho: int = 3          # 0 none, 1 Neumann, 2 CG, 3 LocalInverse
    lo: int = 5          # 0 none, 1 DU, 2 DU-prec, 3 RD, 4 RD-subcell,
    #                      5 MassBasedAvg
    fct: int = 2         # 0 none, 1 FluxBased, 2 ClipScale,
    #                      3 NonlinearPenalty, 4 ElementFCTProjection
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


def solver_rejected(cfg: SolverConfig):
    """The message of a solver combination the JAX package rejects, or
    None. The JAX package raises these at its first stage: ValueError for
    the discrete upwind with -pa (its own message), a missing HO or LO
    solver and an unknown FCT type, and KeyError for the assembled-only
    solvers with -pa (its PA stage has no K_elem or M); the port raises
    ValueError at construction."""
    if cfg.fct not in (0, 1, 2, 3, 4):
        return f"unsupported fct type {cfg.fct}"
    if cfg.pa and cfg.lo in (1, 2):
        return "discrete upwind has no PA path (matches the reference)"
    if cfg.pa and cfg.mono != 0:
        return ("the monolithic solver has no PA path: it reads the "
                "assembled M, K_elem and bdrInt (the JAX package fails with "
                "a KeyError)")
    if cfg.mono == 0 and cfg.ho not in (1, 2, 3) and (
            cfg.fct != 0 or cfg.lo in (0, 5)):
        return "no HO solver selected"
    if cfg.fct != 0 and cfg.lo not in (1, 2, 3, 4, 5):
        return "no LO solver selected"
    if cfg.pa and (cfg.ho == 1 or cfg.fct in (1, 4)):
        return ("the Neumann HO solver and the flux-based and element-"
                "projection FCT have no PA path: they read the assembled "
                "K_elem and M (the JAX package fails with a KeyError)")
    return None


class Advection:
    """Static tables on one device, in one dtype, and the stage functions
    `mult_unlimited`, `limit_mult` and `stage_function`.

    The operator of one shard of a sharded run (`parallel/sharded.py`,
    `parallel/gsharded.py`) is a subclass: it overrides the neighbour
    gather, the bounds and the global reductions `all_min` / `all_sum_fn`,
    and pre-sets the GLOBAL bounding box `bb_min` / `bb_max` (and, for
    `-lo 4`, the subcell boundary mask `_sub_bmask`) before this
    constructor runs."""

    sharded = False
    _poly16 = None       # the fused stage's bf16 va/vn stream (poly_bf16)

    def __init__(self, disc: Discretization, cfg: SolverConfig, x0_nodes,
                 v_nodes=None, dtype=torch.float32, device=None, inflow=None):
        """v_nodes: the remap mesh velocity (None in transport mode);
        inflow[E, nd]: the inflow values of the transport problems 6 and 7
        (None elsewhere)."""
        why = solver_rejected(cfg)
        if why is not None:
            raise ValueError(why)
        self.disc = disc
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        if not hasattr(self, "bb_min"):
            # the velocity fields scale with the box: a shard keeps the
            # global one (pre-set by the sharded subclasses)
            self.bb_min, self.bb_max = disc.mesh.bb_min, disc.mesh.bb_max
        if self.device.type == "cuda" and (
                torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError(
                "remhos_torch: TF32 matmuls are on; every product of the "
                "port runs in true float32 (remhos_torch/__init__.py)")
        mesh = disc.mesh

        def T(a):
            return torch.as_tensor(a).to(device=self.device, dtype=dtype)

        def L(a):
            return torch.as_tensor(a, dtype=torch.long, device=self.device)

        # a structured grid gathers its neighbours by shifts along the
        # element axes, a general mesh through its per-element tables
        self.structured = getattr(mesh, "structured", True)
        if self.structured:
            self.shape, self.periodic = mesh.shape, mesh.periodic
            self.masks = strm.edge_masks(self.shape, self.device)
        else:
            self.nbr_elem = L(disc.dofmaps.nbr_elem)

        self.x0_nodes = T(x0_nodes)
        self.v_nodes = None if v_nodes is None else T(v_nodes)
        self.w_q, self.Bu = T(disc.w_q), T(disc.Bu)
        self.nbr_dof_local = L(disc.dofmaps.nbr_dof_local)
        self._cls = torch.as_tensor(tbl.class_of_dofs(disc.nd, disc.dim),
                                    dtype=torch.long, device=self.device)
        # the constant halves of aux, made once: no fill launch per stage
        self._inf = torch.full((), INF, dtype=dtype, device=self.device)
        self._no_viol = torch.zeros((), dtype=torch.int32,
                                    device=self.device)
        # solves and iterations of the non-fused stages' CGs (the fused
        # stage solves inside its kernels and leaves them 0)
        self.cg_stats = dict(solves=0, iterations=0)
        # the bounds stencils' mesh tables, where compute_bounds reads them
        self._bounds_topo = self._bounds_topology()
        # the smoothness indicator's tables and the monolithic solver's
        # velocity scale, made once from the initial mesh
        self.smth = (None if not cfg.smth_ind else SmoothnessIndicator(
            cfg.smth_ind, disc, dtype, self.device))
        # the inner loop's scale; problems 6 and 7 run no inner loop
        self.mono_scale = (None if cfg.mono == 0 or cfg.problem in (6, 7)
                           else T(monom.velocity_scale(mesh, disc,
                                                       cfg.problem)))
        # the monolithic solver's explicit passes, and its inner loops:
        # solves, iterations (their sum and the most in one solve) and
        # read-backs of the exit test
        self.mono_stats = dict(explicit=0, solves=0, iterations=0,
                               max_iterations=0, readbacks=0)
        # the tangent-only face-normal tables; None in 1D, where the
        # normals come from the full face Jacobians (`geometry.face_geometry`)
        ft = geo.face_tangent_tables(disc.Gmf, disc.n_ref)
        self._face_tan = None if ft is None else (T(ft[0]), T(ft[1]))
        # the reference's gate (its `_fused_stage`): the canonical remap
        # family on a 2D or 3D mesh runs the fused stage kernels, everything
        # else the composition of geom_conv (or, in transport and in 1D,
        # conv_action) with plain PyTorch; -mono and -si never reach them
        self._fused_stage = (cfg.pa and cfg.exec_mode == 1 and cfg.ho == 3
                             and cfg.lo in (0, 5) and cfg.fct in (0, 2)
                             and cfg.mono == 0 and cfg.smth_ind == 0
                             and self._face_tan is not None
                             and disc.dim in (2, 3))
        # the wdet kernel is compiled for 2D and 3D; 1D takes the plain
        # route. The non-fused remap stage with -pa runs its face variant,
        # which also forms the upwind face weights wvn from the nodes
        face = (not self._fused_stage and cfg.pa and cfg.exec_mode == 1
                and self._face_tan is not None)
        self._wdet_tables = (wdet_tables(disc, dtype, self.device, face)
                             if disc.dim > 1 else None)
        if self._fused_stage:
            self._stage_tables = tbl.stage_ho_tables(disc, dtype,
                                                     self.device)
            # remap moves the mesh linearly, so va/wdet/vn are polynomials
            # in t whose coefficients are computed once (the per-stage
            # geometry compute disappears into Horner evaluations inside
            # the kernels). poly_bf16 (f32 only; ignored in f64, as
            # remhos_tpu/operator.py:172 does): va and vn in a bf16 P16,
            # w_q det J alone in P
            if cfg.poly_bf16 and dtype == torch.float32:
                self._poly, self._poly16 = tbl.build_poly_tables(
                    self.x0_nodes, self.v_nodes, disc, va_vn_bf16=True)
            else:
                self._poly = tbl.build_poly_tables(self.x0_nodes,
                                                   self.v_nodes, disc)
        else:
            self._init_nonfused(T, inflow)

    def _bounds_topology(self):
        """The bounds stencils' mesh tables (`dofmaps.bounds_topology`),
        where `compute_bounds` reads them; None on a grid at -bt 0."""
        if self.cfg.bounds_type == 0 and self.structured:
            return None
        return dmm.bounds_topology(self.disc.mesh, self.disc.p, self.device,
                                   self.disc.dofmaps)

    def _init_nonfused(self, T, inflow):
        """Static tables of the non-fused and assembled stages; in transport
        mode also their whole geometry."""
        disc, dev = self.disc, self.device
        self.Bface, self.w_fq = T(disc.Bface), T(disc.w_fq)
        self.bdr_dofs = torch.as_tensor(disc.dofmaps.bdr_dofs,
                                        dtype=torch.long, device=dev)
        if self._face_tan is None:
            self.Bmf, self.Gmf = T(disc.Bmf), T(disc.Gmf)
            self.n_ref = T(disc.n_ref)
        # inflow values at each element's own face dofs: the neighbour value
        # on physical boundaries in the LO solutions (remhos_tools.cpp:891)
        self.inflow_face = (None if inflow is None else
                            asm.gather_face(T(inflow), self.bdr_dofs))
        self._sub2ind = None
        if self.cfg.lo == 4 or self.cfg.mono == 2:
            self._sub2ind = torch.as_tensor(disc.dofmaps.sub2ind,
                                            dtype=torch.long, device=dev)
            self._q1_grads = T(subm.q1_center_grads(disc.dim))
            self._subcell_nodes = subm.subcell_node_setup(self)
        if not self.cfg.pa:
            self._init_assembled()
            return
        self.Bgl, self.A_gl2b = T(disc.Bgl), T(disc.A_gl2b)
        if self.cfg.exec_mode == 0:
            self.Gu = T(disc.Gu)
            self.Bu_w = self.Bu * self.w_q[:, None]
            self._transport_geom = self._transport_geometry(T)
            return
        if not self._face_wvn:
            self._v_fq_static = geo.face_velocity(self.v_nodes, T(disc.Bmf))
        if disc.dim == 1:
            # kernels 3 and 4 are compiled for 2D and 3D: in 1D the stage
            # geometry is volume_detj_va's and the convection action
            # conv_action's, in plain PyTorch (remhos_tpu/operator.py:
            # 242-268)
            self.Gu, self.Gm = T(disc.Gu), T(disc.Gm)
            self.Bu_w = self.Bu * self.w_q[:, None]
            self._v_q_static = geo.interp_nodes(self.v_nodes, T(disc.Bm))
            return
        self._gc_tables = geom_conv_tables(disc, self.dtype, dev)

    def _face_normals(self, x):
        """The scaled outward face normals [E, nf, Qf, dim] at the nodes x:
        from the tangents, or in 1D from the full face Jacobians."""
        if self._face_tan is not None:
            return geo.face_normals_tangent(x, *self._face_tan)
        return geo.face_geometry(x, self.Bmf, self.Gmf, self.n_ref)[1]

    def _face_points_normals(self, x, Bmf):
        """(x_fq, nor) at the nodes x, as `_face_normals` routes them."""
        if self._face_tan is not None:
            return geo.face_geometry_tangent(x, Bmf, *self._face_tan)
        return geo.face_geometry(x, Bmf, self.Gmf, self.n_ref)

    def _velocity(self, pts):
        """A transport problem's velocity at points of the working dtype,
        evaluated in f64 and cast back, as the JAX package does."""
        return prob.velocity_function(self.cfg.problem, pts.double(),
                                      self.bb_min, self.bb_max).to(self.dtype)

    def _init_assembled(self):
        """Static tables of the assembled stage (`ops/fa_assemble`'s: the
        volume and face bases and, where the kernel engages, its 1D tables;
        `ops/fa_fct`'s face pairs; with -mono `ops/mono_rd`'s face slots)
        and, in remap on the plain chain, the mesh velocity at the volume
        and face points; in transport the whole stage geometry, assembled
        once."""
        self._fa_tables = fam.fa_assemble_tables(
            self.disc, self.dtype, self.device, self.cfg.exec_mode)
        self.fa_fct_tables = ffm.fa_fct_tables(self.bdr_dofs, self.disc.nd,
                                               self.device)
        self.mono_rd_tables = (None if self.cfg.mono == 0 else
                               mrm.mono_rd_tables(self.bdr_dofs, self.disc.nd,
                                                  self.device))
        if self.cfg.exec_mode == 0:
            self._assembled_geom = self._assemble(0.0)
        elif not self._fa_tables["engaged"]:
            tb = self._fa_tables
            self._v_q_static = geo.interp_nodes(self.v_nodes, tb["Bm"])
            self._v_fq_static = geo.face_velocity(self.v_nodes, tb["Bmf"])

    def _transport_geometry(self, T):
        """The transport stage's geometry (remhos_tpu/operator.py:270-302),
        made once: the mesh does not move. The velocity is evaluated in f64
        at the working dtype's points and cast back, as the JAX package
        does. v.n and adj J v are elementwise products summed over the last
        axis."""
        disc, cfg = self.disc, self.cfg
        x = self.x0_nodes
        vol = geo.volume_geometry(x, T(disc.Bm), T(disc.Gm))
        x_fq, nor = self._face_points_normals(x, T(disc.Bmf))
        v_q, v_fq = self._velocity(vol["x_q"]), self._velocity(x_fq)
        wdet = self.w_q[None, :] * vol["detJ"]
        va = -(v_q[:, :, None, :] * vol["adjJ"]).sum(-1)
        vn = (v_fq * nor).sum(-1)
        wvn = -(self.w_fq[None, None, :] * vn.clamp(max=0.0))
        geom = dict(detJ=vol["detJ"], wdet=wdet, va=va, wvn=wvn,
                    ml=pam.lumped_mass_pa(wdet, self.Bu))
        if cfg.lo == 4:
            geom["sub_w"] = subm.subcell_weights(self, 0.0)
        return geom

    @spanned("remhos.gather")
    def gather_nbr(self, u, bdr_value=None):
        """u_nbr[E, nf, fd]; bdr_value[E, nf, fd] or 0 on physical
        boundaries."""
        if not self.structured:
            return asm.gather_nbr_face(u, self.nbr_elem, self.nbr_dof_local,
                                       bdr_value)
        return strm.gather_nbr_structured(u, self.shape, self.periodic,
                                          self.nbr_dof_local, self.masks,
                                          bdr_value)

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

        Non-fused stage (remhos.cpp:1598-1676): the moved nodes, one launch
        of the wdet kernel's face variant for wdet and the upwind face
        weights wvn >= 0 (formed from the nodes and the nodal mesh velocity:
        no tangents, normals or face velocities reach memory), ml and detJ,
        and for `-lo 4` the subcell weights. J, adj J and va stay inside
        `geom_conv`, per field.

        Transport: the one static geometry made at construction.

        1D remap with -pa: det J and va = adj J v by `volume_detj_va`, the
        normals from the face Jacobians, in plain PyTorch (no kernel).

        Assembled stage: `_assemble(t)` (in transport made once)."""
        if self._fused_stage:
            return dict(t=t)
        with span("remhos.geometry"):
            return self._stage_geometry(t)

    def _stage_geometry(self, t):
        """`geometry` where it is not the fused stage's."""
        if not self.cfg.pa:
            if self.cfg.exec_mode == 0:
                return self._assembled_geom
            return self._assemble(t)
        if self.cfg.exec_mode == 0:
            return self._transport_geom
        xs = self.x0_nodes + t * self.v_nodes
        geom = dict(t=t, xs=xs)
        if self._face_wvn:
            wdet, geom["wvn"] = wdet_kernel(xs, self._wdet_tables,
                                            self.v_nodes)
        else:
            # 1D, or reference normals that are not axis-aligned: the
            # normals from the face Jacobians, v at the face points made once
            vn = (self._v_fq_static * self._face_normals(xs)).sum(-1)
            geom["wvn"] = self.w_fq * vn.clamp(min=0.0)
            if self._wdet_tables is None:
                detJ, geom["va"] = geo.volume_detj_va(xs, self.Gm,
                                                      self._v_q_static, 1.0)
                wdet = self.w_q[None, :] * detJ
            else:
                wdet = wdet_kernel(xs, self._wdet_tables)
        self._set_wdet(geom, wdet)
        if self.cfg.lo == 4:
            geom["sub_w"] = subm.subcell_weights(self, t)
        return geom

    def _assemble(self, t):
        """The assembled stage geometry at time t (remhos.cpp:1598-1676;
        remhos_tpu/operator.py:270-319): detJ, K_elem, bdrInt, M, ml (span
        `remhos.assemble`: one launch of `ops/fa_assemble` where it engages,
        in remap on the card at mesh order 2, else its plain chain);
        chol_L for -ho 3 (`remhos.factor`); D for -lo
        1|2 (`remhos.upwind`); sub_w for -lo 4 and -mono 2. M is made for
        every configuration (the monolithic solver reads it). The JAX
        package also factors M for every FCT and -mono, where nothing reads
        the factors: the port does not, and so runs the rows whose mesh
        tangles late in the pseudo-time (readme-run11-cube3d: M is
        indefinite there, which `torch.linalg.cholesky` refuses and XLA's
        Cholesky turns into NaN factors that nothing reads)."""
        cfg = self.cfg
        with span("remhos.assemble"):
            tb = self._fa_tables
            if cfg.exec_mode == 0:
                mats = fam.fa_assemble_reference(self.x0_nodes, tb, 0,
                                                 velocity=self._velocity)
            elif tb["engaged"]:
                mats = fam.fa_assemble(self.x0_nodes + t * self.v_nodes,
                                       self.v_nodes, tb)
            else:
                mats = fam.fa_assemble_reference(
                    self.x0_nodes + t * self.v_nodes, tb, 1,
                    self._v_q_static, self._v_fq_static)
            detJ, M, ml, K_elem, bdrInt = mats
            geom = dict(detJ=detJ, K_elem=K_elem, bdrInt=bdrInt, M=M, ml=ml)
        if cfg.ho == 3:
            with span("remhos.factor"):
                geom["chol_L"] = hom.mass_cholesky(M)
        if cfg.lo in (1, 2):
            with span("remhos.upwind"):
                K = (K_elem if cfg.lo == 1
                     else lom.precond_convection_matrix(K_elem, M))
                geom["D"] = lom.discrete_upwind_matrix(K)
        if cfg.lo == 4 or cfg.mono == 2:
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
                       n_cg=n_cg, dt=geom.get("dt"), with_lo=with_lo,
                       P16=self._poly16)
        if with_lo:
            geom["du_LO_fused"] = res[2]
        if "wdet" not in geom:
            self._set_wdet(geom, res[1])
        return res[0]

    @property
    def _face_wvn(self):
        """Whether the non-fused stage takes wvn from the wdet kernel's face
        variant (its tables were made for it)."""
        return self._wdet_tables is not None and "fdesc" in self._wdet_tables

    def _set_wdet(self, geom, wdet):
        geom["wdet"] = wdet
        geom["detJ"] = wdet / self.w_q[None, :]
        geom["ml"] = pam.lumped_mass_pa(wdet, self.Bu)

    def _ensure_stage_geom(self, geom):
        """wdet/detJ/ml normally arrive as by-products of the HO stage
        kernel; if `limit_mult` or `lumped_mass` runs before any has
        (stand-alone), the wdet kernel derives them from the nodes."""
        if self._fused_stage and "wdet" not in geom:
            with span("remhos.geometry"):
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
        """The volume convection action K u of one field: in transport from
        the static va, in remap with the geometry fused (geom holds the
        stage's wdet, so the kernel forms none)."""
        if "va" in geom:
            return pam.conv_action(u, geom["va"], self.Gu, self.Bu_w)
        return geom_conv(geom["xs"], self.v_nodes, u, self._gc_tables,
                         1.0, with_wdet=False)[0]

    @spanned("remhos.ho")
    def ho_solution(self, geom, u):
        """The HO solution du_HO[E, nd] of one field at the stage geometry."""
        if self._fused_stage:
            return self._stage_ho_fused(geom, u)
        if not self.cfg.pa:
            return self._ho_solution_assembled(geom, u)
        u_nbr = self.gather_nbr(u)
        contrib = pam.face_full_apply(asm.gather_face(u, self.bdr_dofs),
                                      u_nbr, self.Bface, geom["wvn"])
        Ku = asm.scatter_face_add(self.conv_volume(geom, u), contrib,
                                  self.bdr_dofs)
        if self.cfg.ho == 3:
            return pam.mass_solve_gl(Ku, geom["wdet"], self.Bgl,
                                     self.A_gl2b, stats=self.cg_stats,
                                     all_sum=self.all_sum_fn())
        return pam.mass_solve_bern(Ku, geom["wdet"], self.Bu,
                                   stats=self.cg_stats,
                                   all_sum=self.all_sum_fn())

    def _ho_solution_assembled(self, geom, u):
        """-ho 2|3: K_HO u with zero neighbour values on physical
        boundaries, then the CG or the Cholesky mass solve; -ho 1: the
        element K u plus the full face terms with the inflow on physical
        boundaries, then the Neumann iteration."""
        K, bdrInt, bdr = geom["K_elem"], geom["bdrInt"], self.bdr_dofs
        if self.cfg.ho in (2, 3):
            Ku = asm.apply_K_HO(u, K, bdrInt, self.gather_nbr(u), bdr)
            if self.cfg.ho == 3:
                return hom.local_inverse(Ku, geom["chol_L"])
            return hom.cg_mass_solve(geom["M"], Ku, stats=self.cg_stats,
                                     all_sum=self.all_sum_fn())
        contrib = asm.face_term_full(asm.gather_face(u, bdr),
                                     self.gather_nbr(u, self.inflow_face),
                                     bdrInt)
        rhs = asm.scatter_face_add(asm.matvec(K, u), contrib, bdr)
        return hom.neumann(u, rhs, geom["M"], geom["ml"],
                           all_sum=self.all_sum_fn())

    @spanned("remhos.lo")
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
        if not cfg.pa:
            u_nbr = self.gather_nbr(u, self.inflow_face)
            if cfg.lo in (1, 2):
                return lom.discrete_upwind(u, u_nbr, geom["D"],
                                           geom["bdrInt"], geom["ml"],
                                           self.bdr_dofs)
            return lom.residual_distribution(
                u, u_nbr, geom["K_elem"], geom["bdrInt"], geom["ml"],
                self.bdr_dofs, subcell=cfg.lo == 4,
                subcell_weights=geom.get("sub_w"), sub2ind=self._sub2ind)
        if cfg.lo in (3, 4):
            # residual distribution: the same K u once more (IDP recombines
            # du_HO between the halves, so nothing is kept from the HO
            # solution), the lumped face terms, then the element-local
            # redistribution
            z = self.conv_volume(geom, u)
            contrib = pam.face_lumped_apply(
                asm.gather_face(u, self.bdr_dofs),
                self.gather_nbr(u, self.inflow_face), self.Bface,
                geom["wvn"])
            duf = asm.scatter_face_add(torch.zeros_like(u), contrib,
                                       self.bdr_dofs)
            return lom.residual_distribution_core(
                u, z, duf, geom["ml"], subcell=cfg.lo == 4,
                subcell_weights=geom.get("sub_w"),
                sub2ind=self._sub2ind)
        raise ValueError("no LO solver selected")

    def compute_bounds(self, el_min, el_max, active_el=None):
        """Per-dof bounds (remhos_tpu/operator.py:371-380): at -bt 0 the
        overlap stencil, by the structured separable pass on a grid and
        over the global CG nodes on a general mesh; at -bt 1 the sparsity
        stencil (expanded views of one value per element)."""
        if self.cfg.bounds_type == 0 and self.structured:
            return strm.overlap_bounds_structured(
                el_min, el_max, self.shape, self.periodic, self.disc.p,
                active_el=active_el, masks=self.masks, cls=self._cls)
        return bnd.compute_bounds(el_min, el_max, self._bounds_topo,
                                  self.cfg.bounds_type, active_el=active_el)

    def compute_bounds_stencil(self, el_min, el_max):
        """The element-class overlap stencil (min, max), each [E, 3^dim],
        element-major, that kernel 1's "E" variant expands to dofs: the
        separable pass of `compute_bounds` with 3 classes per axis (low
        endpoint, interior, high endpoint) in place of p+1 dof positions
        (remhos_tpu/operator.py:382-409). None where the bounds are not a
        class stencil (-bt 1, a general mesh). The sharded operator
        overrides it with its halo exchanges; unsharded, the mega stage
        takes the class-major "T" layout, and this is what the tests hold
        the "E" variant with."""
        if not (self.cfg.bounds_type == 0 and self.structured):
            return None
        return strm.overlap_stencil_flat(el_min, el_max, self.shape,
                                         self.periodic, None, self.masks)

    def all_min(self, x):
        """The global minimum of a scalar: itself on one device; over the
        ranks in a sharded run (remhos_tpu/operator.py:461-468)."""
        return x

    def all_sum_fn(self):
        """The reducer of the global CGs' dots and the Neumann residual:
        None (local) on one device, a sum over the ranks when sharded."""
        return None

    def _dt_ratio(self, u, du, x_min, x_max, dt):
        """LO-bounds dt estimate (remhos.cpp:1968-1998): largest dt keeping
        x_min <= u + dt*du <= x_max, as a ratio to the current dt."""
        eps = 1e-12
        pos, neg = du > eps, du < -eps
        up = torch.where(pos, (x_max - u) / torch.where(pos, du, 1.0), INF)
        dn = torch.where(neg, (x_min - u) / torch.where(neg, du, 1.0), INF)
        return self.all_min(torch.minimum(up.min(), dn.min())) / dt

    # ------------------------------------------------------------------
    # stage functions (over the block state S[nfields, E, nd])
    # ------------------------------------------------------------------

    def mult_unlimited(self, t, dt, S, geom=None):
        """HO (or monolithic, or LO-only) update for all fields
        (AdvectionOperator::MultUnlimited, remhos.cpp:1596-1739)."""
        cfg = self.cfg
        if geom is None:
            geom = self.geometry(t)
        outs = []
        for k in range(S.shape[0]):
            if cfg.mono != 0:
                outs.append(monom.mono_rd_solution(self, geom, S[k], dt))
            elif cfg.fct == 0 and cfg.lo != 0:
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
                with span("remhos.bounds"):
                    el_min, el_max = bnd.elements_min_max(u)
                    x_min, x_max = self.compute_bounds(el_min, el_max)
                ratio = self._dt_ratio(u, dS[0], x_min, x_max, dt)
            return dS, self._aux(ratio, viol)

        if geom is None:
            geom = self.geometry(t)
        self._ensure_stage_geom(geom)
        u, du_HO = S[0], dS[0]
        du_LO = self.lo_solution(geom, u, du_HO=du_HO, dt=dt)
        with span("remhos.bounds"):
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

    @spanned("remhos.fct")
    def _fct_solution(self, geom, u, du_HO, du_LO, x_min, x_max, dt):
        fct = self.cfg.fct
        if fct == 2:
            return fctm.clip_scale(u, geom["ml"], du_HO, du_LO, x_min, x_max,
                                   dt)
        if fct == 4:
            return fctm.element_fct_projection(u, du_HO, du_LO, x_min, x_max,
                                               geom["M"], dt)
        if fct == 1:
            return fct_flux.flux_based_fct(self, geom, u, du_HO, du_LO,
                                           x_min, x_max, dt)
        if fct == 3:
            return fct_penalty.nonlinear_penalty(self, geom, u, du_HO, du_LO,
                                                 x_min, x_max, dt)
        raise ValueError(f"unsupported fct type {fct}")

    @spanned("remhos.product")
    def _limit_product(self, geom, t, dt, S, dS, d_u_limited):
        """Product-field block of LimitMult (remhos.cpp:1848-1915).
        Returns (d_us, violation_count). Only FluxBasedFCT takes the LO
        solution of us as input (NeedsLOProductInput)."""
        us, d_us_HO = S[1], dS[1]
        u = S[0]
        d_us_LO = (self.lo_solution(geom, us, du_HO=d_us_HO, dt=dt)
                   if self.cfg.fct == 1 else None)

        # s = us/u on old active dofs; bounds for s on the active stencil
        s, s_el, s_dofs = syncm.compute_ratio(us, u)
        with span("remhos.bounds"):
            el_min, el_max = bnd.elements_min_max(s, active_el=s_el,
                                                  active_dof=s_dofs)
            s_min, s_max = self.compute_bounds(el_min, el_max,
                                               active_el=s_el)

        # evolve u, new activity
        u_new = u + dt * d_u_limited
        el_new, dofs_new = syncm.bool_indicators(u_new)

        return self._fct_product(geom, us, d_us_HO, d_us_LO, s_min, s_max,
                                 u_new, el_new, dofs_new, dt)

    def _fct_product(self, geom, us, d_us_HO, d_us_LO, s_min, s_max, u_new,
                     active_el, active_dofs, dt):
        """CalcFCTProduct of the ClipScale, element-projection and
        flux-based solvers (remhos_fct.cpp:183-262, 543-566, 733-758).
        Returns (d_us, violations)."""
        cfg = self.cfg
        if cfg.fct not in (1, 2, 4):
            raise ValueError(f"unsupported fct product type {cfg.fct}")
        m = geom["ml"]
        dus_lo_fct, s_min, s_max, viol = fctm.calc_compatible_lo_product(
            us, m, d_us_HO, s_min, s_max, u_new, active_el, active_dofs, dt)
        if not cfg.verify_bounds:
            viol = self._no_viol
        us_min, us_max = fctm.scale_product_bounds(s_min, s_max, u_new,
                                                   active_el, active_dofs)
        if cfg.fct == 2:
            d_us = fctm.clip_scale(us, m, d_us_HO, dus_lo_fct, us_min, us_max,
                                   dt)
        elif cfg.fct == 4:
            d_us = fctm.element_fct_projection(us, d_us_HO, dus_lo_fct,
                                               us_min, us_max, geom["M"], dt)
        else:
            d_us = fct_flux.flux_based_fct_product(
                self, geom, us, d_us_HO, d_us_LO, dus_lo_fct, s_min, s_max,
                us_min, us_max, u_new, active_el, active_dofs, dt)
        d_us = syncm.zero_out_empty_dofs(active_el, active_dofs, d_us)
        if cfg.verify_bounds:
            # final product bounds check (remhos_fct.cpp:264-292, 568-610)
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
        one kernel, routed as remhos_tpu/operator.py:706-737 routes it:

        - "T": -bt 0 on an unsharded grid, the class-major overlap stencil;
        - "E": a sharded grid (-bt 0), `compute_bounds_stencil`'s
          element-major stencil with its halo exchanges;
        - "dof": everything else (-bt 1, a general mesh, and the general
          route of a sharded run, where the JAX package wrongly takes "T"
          on the global grid shape: ROADMAP.md, known faults of the
          reference), `compute_bounds`' per-dof bounds made contiguous.

        aux is None: the constant [inf, 0]."""
        u = S[0]
        with span("remhos.bounds"):
            el_min, el_max = bnd.elements_min_max(u)
        u_nbr = self.gather_nbr(u).reshape(u.shape[0], -1)
        P, P16, tb = self._poly, self._poly16, self._stage_tables
        if self.cfg.bounds_type == 0 and self.structured and not self.sharded:
            with span("remhos.bounds"):
                smin, smax = strm.overlap_stencil_T(
                    el_min, el_max, self.shape, self.periodic, self.masks)
            return mega_stage(t, dt, u, u_nbr, smin, smax, P, tb,
                              P16=P16)[None], None
        with span("remhos.bounds"):
            stencil = self.compute_bounds_stencil(el_min, el_max)
        if stencil is not None:
            return mega_stage(t, dt, u, u_nbr, stencil[0], stencil[1], P, tb,
                              bounds="E", P16=P16)[None], None
        with span("remhos.bounds"):
            x_min, x_max = self.compute_bounds(el_min, el_max)
        return mega_stage(t, dt, u, u_nbr, x_min.contiguous(),
                          x_max.contiguous(), P, tb, bounds="dof",
                          P16=P16)[None], None

    def stage_function(self):
        """f(t, dt, S) -> (dS, aux) for the standard RK path
        (LimitedTimeDependentOperator::Mult). The stage cache is made once
        and shared by both halves."""
        @spanned("remhos.stage")
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
