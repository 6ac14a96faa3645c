"""Element-sharded advection on a structured grid: one operator per rank and
halo slabs exchanged over `torch.distributed` (the port of
`remhos_tpu.parallel.sharded`).

Elements are block-decomposed over the LAST k mesh axes onto a k-D shard
grid (k = 1 or 2; the reference's METIS decomposition on a grid,
remhos.cpp:459-463). Each rank's block is itself a structured mesh
(`local_mesh_of`) whose sharded axes are locally non-periodic; the
cross-shard face layers are patched from halo slabs exchanged per device
axis (`halo.ShardComm.exchange_slabs`):

- face-neighbour field values (ExchangeFaceNbrData);
- the partially reduced bound slabs after each separable pass
  (GroupCommunicator min/max; exchanging after each pass carries the
  diagonal and corner contributions without corner messages);
- global scalars by all-reduce (MPI_Allreduce): the CGs' dots, the dt
  estimate, and the step's aux (MIN).

For k = 2 the flat element order is permuted to shard-block-major so that
each rank owns a contiguous range (`block_permutation`); sums and maxima do
not depend on it, the driver unpermutes only for output and checkpoints.

The limited mega stage on a shard reads the element-major [E, 3^dim]
stencil with its exchanges (`compute_bounds_stencil`), kernel 1's "E"
variant (remhos_tpu/operator.py:728-737).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bounds as bnd
from .. import steppers
from .. import structured as strm
from ..discretization import build_discretization
from ..mesh import StructuredMesh, faces_for_dim, make_mesh_from_breaks
from ..operator import Advection, SolverConfig
from .halo import ShardComm


def order_devices_for_dcn(ranks):
    """The ranks slice-major (remhos_tpu/parallel/sharded.py:39). A TPU
    deployment of several slices puts the outer device axis across the DCN;
    a process group has no slice index, so this is rank order, and `-dcn`
    leaves every result unchanged."""
    return sorted(ranks)


def shard_axes_spec(dim: int, shard_grid):
    """[(mesh_axis, n)] of the last k mesh axes, the outer device axis (the
    last mesh axis) first. shard_grid[i] shards mesh axis dim - k + i."""
    k = len(shard_grid)
    spec = [(dim - k + i, int(n)) for i, n in enumerate(shard_grid)]
    return list(reversed(spec))


def local_mesh_of(mesh: StructuredMesh, shard_grid) -> StructuredMesh:
    """The mesh of one block: the sharded axes cut into n equal parts
    (non-periodic: their cross faces go through the halos). It carries the
    first block's coordinates; a shard's geometry comes from its own nodes,
    and the tables of this mesh are the same on every block."""
    dim = mesh.dim
    k = len(shard_grid)
    lbreaks, lper = [], []
    for a in range(dim):
        if a < dim - k:
            lbreaks.append(mesh.breaks[a])
            lper.append(mesh.periodic[a])
        else:
            n = shard_grid[a - (dim - k)]
            cnt = mesh.shape[a]
            if cnt % n != 0:
                raise ValueError(f"mesh axis {a} ({cnt}) not divisible by "
                                 f"{n} shards")
            lbreaks.append(mesh.breaks[a][: cnt // n + 1])
            lper.append(False)
    return make_mesh_from_breaks(dim, tuple(lbreaks), tuple(lper),
                                 mesh.mesh_order)


def block_permutation(shape, shard_grid):
    """perm[new_flat] = old flat element index, shard-block-major (the outer
    device axis is the last mesh axis). The identity for k == 1."""
    dim = len(shape)
    k = len(shard_grid)
    if k == 1:
        return np.arange(int(np.prod(shape)))
    if k != 2:
        raise NotImplementedError("shard grids of rank 1 or 2")
    old = np.arange(int(np.prod(shape))).reshape(tuple(reversed(shape)))
    sy, sz = shard_grid              # aligned to the mesh axes (y, z)
    ny_loc, nz_loc = (shape[dim - k + i] // shard_grid[i] for i in range(k))
    blocks = [old[bz * nz_loc:(bz + 1) * nz_loc,
                  by * ny_loc:(by + 1) * ny_loc].reshape(-1)
              for bz in range(sz) for by in range(sy)]
    return np.concatenate(blocks)


class ShardedAdvection(Advection):
    """The operator of one block, halo-aware along every sharded axis.
    axes_spec: [(mesh_axis, n)], outer first, as `shard_axes_spec` gives;
    periodic_global: the global mesh's periodicity; bb_min/bb_max: the
    global box (the problems' velocities scale with it)."""

    sharded = True

    def __init__(self, disc, cfg: SolverConfig, x0_nodes, v_nodes, inflow,
                 axes_spec, periodic_global, bb_min, bb_max, comm: ShardComm,
                 dtype=torch.float64, device=None):
        self.bb_min, self.bb_max = bb_min, bb_max
        self.comm = comm
        self.axes_spec = axes_spec
        self.periodic_global = tuple(periodic_global)
        if cfg.lo == 4 or cfg.mono == 2:
            self._sub_bmask = self._shard_boundary_mask(disc)
        super().__init__(disc, cfg, x0_nodes, v_nodes, dtype=dtype,
                         device=device, inflow=inflow)
        self._face_of = {(a, s): f
                         for f, (a, s) in enumerate(faces_for_dim(disc.dim))}
        self._bdr_dofs = torch.as_tensor(disc.dofmaps.bdr_dofs,
                                         dtype=torch.long, device=self.device)

    def _device_axis(self, mesh_axis):
        return [a for a, _ in self.axes_spec].index(mesh_axis)

    def _edges(self, mesh_axis):
        return self.comm.edge_masks(self._device_axis(mesh_axis),
                                    self.periodic_global[mesh_axis])

    def _exchange(self, mesh_axis, bot, top):
        """(from_prev, from_next) of the edge slabs along a sharded axis."""
        return self.comm.exchange_slabs(top, bot,
                                        self._device_axis(mesh_axis),
                                        self.periodic_global[mesh_axis])

    def _shard_boundary_mask(self, disc):
        """[E_loc, nd] True at the uniform nodes on the GLOBAL physical
        boundary (the -lo 4 subcell velocity is zeroed there only,
        remhos.cpp:841-852): the local edges on the unsharded axes, and on a
        sharded axis the local edge of a rank at the global edge."""
        mesh = disc.mesh
        ref = np.asarray(disc.ref_nodes_u)
        E = mesh.num_elements
        eidx = np.stack(np.unravel_index(np.arange(E), mesh.shape,
                                         order="F"), axis=-1)
        sharded = dict(self.axes_spec)
        mask = np.zeros((E, ref.shape[0]), dtype=bool)
        for d in range(mesh.dim):
            per = (self.periodic_global[d] if d in sharded
                   else mesh.periodic[d])
            if per:
                continue
            at_lo = (eidx[:, d] == 0)[:, None] & (ref[None, :, d] == 0.0)
            at_hi = ((eidx[:, d] == mesh.shape[d] - 1)[:, None]
                     & (ref[None, :, d] == 1.0))
            if d in sharded:
                has_prev, has_next = self.comm.edge_masks(
                    [a for a, _ in self.axes_spec].index(d), False)
                mask |= (at_lo & (not has_prev)) | (at_hi & (not has_next))
            else:
                mask |= at_lo | at_hi
        return mask

    # -- the halo face gather (ExchangeFaceNbrData) -------------------------
    def gather_nbr(self, u, bdr_value=None):
        """u_nbr[E_loc, nf, fd]: the local grid's gather, with each sharded
        axis's edge faces read from the neighbouring ranks, or on a physical
        edge from bdr_value (0 without it)."""
        dim = self.disc.dim
        grid_shape = tuple(reversed(self.shape))
        ug = u.reshape(grid_shape + (u.shape[1],))
        bv = (None if bdr_value is None else
              bdr_value.reshape(grid_shape + bdr_value.shape[1:]))
        halos = {}
        for mesh_axis, _ in self.axes_spec:
            gdim = dim - 1 - mesh_axis
            f_lo = self._face_of[(mesh_axis, 0)]
            f_hi = self._face_of[(mesh_axis, 1)]
            ein_lo = strm._edge_index(ug.ndim, gdim, 0)
            ein_hi = strm._edge_index(ug.ndim, gdim, 1)
            send_dn = ug[..., self._bdr_dofs[f_lo]][ein_lo]
            send_up = ug[..., self._bdr_dofs[f_hi]][ein_hi]
            from_prev, from_next = self._exchange(mesh_axis, send_dn, send_up)
            has_prev, has_next = self._edges(mesh_axis)
            if bv is not None:
                edge_lo = bv[..., f_lo, :][ein_lo]
                edge_hi = bv[..., f_hi, :][ein_hi]
            else:
                edge_lo = torch.zeros_like(send_dn)
                edge_hi = torch.zeros_like(send_up)
            halos[f_lo] = from_prev if has_prev else edge_lo
            halos[f_hi] = from_next if has_next else edge_hi
        return strm.gather_nbr_structured(u, self.shape, self.periodic,
                                          self.nbr_dof_local, self.masks,
                                          bdr_value, halo=halos)

    # -- bounds with halo extrema (GroupCommunicator) -----------------------
    def _bounds_exchanges(self):
        """{mesh_axis: (exchange_fn, (has_prev, has_next))} of the sharded
        axes, the form `structured` takes."""
        return {a: ((lambda bot, top, a=a: self._exchange(a, bot, top)),
                    self._edges(a))
                for a, _ in self.axes_spec}

    def compute_bounds(self, el_min, el_max, active_el=None):
        if self.cfg.bounds_type == 1:
            return self._sparsity_bounds_halo(el_min, el_max, active_el)
        return strm.overlap_bounds_structured(
            el_min, el_max, self.shape, self.periodic, self.disc.p,
            active_el=active_el, masks=self.masks, cls=self._cls,
            axis_exchanges=self._bounds_exchanges())

    def compute_bounds_stencil(self, el_min, el_max):
        """The element-major class stencil [E_loc, 3^dim] with the same
        exchanges as `compute_bounds`: kernel 1's "E" operand."""
        if self.cfg.bounds_type != 0:
            return None
        return strm.overlap_stencil_flat(
            el_min, el_max, self.shape, self.periodic,
            axis_exchanges=self._bounds_exchanges(), masks=self.masks)

    def _sparsity_bounds_halo(self, el_min, el_max, active_el):
        """-bt 1: the local face-neighbour extrema, then each sharded axis's
        edge elements also see the neighbouring rank's edge extrema."""
        dim, nd = self.disc.dim, self.disc.nd
        mmin, mmax = el_min, el_max
        if active_el is not None:
            mmin = torch.where(active_el, el_min, bnd.INF)
            mmax = torch.where(active_el, el_max, -bnd.INF)
        lo, hi = bnd.sparsity_bounds(el_min, el_max,
                                     self._bounds_topo.nbr_elem, nd)
        grid_shape = tuple(reversed(self.shape))
        lo_g = lo.reshape(grid_shape + (nd,)).clone()
        hi_g = hi.reshape(grid_shape + (nd,)).clone()
        mmin_g, mmax_g = mmin.reshape(grid_shape), mmax.reshape(grid_shape)
        for mesh_axis, _ in self.axes_spec:
            gdim = dim - 1 - mesh_axis
            has_prev, has_next = self._edges(mesh_axis)
            ein_lo = strm._edge_index(mmin_g.ndim, gdim, 0)
            ein_hi = strm._edge_index(mmin_g.ndim, gdim, 1)
            for W_g, tgt, worst, op in ((mmin_g, lo_g, bnd.INF, torch.minimum),
                                        (mmax_g, hi_g, -bnd.INF,
                                         torch.maximum)):
                fp, fn = self._exchange(mesh_axis, W_g[ein_lo], W_g[ein_hi])
                if not has_prev:
                    fp = torch.full_like(fp, worst)
                if not has_next:
                    fn = torch.full_like(fn, worst)
                tgt[ein_lo] = op(tgt[ein_lo], fp[..., None])
                tgt[ein_hi] = op(tgt[ein_hi], fn[..., None])
        E = el_min.shape[0]
        return lo_g.reshape(E, nd), hi_g.reshape(E, nd)

    # -- global reductions (MPI_Allreduce) -----------------------------------
    def all_min(self, x):
        return self.comm.all_min(x)

    def all_sum_fn(self):
        return self.comm.all_sum


def step_of(adv, scfg: SolverConfig, ode_solver: int, comm: ShardComm,
            loop=None, compensated=False):
    """step(S, t, dt) -> (S_new, aux) of a shard's operator, aux reduced
    over the ranks by MIN (the min dt ratio and the max violation count;
    None where the stages give none). `compensated` (standard RK): the
    Kahan combine, step(S, C, t, dt) -> (S_new, C_new, aux). With `loop` =
    n: n compensated steps in one call from C = 0 (the bench's production
    loop), aux None."""
    if loop is not None:
        cstep = steppers.make_rk_step(adv.stage_function(), ode_solver,
                                      compensated=True)

        def looped(S, t, dt):
            C = torch.zeros_like(S)
            for _ in range(loop):
                S, C, _ = cstep(S, C, t, dt)
                t = t + dt
            return S, None
        return looped
    if compensated:
        cstep = steppers.make_rk_step(adv.stage_function(), ode_solver,
                                      compensated=True)

        def kahan_step(S, C, t, dt):
            S_new, C_new, aux = cstep(S, C, t, dt)
            return S_new, C_new, None if aux is None else comm.all_min(aux)
        return kahan_step
    if ode_solver <= 10:
        stepper = steppers.make_rk_step(adv.stage_function(), ode_solver)
    else:
        stepper = steppers.make_idp_step(adv.mult_unlimited, adv.limit_mult,
                                         ode_solver,
                                         compute_mask=adv.compute_mask,
                                         use_masks=scfg.use_masks,
                                         geometry=adv.geometry)

    def step(S, t, dt):
        S_new, aux = stepper(S, t, dt)
        return S_new, None if aux is None else comm.all_min(aux)
    return step


class ShardedStep:
    """The step of a sharded run on this rank (`make_sharded_step`):
    step(S, t, dt, x0, v, inflow), all element arrays this rank's block in
    shard-block-major order. The shard's operator is built at the first
    call (or `bind`) and kept while the same x0, v and inflow come back.
    `adv` is that operator, `comm` the rank's ShardComm; `stepper` gives
    the bound operator's step in other forms."""

    def __init__(self, build, comm, scfg, ode_solver, loop=None):
        self._build, self.comm = build, comm
        self._kw = (scfg, ode_solver, comm)
        self._loop = loop
        self.adv, self._key, self._step = None, None, None

    def bind(self, x0, v, inflow):
        """The shard's operator of these nodes, velocity and inflow (built
        once; the arrays are kept, so their ids stay theirs)."""
        key = (id(x0), id(v), id(inflow))
        if key != self._key:
            self.adv = self._build(x0, v, inflow)
            self._step = step_of(self.adv, *self._kw, self._loop)
            self._key, self._args = key, (x0, v, inflow)
        return self.adv

    def __call__(self, S, t, dt, x0, v, inflow):
        self.bind(x0, v, inflow)
        return self._step(S, t, dt)

    def stepper(self, compensated=False):
        """The bound operator's step, step(S, t, dt), or with `compensated`
        the Kahan form step(S, C, t, dt) (`step_of`)."""
        return step_of(self.adv, *self._kw, compensated=compensated)


def _check_solvers(scfg):
    if scfg.mono != 0 or scfg.smth_ind:
        raise NotImplementedError(
            "monolithic/smoothness-indicator solvers run single-shard "
            "(serial in the reference too, remhos_mono.cpp:285)")


def make_sharded_step(mesh, scfg: SolverConfig, order: int, shard_grid,
                      ode_solver: int, group=None, dcn: bool = False,
                      dtype=torch.float64, device=None, loop: int = None):
    """(comm, step, perm) for an element-sharded run, on every rank of the
    process group `group` (None: the default group), which must have
    prod(shard_grid) ranks.

    shard_grid: an int (the last mesh axis) or a tuple over the last k mesh
    axes. perm[new] = old element id, shard-block-major; len(perm) > E
    means ghost padding (the general route). step: a `ShardedStep`.
    Shard counts that do not divide the structured axes, and general
    meshes, take the general route (`gsharded.make_general_sharded_step`).
    dcn: accepted, rank order (`order_devices_for_dcn`). loop: see
    `step_of`."""
    if isinstance(shard_grid, int):
        shard_grid = (shard_grid,)
    shard_grid = tuple(int(n) for n in shard_grid)
    _check_solvers(scfg)
    dim = mesh.dim
    k = len(shard_grid)
    structured = getattr(mesh, "structured", True)
    divisible = structured and k <= dim and all(
        mesh.shape[dim - k + i] % shard_grid[i] == 0 for i in range(k))
    if not divisible:
        from .gsharded import make_general_sharded_step
        return make_general_sharded_step(
            mesh, scfg, order, int(np.prod(shard_grid)), ode_solver,
            group=group, dtype=dtype, device=device, loop=loop)
    axes_spec = shard_axes_spec(dim, shard_grid)
    comm = ShardComm(tuple(n for _, n in axes_spec), group)
    disc_loc = build_discretization(local_mesh_of(mesh, shard_grid), order)

    def build(x0, v, inflow):
        return ShardedAdvection(disc_loc, scfg, x0, v, inflow, axes_spec,
                                mesh.periodic, mesh.bb_min, mesh.bb_max,
                                comm, dtype=dtype, device=device)

    return comm, ShardedStep(build, comm, scfg, ode_solver, loop), \
        block_permutation(mesh.shape, shard_grid)


def shard_arrays(comm: ShardComm, S, x0, v, inflow, perm=None, n_real=None):
    """This rank's block of the global arrays: permuted to shard-block-major
    order (perm, with ghost rows copying element perm[i] = 0 beyond n_real),
    then rows [r E_loc, (r + 1) E_loc) for rank r. Ghost rows of S, v and
    inflow are zero (their geometry keeps element 0's valid nodes). v and
    inflow may be None."""
    E = S.shape[1] if perm is None else len(perm)
    if E % comm.size:
        raise ValueError(f"{E} elements do not split over {comm.size} ranks")
    n_loc = E // comm.size
    lo = comm.rank * n_loc
    idx = torch.arange(lo, lo + n_loc)
    rows = idx if perm is None else torch.as_tensor(perm[lo:lo + n_loc],
                                                    dtype=torch.long)

    def take(a, dim0):
        if a is None:
            return None
        out = a.index_select(dim0, rows.to(a.device))
        if n_real is not None and lo + n_loc > n_real:
            live = (idx < n_real).to(a.device)
            shape = [1] * out.ndim
            shape[dim0] = n_loc
            out = out * live.reshape(shape).to(out.dtype)
        return out

    S_l = take(S, 1)
    x0_l = x0.index_select(0, rows.to(x0.device))
    return S_l, x0_l, take(v, 0), take(inflow, 0)
