"""Element-sharded advection on GENERAL meshes, and on structured ones whose
shard count does not divide the grid: the table-driven route (the port of
`remhos_tpu.parallel.gsharded`).

The reference partitions such meshes with METIS and exchanges
one-element-deep face neighbours (remhos.cpp:459-463,
ParFiniteElementSpace::ExchangeFaceNbrData). Here every cross-element
reference stays a GLOBAL element index and the three cross-shard data
flows are collectives over the process group:

- face-neighbour values: each rank takes its face traces [E_loc, nf, fd]
  (fd << nd) and all-gathers them; a neighbour value is then a gather
  traces[nbr_elem, nbr_face, nbr_facedof] with the rank's slice of the
  tables;
- the overlap (-bt 0) bounds: each rank scatter-min/maxes its element
  extrema onto the GLOBAL CG node grid and the partial grids are reduced
  with all-reduce MIN / MAX (GroupCommunicator::Reduce);
- the sparsity (-bt 1) bounds: all-gathered element extrema; the global
  scalars: all-reduce.

Elements are Morton-ordered so that each rank owns a spatially compact
contiguous block (the locality role of METIS). An element count that does
not divide the ranks is padded with GHOST elements (the reference tests
odd rank counts, np=3, CMakeLists.txt:79-81): ghosts copy element 0's
geometry (a valid det J), carry zero fields, velocity and inflow, have no
neighbours, and scatter their bounds to a spare CG node n_cg, so they add
nothing to any reduction.

The mega stage here takes kernel 1's per-dof variant with the reduced
CG-node bounds. (The JAX package takes its class-major "T" stencil on the
global grid shape with the shard's local extrema, and fails: ROADMAP.md,
known faults of the reference.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import bounds as bnd
from .. import dofmaps as dmm
from .. import subcell as subm
from ..discretization import build_discretization
from ..mesh import faces_for_dim
from ..operator import Advection
from .halo import ShardComm
from .sharded import ShardedStep, _check_solvers


def morton_permutation(centers: np.ndarray) -> np.ndarray:
    """perm[new] = old element id, by the Morton code of the quantized
    element centres: spatially compact contiguous blocks."""
    c = np.asarray(centers, np.float64)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-300)
    q = np.minimum(((c - lo) / span * 1023.0).astype(np.uint64), 1023)
    code = np.zeros(c.shape[0], np.uint64)
    for bit in range(10):
        for a in range(c.shape[1]):
            code |= ((q[:, a] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(
                bit * c.shape[1] + a)
    return np.argsort(code, kind="stable")


def build_facedof_table(dofmaps, nbr_face: np.ndarray) -> np.ndarray:
    """nbr_facedof[e, f, k]: the position of nbr_dof_local[e, f, k] in the
    neighbour's face-dof list bdr_dofs[nbr_face[e, f]] (0 at boundaries)."""
    bdr = np.asarray(dofmaps.bdr_dofs)
    nf, fd = bdr.shape
    inv = np.zeros((nf, dofmaps.nd), np.int32)
    for f in range(nf):
        inv[f, bdr[f]] = np.arange(fd, dtype=np.int32)
    nd_loc = np.asarray(dofmaps.nbr_dof_local)     # [E, nf, fd] or [nf, fd]
    safe_f = np.maximum(np.asarray(nbr_face), 0)
    return inv[safe_f[:, :, None], nd_loc]


def structured_nbr_face(mesh) -> np.ndarray:
    """nbr_face of a structured mesh: the neighbour across face (axis, s)
    sees this element through its face (axis, 1 - s)."""
    faces = faces_for_dim(mesh.dim)
    opp = np.array([faces.index((a, 1 - s)) for a, s in faces], np.int32)
    return np.broadcast_to(opp, (mesh.num_elements, len(faces))).copy()


class GeneralShardedAdvection(Advection):
    """One rank's block of a general mesh: cross-shard access by all-gathers
    of the face traces and table gathers. The tables are this rank's rows
    (long tensors on the device): nbr_elem [E_loc, nf] GLOBAL ids (-1 on a
    boundary), nbr_face, nbr_facedof [E_loc, nf, fd], cg_idx [E_loc, nd]
    GLOBAL CG ids of n_cg nodes."""

    sharded = True

    def __init__(self, disc, cfg, x0, v, inflow, nbr_elem, nbr_face,
                 nbr_facedof, cg_idx, n_cg, comm: ShardComm, bb_min, bb_max,
                 dtype=torch.float64, device=None, sub_bmask=None):
        self.bb_min, self.bb_max = bb_min, bb_max
        self.comm = comm
        if sub_bmask is not None:
            self._sub_bmask = sub_bmask
        super().__init__(disc, cfg, x0, v, dtype=dtype, device=device,
                         inflow=inflow)
        dev = self.device
        self._nbr_elem = nbr_elem.to(dev)
        self._nbr_face = nbr_face.clamp(min=0).to(dev)
        self._nbr_facedof = nbr_facedof.to(dev)
        self._cg_idx = cg_idx.to(dev)
        self._n_cg = n_cg
        self._bdr_dofs = torch.as_tensor(disc.dofmaps.bdr_dofs,
                                         dtype=torch.long, device=dev)

    def _bounds_topology(self):
        return None          # the bounds come from the global tables

    def gather_nbr(self, u, bdr_value=None):
        tr = u[:, self._bdr_dofs]                           # [E_loc, nf, fd]
        trg = self.comm.all_gather(tr)                      # [E_pad, nf, fd]
        safe = self._nbr_elem.clamp(min=0)
        vals = trg[safe[:, :, None], self._nbr_face[:, :, None],
                   self._nbr_facedof]
        mask = (self._nbr_elem >= 0)[:, :, None]
        return torch.where(mask, vals, 0.0 if bdr_value is None
                           else bdr_value)

    def compute_bounds(self, el_min, el_max, active_el=None):
        if self.cfg.bounds_type == 0:
            x_min, x_max = bnd.overlap_cg_minmax(el_min, el_max, self._cg_idx,
                                                 self._n_cg, active_el)
            x_min = self.comm.all_min(x_min)
            x_max = self.comm.all_max(x_max)
            return x_min[self._cg_idx], x_max[self._cg_idx]
        mmin, mmax = el_min, el_max
        if active_el is not None:
            mmin = torch.where(active_el, el_min, bnd.INF)
            mmax = torch.where(active_el, el_max, -bnd.INF)
        gmin, gmax = self.comm.all_gather(mmin), self.comm.all_gather(mmax)
        safe = self._nbr_elem.clamp(min=0)
        valid = self._nbr_elem >= 0
        nmin = torch.where(valid, gmin[safe], bnd.INF).amin(dim=1)
        nmax = torch.where(valid, gmax[safe], -bnd.INF).amax(dim=1)
        lo = torch.minimum(el_min, nmin)
        hi = torch.maximum(el_max, nmax)
        E, nd = el_min.shape[0], self.disc.nd
        return lo[:, None].expand(E, nd), hi[:, None].expand(E, nd)

    def compute_bounds_stencil(self, el_min, el_max):
        return None          # the mega stage takes the per-dof bounds

    def all_min(self, x):
        return self.comm.all_min(x)

    def all_sum_fn(self):
        return self.comm.all_sum


def make_general_sharded_step(mesh, scfg, order: int, n_shards: int,
                              ode_solver: int, group=None,
                              dtype=torch.float64, device=None, loop=None):
    """(comm, step, perm) of a mesh sharded into n_shards Morton-contiguous
    blocks, with the contract of `sharded.make_sharded_step`. len(perm) > E
    signals ghost padding: `sharded.shard_arrays(..., n_real=E)` zeroes the
    ghost rows, and perm[:E] unpermutes."""
    _check_solvers(scfg)
    comm = ShardComm((n_shards,), group)
    E = mesh.num_elements
    pad = (-E) % n_shards
    disc = build_discretization(mesh, order)
    dm = disc.dofmaps
    topo = dmm.bounds_topology(mesh, order, "cpu", dm)
    perm = morton_permutation(mesh.element_centers())
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(E)

    # the rows permuted, and the stored global element ids renumbered
    nbr_elem = topo.nbr_elem.numpy()[perm]
    nbr_elem = np.where(nbr_elem >= 0, inv_perm[np.maximum(nbr_elem, 0)], -1)
    nbr_face_full = getattr(mesh, "nbr_face", None)
    if nbr_face_full is None:
        nbr_face_full = structured_nbr_face(mesh)
    nbr_face = np.asarray(nbr_face_full)[perm]
    nbr_facedof = build_facedof_table(dm, np.asarray(nbr_face_full))[perm]
    cg_idx = topo.cg_idx.numpy()[perm]
    n_cg = topo.n_cg
    sub_bmask = None
    if scfg.lo == 4:
        # the subcell boundary mask in GLOBAL context (ghosts: True)
        sub_bmask = subm.boundary_node_mask(mesh, disc.ref_nodes_u)[perm]
    if pad:
        nf = nbr_elem.shape[1]
        nbr_elem = np.vstack([nbr_elem, np.full((pad, nf), -1)])
        nbr_face = np.vstack([nbr_face, np.zeros((pad, nf), np.int32)])
        nbr_facedof = np.vstack(
            [nbr_facedof,
             np.zeros((pad,) + nbr_facedof.shape[1:], nbr_facedof.dtype)])
        cg_idx = np.vstack([cg_idx, np.full((pad, cg_idx.shape[1]), n_cg)])
        n_cg += 1                      # the spare node takes ghost bounds
        if sub_bmask is not None:
            sub_bmask = np.vstack(
                [sub_bmask, np.ones((pad, sub_bmask.shape[1]), bool)])
        perm = np.concatenate([perm, np.zeros(pad, perm.dtype)])

    # the shard's operator needs only the shared tables of the dofmaps: the
    # per-element ones are blanked so that nothing stale is read
    dm_shared = dataclasses.replace(
        dm, nbr_elem=np.zeros((1, dm.nfaces), np.int64),
        nbr_dof_local=np.asarray(dm.nbr_dof_local).reshape(
            -1, dm.nfaces, dm.fd)[:1],
        cg_idx=np.zeros((1, dm.nd), np.int64))
    disc_shared = dataclasses.replace(disc, dofmaps=dm_shared)
    n_loc = len(perm) // n_shards
    rows = slice(comm.rank * n_loc, (comm.rank + 1) * n_loc)

    def L(a):
        return torch.as_tensor(np.ascontiguousarray(a[rows]),
                               dtype=torch.long)

    def build(x0, v, inflow):
        return GeneralShardedAdvection(
            disc_shared, scfg, x0, v, inflow, L(nbr_elem), L(nbr_face),
            L(nbr_facedof), L(cg_idx), n_cg, comm, mesh.bb_min, mesh.bb_max,
            dtype=dtype, device=device,
            sub_bmask=None if sub_bmask is None else sub_bmask[rows])

    return comm, ShardedStep(build, comm, scfg, ode_solver, loop), perm
