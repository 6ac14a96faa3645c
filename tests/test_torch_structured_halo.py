"""The halo forms of the port's structured-grid functions against the JAX
package's, on the CPU in f64, with the same deterministic exchange
callables on both sides (each `exchange_fn(bot, top) -> (from_prev,
from_next)` is a plain function of its slabs, so one process holds a shard's
view without a second rank):

- `gather_nbr_structured(..., halo=)` and `face_rolls(..., halo=)`, with
  and without the inflow values on the physical edges: bit for bit (index
  gathers and shifts; JAX's one-hot dot is exact in f64);
- `overlap_stencil_flat(..., axis_exchanges=)` over one and two sharded
  axes, and unsharded against the JAX package's `overlap_stencil_cols`:
  bit for bit (minima and maxima only), and the flat stencil is the
  transpose of the class-major "T" one;
- `overlap_bounds_structured` with `axis_exchanges` against the JAX
  package's `axis_exchanges`, its one-axis `last_axis_exchange` form, and
  with `active_el`: bit for bit;
- `_halo_patch_flat` and `_edge_index`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import structured as jstr

from remhos_torch import structured as strm
from remhos_torch.dofmaps import build_dofmaps
from remhos_torch.mesh import faces_for_dim
from torch_threads import one_torch_thread  # noqa: F401

CASES = [((4, 6), (True, False)), ((3, 4, 5), (False, True, False)),
         ((2, 3, 4), (True, True, True))]
EDGES = [(True, False), (False, True), (True, True)]


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _exchange(lib):
    """A deterministic stand-in for the neighbouring ranks: the previous
    rank's top slab is this one's bot slab scaled and shifted, the next
    rank's bot slab this one's top slab reversed along the slab's first
    grid dimension (not along the trailing dof or class dimensions, whose
    layout the two stencil forms lay out differently)."""
    flip = (lambda a: jnp.flip(a, 0)) if lib == "jax" else (
        lambda a: torch.flip(a, (0,)))

    def fn(bot, top):
        return 1.5 * bot + 0.125, flip(top) - 0.25
    return fn


def _equal(a_torch, a_jax):
    return np.array_equal(a_torch.numpy(), np.asarray(a_jax))


@pytest.mark.parametrize("shape,periodic", CASES, ids=str)
@pytest.mark.parametrize("edges", EDGES, ids=str)
@pytest.mark.parametrize("with_bdr", [False, True])
def test_gather_nbr_halo(shape, periodic, edges, with_bdr):
    dim = len(shape)
    p = 2
    rng = np.random.default_rng(dim * 10 + int(with_bdr))
    dm = build_dofmaps(dim, p)
    E, nd, fd = int(np.prod(shape)), dm.nd, dm.fd
    u = rng.random((E, nd))
    bdr = rng.random((E, 2 * dim, fd)) if with_bdr else None
    grid = tuple(reversed(shape))
    faces = faces_for_dim(dim)
    halo = {}
    axis = dim - 1
    for f, (a, s) in enumerate(faces):
        if a == axis and edges[s == 1 and 1 or 0]:
            slab_shape = list(grid) + [fd]
            slab_shape[dim - 1 - a] = 1
            halo[f] = rng.random(slab_shape)
    per = tuple(False if a == axis else pp for a, pp in enumerate(periodic))
    got = strm.gather_nbr_structured(
        _t(u), shape, per, dm.nbr_dof_local,
        bdr_value=None if bdr is None else _t(bdr),
        halo={f: _t(v) for f, v in halo.items()})
    want = jstr.gather_nbr_structured(
        jnp.asarray(u), shape, per, dm.nbr_dof_local,
        bdr_value=None if bdr is None else jnp.asarray(bdr),
        halo={f: jnp.asarray(v) for f, v in halo.items()})
    assert _equal(got, want)
    # face_rolls, the grid-shift form, on the same face values
    ug = u.reshape(grid + (nd,))
    fv = [ug[..., dm.nbr_dof_local[f]] for f in range(2 * dim)]
    got = strm.face_rolls([_t(v) for v in fv], shape, per,
                          bdr_value=None if bdr is None else _t(bdr),
                          halo={f: _t(v) for f, v in halo.items()})
    want = jstr.face_rolls([jnp.asarray(v) for v in fv], shape, per,
                           bdr_value=None if bdr is None
                           else jnp.asarray(bdr),
                           halo={f: jnp.asarray(v) for f, v in halo.items()})
    for g, w in zip(got, want):
        assert _equal(g, w)


@pytest.mark.parametrize("shape,periodic", CASES, ids=str)
@pytest.mark.parametrize("n_axes", [0, 1, 2])
@pytest.mark.parametrize("edges", EDGES, ids=str)
def test_overlap_stencil_flat_halo(shape, periodic, n_axes, edges):
    dim = len(shape)
    rng = np.random.default_rng(7 + dim + n_axes)
    E = int(np.prod(shape))
    lo = rng.random(E)
    hi = lo + rng.random(E)
    axes = list(range(dim))[dim - n_axes:]
    per = tuple(False if a in axes else pp for a, pp in enumerate(periodic))
    ex_t = {a: (_exchange("torch"), edges) for a in axes}
    ex_j = {a: (_exchange("jax"), edges) for a in axes}
    got = strm.overlap_stencil_flat(_t(lo), _t(hi), shape, per, ex_t or None)
    want = jstr.overlap_stencil_flat(jnp.asarray(lo), jnp.asarray(hi),
                                     shape, per, ex_j or None)
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])
    assert got[0].shape == (E, 3 ** dim)
    if not axes:
        jcols = jstr.overlap_stencil_cols(jnp.asarray(lo), jnp.asarray(hi),
                                          shape, per)
        T = strm.overlap_stencil_T(_t(lo), _t(hi), shape, per)
        for k in (0, 1):
            assert _equal(got[k], jcols[k])
            assert torch.equal(T[k].T, got[k])


@pytest.mark.parametrize("shape,periodic", CASES, ids=str)
@pytest.mark.parametrize("edges", EDGES, ids=str)
@pytest.mark.parametrize("form", ["axis_exchanges", "last_axis",
                                  "active_el"])
def test_overlap_bounds_structured_halo(shape, periodic, edges, form):
    dim = len(shape)
    p = 3
    rng = np.random.default_rng(11 + dim)
    E = int(np.prod(shape))
    lo = rng.random(E)
    hi = lo + rng.random(E)
    axes = [dim - 1] if form != "axis_exchanges" or dim == 2 else \
        [dim - 2, dim - 1]
    per = tuple(False if a in axes else pp for a, pp in enumerate(periodic))
    # the port has one form, `axis_exchanges`; the JAX package's one-axis
    # form `last_axis_exchange` is held against it
    kw_t = dict(axis_exchanges={a: (_exchange("torch"), edges)
                                for a in axes})
    if form == "last_axis":
        kw_j = dict(last_axis_exchange=_exchange("jax"),
                    last_axis_edges=edges)
    else:
        kw_j = dict(axis_exchanges={a: (_exchange("jax"), edges)
                                    for a in axes})
    if form == "active_el":
        act = rng.random(E) > 0.3
        kw_t["active_el"] = torch.as_tensor(act)
        kw_j["active_el"] = jnp.asarray(act)
    got = strm.overlap_bounds_structured(_t(lo), _t(hi), shape, per, p,
                                         **kw_t)
    want = jstr.overlap_bounds_structured(jnp.asarray(lo), jnp.asarray(hi),
                                          shape, per, p, **kw_j)
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


@pytest.mark.parametrize("shape", [(4, 6), (3, 4, 5)], ids=str)
def test_halo_patch_and_edge_index(shape):
    dim = len(shape)
    rng = np.random.default_rng(3)
    grid = tuple(reversed(shape))
    for axis in range(dim):
        for side in (0, 1):
            gd = dim - 1 - axis
            slab_shape = list(grid) + [2]
            slab_shape[gd] = 1
            slab = rng.random(slab_shape)
            got = strm._halo_patch_flat(_t(slab), shape, axis, side)
            want = jstr._halo_patch_flat(jnp.asarray(slab), shape, axis,
                                         side)
            assert _equal(got, want)
            assert strm._edge_index(dim + 1, gd, side) == \
                jstr._edge_index(dim + 1, gd, side)
