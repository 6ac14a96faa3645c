"""The assembled stage's flux-based FCT kernel on the CPU: `ops/fa_fct`'s
predicate, its face-pair table, its wrapper's plain chain and its place
among the port's kernels.

- `engages` is a pure function of the device, the dtype and the element's
  sizes (nd, nf, fd): the card, f32 or f64, p = 2..4 in 2D and 3D; it
  agrees with the sizes of the discretizations it names.
- The face-pair table the kernel reads (flat own-own indices, the repeats
  at edges and corners included), applied row by row in face order as the
  kernel applies it, rebuilds `fct_flux.k_ho_diag_blocks` bit for bit.
- On CPU tensors the wrapper is the plain chain: it returns what
  `fct_flux.flux_based_fct` returned before the kernel existed (the flux
  blocks, then the sweeps) bit for bit, at 2D and 3D, p = 2..4, with 1 and
  2 sweeps, counts no launch, and refuses operands of another shape or
  dtype.
"""

import pytest
import torch

from remhos_torch import bounds, driver, fct_flux, ops
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import load_mesh, make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import fa_fct as ff
from remhos_torch.utils import cost
from torch_threads import one_torch_thread  # noqa: F401

F64, F32 = torch.float64, torch.float32

# (device, dtype, nd, nf, fd, engages)
ENGAGE_CASES = [
    ("cuda", F64, 27, 6, 9, True),       # 3D p=2, the benchmark's cell
    ("cuda", F32, 27, 6, 9, True),
    ("cuda", F64, 64, 6, 16, True),      # 3D p=3
    ("cuda", F32, 125, 6, 25, True),     # 3D p=4
    ("cuda", F64, 125, 6, 25, True),
    ("cuda", F64, 9, 4, 3, True),        # 2D p=2
    ("cuda", F32, 16, 4, 4, True),       # 2D p=3
    ("cuda", F64, 25, 4, 5, True),       # 2D p=4
    ("cuda:0", F64, 27, 6, 9, True),
    ("cpu", F64, 27, 6, 9, False),
    ("cpu", F32, 9, 4, 3, False),
    ("cuda", F64, 8, 6, 4, False),       # 3D p=1
    ("cuda", F64, 216, 6, 36, False),    # 3D p=5
    ("cuda", F64, 4, 4, 2, False),       # 2D p=1
    ("cuda", F32, 36, 4, 6, False),      # 2D p=5
    ("cuda", torch.float16, 27, 6, 9, False),
    ("cuda", torch.bfloat16, 27, 6, 9, False),
    ("cuda", F64, 3, 2, 1, False),       # 1D p=2
    ("cuda", F64, 27, 4, 9, False),      # sizes of no element
]


@pytest.mark.parametrize("case", ENGAGE_CASES, ids=str)
def test_engages(case):
    *args, want = case
    assert ff.engages(*args) is want


@pytest.mark.parametrize("dim,p", [(1, 2), (1, 4), (2, 1), (2, 2), (2, 3),
                                   (2, 4), (2, 5), (3, 1), (3, 2), (3, 3),
                                   (3, 4)])
def test_engages_on_the_discretizations(dim, p):
    """On the card, the kernel takes exactly the discretizations of p =
    2..4 in 2D and 3D, in f32 and f64, from the sizes of their tables."""
    disc = build_discretization(_grid(dim, 1), p)
    nf, fd = disc.dofmaps.bdr_dofs.shape
    want = dim in (2, 3) and 2 <= p <= 4
    for dtype in (F64, F32):
        assert ff.engages("cuda", dtype, disc.nd, nf, fd) is want
        assert ff.engages("cpu", dtype, disc.nd, nf, fd) is False


def _grid(dim, n):
    if dim == 1:
        return load_mesh("periodic-segment", 2)
    return make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim, (1.0,) * dim,
                               (False,) * dim)


# (dim, n, p): 2D and 3D at p = 2..4
SIZES = [(2, 3, 2), (2, 3, 3), (2, 2, 4), (3, 2, 2), (3, 2, 3), (3, 1, 4)]


def _stage(dim, n, p, seed=5):
    """An assembled remap operator (`-ho 3 -lo 1 -fct 1`, f64, CPU) and one
    stage's FCT inputs from a seeded u: (adv, geom, u, du_HO, du_LO, u_min,
    u_max, dt)."""
    mesh = _grid(dim, n)
    disc = build_discretization(mesh, p)
    x0 = torch.as_tensor(mesh.x, dtype=F64)
    v = driver.integrate_mesh_velocity(x0, 10, mesh.bb_min, mesh.bb_max,
                                       0.7, 0.05)
    adv = Advection(disc, SolverConfig(problem=10, ho=3, lo=1, fct=1,
                                       pa=False), x0, v, dtype=F64,
                    device="cpu")
    geom = adv._assemble(0.2)
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((geom["M"].shape[0], disc.nd), generator=g, dtype=F64)
    dt = 0.02
    du_ho = adv.ho_solution(geom, u)
    du_lo = adv.lo_solution(geom, u, du_HO=du_ho, dt=dt)
    u_min, u_max = adv.compute_bounds(*bounds.elements_min_max(u))
    return adv, geom, u, du_ho, du_lo, u_min, u_max, dt


def _row_owned_diag_blocks(K, bdrInt, pairs):
    """K_HO's diagonal blocks as the kernel forms them: each row i takes its
    own-own face terms from the face-pair table, face by face in face
    order (the row of pair (f, a, b) is pairs[f, a, 0] // nd)."""
    E, nd = K.shape[:2]
    D = K.clone().reshape(E, nd * nd)
    nf, fd = pairs.shape[:2]
    rows = pairs[:, :, 0] // nd
    for i in range(nd):
        for f in range(nf):
            for a in (rows[f] == i).nonzero().flatten().tolist():
                for b in range(fd):
                    t = int(pairs[f, a, b])
                    D[:, t] = D[:, t] - bdrInt[:, f, a, b]
    return D.reshape(E, nd, nd)


@pytest.mark.parametrize("dim,n,p", SIZES)
def test_face_pairs_rebuild_the_diagonal_blocks(dim, n, p):
    """The face-pair table holds each face's own-own pairs as flat indices
    i nd + j (an edge pair on 2 faces, in 3D a corner's diagonal on 3), and
    applied as the kernel applies it gives `k_ho_diag_blocks` bit for
    bit."""
    adv, geom = _stage(dim, n, p)[:2]
    tb = adv.fa_fct_tables
    bd = adv.bdr_dofs
    nd, nf, fd = adv.disc.nd, *bd.shape
    assert (tb["nd"], tb["nf"], tb["fd"]) == (nd, nf, fd)
    pairs = tb["pairs"]
    assert pairs.dtype == torch.int32 and pairs.shape == (nf, fd, fd)
    assert torch.equal(pairs.long() // nd, bd[:, :, None].expand(nf, fd, fd))
    assert torch.equal(pairs.long() % nd, bd[:, None, :].expand(nf, fd, fd))
    repeats = torch.bincount(pairs.flatten().long(), minlength=nd * nd)
    assert int(repeats.max()) == dim
    got = _row_owned_diag_blocks(geom["K_elem"], geom["bdrInt"], pairs)
    assert torch.equal(got, fct_flux.k_ho_diag_blocks(
        geom["K_elem"], geom["bdrInt"], bd))


def _chain_before(adv, geom, u, du_ho, du_lo, u_min, u_max, dt, iters):
    """`flux_based_fct` as it ran before the kernel: the flux blocks, then
    the sweeps."""
    F, _ = fct_flux._flux_blocks(geom, adv.bdr_dofs, u, du_ho, dt)
    return fct_flux._fct_iterations(F, u, du_lo, geom["ml"], u_min, u_max,
                                    dt, iters)


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("dim,n,p", SIZES)
def test_wrapper_on_the_cpu_is_the_plain_chain(dim, n, p, iters):
    """CPU tensors: the wrapper, `fa_fct_reference` and `flux_based_fct`
    return the chain's du bit for bit, and no launch is counted; the
    limiter acts (du differs from du_LO)."""
    adv, geom, u, du_ho, du_lo, u_min, u_max, dt = _stage(dim, n, p)
    want = _chain_before(adv, geom, u, du_ho, du_lo, u_min, u_max, dt,
                         iters)
    assert not torch.equal(want, du_lo)
    before = ff.fa_fct.launches
    got = ff.fa_fct(geom, u, du_ho, du_lo, u_min, u_max, dt,
                    adv.fa_fct_tables, iters)
    assert ff.fa_fct.launches == before
    assert torch.equal(got, want)
    assert torch.equal(ff.fa_fct_reference(geom, u, du_ho, du_lo, u_min,
                                           u_max, dt, adv.bdr_dofs, iters),
                       want)
    assert torch.equal(fct_flux.flux_based_fct(adv, geom, u, du_ho, du_lo,
                                               u_min, u_max, dt, iters),
                       want)


def test_wrapper_refuses_other_operands():
    """Operands of another shape, dtype or device raise before any work."""
    adv, geom, u, du_ho, du_lo, u_min, u_max, dt = _stage(3, 1, 2)
    tb = adv.fa_fct_tables
    with pytest.raises(ValueError, match="u_min"):
        ff.fa_fct(geom, u, du_ho, du_lo, u_min[:, :8], u_max, dt, tb)
    with pytest.raises(ValueError, match="bdrInt"):
        ff.fa_fct(dict(geom, bdrInt=geom["bdrInt"][:, :4]), u, du_ho, du_lo,
                  u_min, u_max, dt, tb)
    with pytest.raises(TypeError, match="du_ho"):
        ff.fa_fct(geom, u, du_ho.float(), du_lo, u_min, u_max, dt, tb)
    with pytest.raises(TypeError, match="float32 or float64"):
        ff.fa_fct(geom, u.half(), du_ho, du_lo, u_min, u_max, dt, tb)
    with pytest.raises(ValueError, match="meta"):
        ff.fa_fct(geom, u, du_ho, du_lo, u_min.to("meta"), u_max, dt, tb)


def test_kernel_registry_counts_fa_fct():
    """`ops.KERNELS`, `launch_counts` and `reset_launch_counts` include the
    ninth kernel."""
    assert ops.KERNELS[8] == "fa_fct" and len(ops.KERNELS) == 10
    assert ops.wrappers()["fa_fct"] is ff.fa_fct
    ff.fa_fct.launches = 4
    assert ops.launch_counts()["fa_fct"] == 4
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_cost_at_the_cell():
    """`utils.cost.fa_fct_cost` at the benchmark cell's size (64^3, p=2,
    f64): K, M and the face blocks read once, seven [E, nd] vectors (six
    in, du out), the face-pair table; the yardstick's flux and sweep
    operations, 14,742 an element for one sweep; bound by bytes."""
    disc = build_discretization(_grid(3, 1), 2)
    tb = ff.fa_fct_tables(disc.dofmaps.bdr_dofs, disc.nd, "cpu")
    E = 64 ** 3
    u = torch.empty((E, 27), dtype=F64, device="meta")
    nbytes, flops = cost.fa_fct_cost(u, tb)
    assert nbytes == E * (2 * 729 + 6 * 81 + 7 * 27) * 8 + 486 * 4
    assert flops == E * 14742
    assert cost.fa_fct_cost(u, tb, iters=2)[1] == E * (14742 + 9 * 729
                                                        + 15 * 27)
    b = cost.bound(nbytes, flops, F64)
    assert b["bound_by"] == "bytes" and 1.33 < b["bound_ms"] < 1.34
