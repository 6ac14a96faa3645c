"""The monolithic solver's explicit-part kernel on the CPU: `ops/mono_rd`'s
predicate, its slot table, its wrapper's plain chain and its place among
the port's kernels.

- `engages` is a pure function of the device, the dtype, the dimension, the
  element's dof count and the `-mono` type: the card, f32 or f64, `-mono
  1`, 2D p = 1 and 2; it agrees with the sizes of the discretizations it
  names.
- The slot table lists, for each dof, the faces that hold it in face
  order, as the plain chain's `index_add` over the `bdr_dofs` rows meets
  them.
- `mono_rd_reference` is the explicit part as it ran before the kernel
  existed (`mono.explicit_part` with its `_rd_weights`, copied below), bit
  for bit, on 2D and 3D meshes, with -si 0, 1 and 2, on problems 7 (no
  inner loop: the rate (du + 0) / ml) and 4 (du and d_full for the inner
  loop), and with `-mono 2`'s subcell RD; so are `explicit_part` and
  `mono_rd_solution` on the CPU.
- On CPU tensors the wrapper is the plain chain, counts no launch, and
  refuses operands of another shape, dtype or device.
"""

import pytest
import torch

from remhos_torch import assembly as asm
from remhos_torch import bounds as bnd
from remhos_torch import driver, lo, mono, ops
from remhos_torch import mono_lumping as mlump
from remhos_torch.config import RunConfig
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import load_mesh, make_cartesian_mesh
from remhos_torch.ops import mono_rd as mr
from remhos_torch.utils import cost
from torch_threads import one_torch_thread  # noqa: F401

F64, F32 = torch.float64, torch.float32

# (device, dtype, dim, nd, mono, engages)
ENGAGE_CASES = [
    ("cuda", F64, 2, 4, 1, True),        # 2D p=1, the benchmark's cell
    ("cuda", F32, 2, 4, 1, True),
    ("cuda", F64, 2, 9, 1, True),        # 2D p=2
    ("cuda", F32, 2, 9, 1, True),
    ("cuda", F32, 2, 16, 1, False),      # 2D p=3
    ("cuda", F64, 3, 8, 1, False),       # 3D p=1
    ("cuda", F32, 3, 27, 1, False),      # 3D p=2
    ("cuda:0", F64, 2, 4, 1, True),
    ("cpu", F64, 2, 4, 1, False),
    ("cpu", F32, 3, 8, 1, False),
    ("cuda", F64, 2, 4, 2, False),       # -mono 2: the subcell RD
    ("cuda", F64, 2, 9, 2, False),
    ("cuda", F64, 2, 4, 0, False),
    ("cuda", F64, 2, 25, 1, False),      # 2D p=4
    ("cuda", F32, 3, 64, 1, False),      # 3D p=3
    ("cuda", F64, 1, 2, 1, False),       # 1D p=1
    ("cuda", F64, 1, 4, 1, False),       # 1D p=3
    ("cuda", torch.float16, 2, 4, 1, False),
    ("cuda", torch.bfloat16, 2, 4, 1, False),
    ("cuda", F64, 3, 4, 1, False),       # sizes of no element
    ("cuda", F64, 2, 8, 1, False),
]


@pytest.mark.parametrize("case", ENGAGE_CASES, ids=str)
def test_engages(case):
    *args, want = case
    assert mr.engages(*args) is want


def _grid(dim, n):
    if dim == 1:
        return load_mesh("periodic-segment", 2)
    return make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim, (1.0,) * dim,
                               (False,) * dim)


@pytest.mark.parametrize("dim,p", [(1, 1), (1, 3), (2, 1), (2, 2), (2, 3),
                                   (2, 4), (3, 1), (3, 2), (3, 3)])
def test_engages_on_the_discretizations(dim, p):
    """On the card, `-mono 1` runs in the kernel on exactly the
    discretizations of 2D p = 1 and 2, in f32 and f64; `-mono 2` and the
    CPU never."""
    disc = build_discretization(_grid(dim, 1), p)
    want = (dim, p) in ((2, 1), (2, 2))
    for dtype in (F64, F32):
        assert mr.engages("cuda", dtype, dim, disc.nd, 1) is want
        assert mr.engages("cuda", dtype, dim, disc.nd, 2) is False
        assert mr.engages("cpu", dtype, dim, disc.nd, 1) is False


@pytest.mark.parametrize("dim,p", [(2, 1), (2, 2), (2, 3), (3, 1), (3, 2)])
def test_slots_list_each_dofs_faces_in_face_order(dim, p):
    """Row i of the slot table holds f fd + a for every face f with
    bdr_dofs[f, a] = i, in increasing f (the order in which the plain
    chain's index_add adds the face terms), padded with -1: a vertex dof on
    dim faces, an edge dof in 3D on two, a face-interior dof on one, an
    interior dof on none."""
    disc = build_discretization(_grid(dim, 1), p)
    bd = torch.as_tensor(disc.dofmaps.bdr_dofs)
    tb = mr.mono_rd_tables(disc.dofmaps.bdr_dofs, disc.nd, "cpu")
    nf, fd = bd.shape
    assert (tb["nd"], tb["nf"], tb["fd"], tb["dim"]) == (disc.nd, nf, fd,
                                                         dim)
    assert tb["slots"].dtype == tb["fdofs"].dtype == torch.int32
    assert tb["slots"].shape == (disc.nd, dim)
    assert torch.equal(tb["fdofs"].long(), bd)
    flat = bd.reshape(-1)
    for i in range(disc.nd):
        want = (flat == i).nonzero().flatten().tolist()
        row = tb["slots"][i].tolist()
        assert row == want + [-1] * (dim - len(want))
    counts = torch.bincount(flat, minlength=disc.nd)
    assert int(counts.max()) == dim
    assert int((counts == 0).sum()) == (p - 1) ** dim


def _parent_explicit_part(adv, geom, u):
    """`mono.explicit_part` as it ran before the kernel existed (with its
    `_rd_weights`), on the same operator: (du, d_full, xi_min, xi_max,
    si_dof)."""
    cfg = adv.cfg
    K, bdrInt = geom["K_elem"], geom["bdrInt"]
    el_min, el_max = bnd.elements_min_max(u)
    xi_min, xi_max = adv.compute_bounds(el_min, el_max)
    si_dof = None
    if cfg.smth_ind:
        si_dof = adv.smth.dof_values(adv.smth.compute(u))
    z = asm.matvec(K, u)
    d_full = z
    up = xi_max - u
    dn = u - xi_min
    alpha = torch.clamp(mono.BETA * torch.minimum(up, dn)
                        / (torch.maximum(up, dn) + mono.EPS), max=1.0)
    if cfg.smth_ind:
        t = si_dof
        bndN = torch.clamp(t * (2. * u - xi_max) + (1. - t) * xi_min,
                           min=0.0)
        bndP = torch.clamp(t * (2. * u - xi_min) + (1. - t) * xi_max,
                           max=1.0)
        aN = torch.clamp(mono.BETA * (u - bndN) / (xi_max - u + mono.EPS),
                         max=1.0)
        aP = torch.clamp(mono.BETA * (bndP - u) / (u - xi_min + mono.EPS),
                         max=1.0)
        mid = xi_min + xi_max
        alpha = torch.where(mid > 2. * u + mono.EPS, aN,
                            torch.where(mid < 2. * u - mono.EPS, aP, alpha))
    du = alpha * z
    z = z - alpha * z
    bdr = adv.bdr_dofs
    u_face = asm.gather_face(u, bdr)
    u_nbr = adv.gather_nbr(u, adv.inflow_face)
    alpha_face = alpha[:, bdr]
    du = asm.scatter_face_add(
        du, mlump.nonlin_flux_lumping(u_face, u_nbr, bdrInt, alpha_face),
        bdr)
    d_full = asm.scatter_face_add(
        d_full, mlump.nonlin_flux_lumping(u_face, u_nbr, bdrInt,
                                          torch.ones_like(alpha_face)), bdr)
    sub_kw = {}
    if cfg.mono == 2:
        sub_kw = dict(subcell=True, subcell_weights=geom["sub_w"],
                      sub2ind=adv._sub2ind, gamma=mlump.GAMMA)
    du = du + lo.residual_distribution_core(u, z, torch.zeros_like(u),
                                            torch.ones_like(u), **sub_kw)
    return du, d_full, xi_min, xi_max, si_dof


# (mesh, problem, refinements, order, mono, si): 2D and 3D, -si 0/1/2,
# problems 7 (no inner loop) and 4 (the loop reads d_full), -mono 2
CHAIN_CASES = [
    ("inline-quad", 7, 2, 1, 1, 2),      # the benchmark cell's options
    ("inline-quad", 7, 2, 1, 1, 0),
    ("inline-quad", 4, 2, 1, 1, 1),
    ("periodic-square", 4, 2, 2, 1, 2),
    ("periodic-square", 7, 1, 3, 1, 1),
    ("periodic-cube", 4, 1, 1, 1, 1),
    ("periodic-cube", 7, 0, 2, 1, 2),
    ("periodic-cube", 4, 0, 2, 1, 0),
    ("periodic-square", 4, 2, 2, 2, 2),  # -mono 2: the subcell RD
    ("inline-quad", 7, 2, 1, 2, 1),
]


def _operator(mesh, problem, rs, order, mono_type, si, seed=3):
    cfg = RunConfig(mesh=mesh, problem=problem, rs_levels=rs, order=order,
                    dt=0.002, ho=0, lo=0, fct=0, mono=mono_type,
                    smth_ind=si, device="cpu", verbose=False)
    adv, _ = driver.build_operator(cfg)
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((adv.disc.mesh.num_elements, adv.disc.nd), generator=g,
                   dtype=F64)
    return adv, adv.geometry(0.0), u


@pytest.mark.parametrize("case", CHAIN_CASES, ids=str)
def test_reference_is_the_parent_chain(case):
    """The plain chain, `explicit_part` and `mono_rd_solution` give what
    the explicit part gave before the kernel existed, bit for bit: (du,
    d_full) without `final`, (du + 0) / ml with it, and the solution of
    the problem (problem 7: that rate; problem 4: with the inner loop); the
    limiter acts (du differs from d_full)."""
    mesh, problem, rs, order, mono_type, si = case
    adv, geom, u = _operator(*case)
    du0, df0, lo0, hi0, si0 = _parent_explicit_part(adv, geom, u)
    assert not torch.equal(du0, df0)
    sub2ind = adv._sub2ind if mono_type == 2 else None
    for final in (False, True):
        got = mr.mono_rd_reference(
            geom, u, lo0, hi0, si0, adv.gather_nbr(u, adv.inflow_face),
            adv.bdr_dofs, final, sub2ind)
        if final:
            assert got[1] is None
            assert torch.equal(got[0], (du0 + torch.zeros_like(u))
                               / geom["ml"])
        else:
            assert torch.equal(got[0], du0) and torch.equal(got[1], df0)
        du, d_full, xi_min, xi_max, si_dof = mono.explicit_part(
            adv, geom, u, final)
        assert torch.equal(xi_min, lo0) and torch.equal(xi_max, hi0)
        assert (si_dof is None) is (si0 is None)
        assert si_dof is None or torch.equal(si_dof, si0)
        assert torch.equal(du, got[0])
        assert (d_full is None) is final
        assert final or torch.equal(d_full, df0)
    sol = mono.mono_rd_solution(adv, geom, u, 0.002)
    if problem in (6, 7):
        want = (du0 + torch.zeros_like(u)) / geom["ml"]
    else:
        m_it = mono.consistent_mass_loop(adv, geom, u, du0, df0, lo0, hi0,
                                         si0)
        want = (du0 + m_it) / geom["ml"]
    assert torch.equal(sol, want)


def _operands(case=("inline-quad", 7, 2, 1, 1, 2)):
    """A `-mono 1` operator on the CPU and one explicit pass's operands to
    mono_rd: (adv, geom, [u, xi_min, xi_max, si_dof, u_nbr])."""
    adv, geom, u = _operator(*case)
    xi_min, xi_max = adv.compute_bounds(*bnd.elements_min_max(u))
    si_dof = adv.smth.dof_values(adv.smth.compute(u)) if case[5] else None
    return adv, geom, [u, xi_min, xi_max, si_dof,
                       adv.gather_nbr(u, adv.inflow_face)]


@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("case", CHAIN_CASES[:8], ids=str)
def test_wrapper_on_the_cpu_is_the_plain_chain(case, final):
    """CPU tensors: the wrapper returns `mono_rd_reference`'s (du, d_full)
    bit for bit and counts no launch."""
    adv, geom, vec = _operands(case)
    before = mr.mono_rd.launches
    got = mr.mono_rd(geom, *vec, adv.mono_rd_tables, final)
    assert mr.mono_rd.launches == before
    want = mr.mono_rd_reference(geom, *vec, adv.bdr_dofs, final)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) is final and (want[1] is None) is final
    assert final or torch.equal(got[1], want[1])


def test_wrapper_refuses_other_operands():
    """Operands of another shape, dtype or device raise before any work."""
    adv, geom, (u, lo_, hi, si, nbr) = _operands()
    tb = adv.mono_rd_tables
    with pytest.raises(ValueError, match="xi_max"):
        mr.mono_rd(geom, u, lo_, hi[:, :2], si, nbr, tb, True)
    with pytest.raises(ValueError, match="u_nbr"):
        mr.mono_rd(geom, u, lo_, hi, si, nbr[:, :2], tb, True)
    with pytest.raises(ValueError, match="bdrInt"):
        mr.mono_rd(dict(geom, bdrInt=geom["bdrInt"][:, :2]), u, lo_, hi, si,
                   nbr, tb, True)
    with pytest.raises(TypeError, match="si_dof"):
        mr.mono_rd(geom, u, lo_, hi, si.float(), nbr, tb, True)
    with pytest.raises(TypeError, match="float32 or float64"):
        mr.mono_rd(geom, u.half(), lo_, hi, si, nbr, tb, True)
    with pytest.raises(ValueError, match="meta"):
        mr.mono_rd(geom, u, lo_.to("meta"), hi, si, nbr, tb, True)


def test_kernel_registry_counts_mono_rd():
    """`ops.KERNELS`, `launch_counts` and `reset_launch_counts` include the
    tenth kernel."""
    assert ops.KERNELS[-1] == "mono_rd" and len(ops.KERNELS) == 10
    assert ops.wrappers()["mono_rd"] is mr.mono_rd
    mr.mono_rd.launches = 6
    assert ops.launch_counts()["mono_rd"] == 6
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_cost_at_the_cell():
    """`utils.cost.mono_rd_cost` at the transport cell's size (2048^2, p=1,
    f64, -si 2, problem 7): K and the face blocks (16 values an element
    each), u_nbr (8), u, xi_min, xi_max, si and ml read once and du
    written once: 2.15 GB, bound by bytes at ~0.641 ms; with d_full (the
    inner loop's problems) ml is not read, d_full is written and a second
    lumping counted."""
    disc = build_discretization(_grid(2, 1), 1)
    tb = mr.mono_rd_tables(disc.dofmaps.bdr_dofs, disc.nd, "cpu")
    E = 2048 ** 2
    u = torch.empty((E, 4), dtype=F64, device="meta")
    nbytes, flops = cost.mono_rd_cost(u, tb)
    assert nbytes == E * (16 + 16 + 8 + 6 * 4) * 8 + (8 + 8) * 4
    lumping = 4 * (2 * 4 + 16 * 2)
    assert flops == E * (2 * 16 + 4 * (11 + 32 + 15 + 1) + lumping + 6)
    b = cost.bound(nbytes, flops, F64)
    assert b["bound_by"] == "bytes" and 0.640 < b["bound_ms"] < 0.642
    nb2, fl2 = cost.mono_rd_cost(u, tb, si=False, final=False)
    assert nb2 == E * (16 + 16 + 8 + 5 * 4) * 8 + (8 + 8) * 4
    assert fl2 == E * (2 * 16 + 4 * (11 + 15) + 2 * lumping + 6)
