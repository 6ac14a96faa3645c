"""The assembled stage's element data on the CPU: `ops/fa_assemble`'s plain
chain, the predicate that routes the card's remap stages to its kernel, its
tables and its place among the port's kernels.

- `Advection._assemble` on the CPU returns the tensors of the chain it ran
  before the kernel existed (written out below from the geometry and
  assembly functions) bit for bit: remap in 3D and 2D at mesh order 2, 3D
  at mesh orders 1 and 3, 3D at p=5 (a rule the kernel is not compiled
  for), transport, and remap in 1D.
- `engages` is a pure function of the device, the execution mode, the
  dimension, the mesh order, the rule's points per axis and the face
  tables; `fa_assemble_tables` builds the kernel's tables only where it
  holds (never on the CPU), and `add_kernel_tables` builds them on the
  CPU, with their layout's sizes, where it holds but for the device.
- The 1D Bernstein tables the kernel contracts with, applied one rule axis
  at a time as the kernel applies them (einsum here), give the plain
  chain's M, ml, K and face blocks to 1e-13.
- The wrapper on CPU tensors is the plain chain and counts no launch.
"""

import numpy as np
import pytest
import torch

from remhos_torch import assembly as asm
from remhos_torch import driver, ops
from remhos_torch import geometry as geo
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import load_mesh, make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import fa_assemble as fa
from remhos_torch.utils import cost
from torch_threads import one_torch_thread  # noqa: F401

OUTPUTS = ("detJ", "M", "ml", "K_elem", "bdrInt")


def _grid(dim, n, mesh_order=2):
    return make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim, (1.0,) * dim,
                               (False,) * dim, mesh_order)


def _remap_operator(mesh, p, dtype=torch.float64, lo=1, fct=1, problem=10):
    disc = build_discretization(mesh, p)
    x0 = torch.as_tensor(mesh.x, dtype=torch.float64)
    v = driver.integrate_mesh_velocity(x0, problem, mesh.bb_min,
                                       mesh.bb_max, 0.7, 0.05)
    cfg = SolverConfig(problem=problem, ho=3, lo=lo, fct=fct, pa=False)
    return Advection(disc, cfg, x0, v, dtype=dtype, device="cpu")


def _chain_before(adv, t):
    """`_assemble`'s element data as the operator formed it before the
    kernel: the volume geometry, the face points and normals, the velocity
    (remap: at the points from the nodes; transport: the problem's
    function), K_elem, bdrInt, M, ml."""
    cfg, disc = adv.cfg, adv.disc

    def T(a):
        return torch.as_tensor(a).to(device="cpu", dtype=adv.dtype)

    Bm, Gm, Bmf = T(disc.Bm), T(disc.Gm), T(disc.Bmf)
    x = (adv.x0_nodes + t * adv.v_nodes if cfg.exec_mode == 1
         else adv.x0_nodes)
    vol = geo.volume_geometry(x, Bm, Gm)
    if adv._face_tan is not None:
        x_fq, nor = geo.face_geometry_tangent(x, Bmf, *adv._face_tan)
    else:
        x_fq, nor = geo.face_geometry(x, Bmf, T(disc.Gmf), T(disc.n_ref))
    if cfg.exec_mode == 0:
        v_q, v_fq = adv._velocity(vol["x_q"]), adv._velocity(x_fq)
        sign = -1.0
    else:
        nf, Qf, nm = disc.Bmf.shape
        v_q = geo.interp_nodes(adv.v_nodes, Bm)
        v_fq = geo.interp_nodes(
            adv.v_nodes, T(disc.Bmf.reshape(nf * Qf, nm))).reshape(
                adv.v_nodes.shape[0], nf, Qf, -1)
        sign = 1.0
    K = asm.element_convection(v_q, vol["adjJ"], T(disc.Bu), T(disc.Gu),
                               T(disc.w_q), sign)
    bdr = asm.face_upwind_matrices(v_fq, nor, T(disc.w_fq), T(disc.Bface),
                                   cfg.exec_mode)
    M = asm.element_mass(vol["detJ"], T(disc.Bu), T(disc.w_q))
    return dict(detJ=vol["detJ"], M=M, ml=asm.lumped_mass(M), K_elem=K,
                bdrInt=bdr)


def _assert_same(geom, want):
    for k in OUTPUTS:
        assert geom[k].dtype == want[k].dtype, k
        assert torch.equal(geom[k], want[k]), k


@pytest.mark.parametrize("dim,n,p,mesh_order,dtype", [
    (3, 2, 2, 2, torch.float64), (3, 2, 2, 2, torch.float32),
    (2, 3, 3, 2, torch.float64), (3, 2, 2, 1, torch.float64),
    (3, 2, 2, 3, torch.float64), (3, 1, 5, 2, torch.float64)])
def test_assemble_on_the_cpu_is_the_chain_before(dim, n, p, mesh_order,
                                                 dtype):
    """Remap: `_assemble(t)` at two times equals the chain it ran before,
    bit for bit, and launches no kernel."""
    adv = _remap_operator(_grid(dim, n, mesh_order), p, dtype)
    ops.reset_launch_counts()
    for t in (0.0, 0.35):
        _assert_same(adv._assemble(t), _chain_before(adv, t))
    assert set(ops.launch_counts().values()) == {0}


def test_transport_assembly_is_the_chain_before():
    """Transport assembles once, at construction, from the velocity
    function at the points: the same tensors as before, bit for bit."""
    mesh = load_mesh("periodic-cube", 0)
    disc = build_discretization(mesh, 2)
    adv = Advection(disc, SolverConfig(problem=0, ho=3, lo=1, fct=1,
                                       pa=False), mesh.x,
                    dtype=torch.float64, device="cpu")
    assert not adv._fa_tables["engaged"] and "bsf" not in adv._fa_tables
    _assert_same(adv._assembled_geom, _chain_before(adv, 0.0))


def test_1d_remap_assembly_is_the_chain_before():
    """1D: the normals from the full face Jacobians, no kernel tables."""
    mesh = load_mesh("periodic-segment", 2)
    disc = build_discretization(mesh, 3)
    x0 = mesh.x
    v = 0.05 * np.sin(2 * np.pi * x0)
    adv = Advection(disc, SolverConfig(problem=10, ho=3, lo=1, fct=1,
                                       pa=False), x0, v,
                    dtype=torch.float64, device="cpu")
    assert adv._fa_tables["face_tan"] is None
    assert "bsf" not in adv._fa_tables
    _assert_same(adv._assemble(0.4), _chain_before(adv, 0.4))


# (device, exec_mode, dim, mesh order, Q1, face tables, engages)
ENGAGE_CASES = [
    ("cuda", 1, 3, 2, 5, True, True),      # p=2, the benchmark's cell
    ("cuda", 1, 3, 2, 6, True, True),      # p=3
    ("cuda", 1, 3, 2, 7, True, True),      # p=4
    ("cuda", 1, 2, 2, 4, True, True),      # 2D p=2
    ("cuda", 1, 2, 2, 6, True, True),      # 2D p=4
    ("cuda:0", 1, 3, 2, 5, True, True),
    ("cpu", 1, 3, 2, 5, True, False),
    ("cuda", 0, 3, 2, 5, True, False),     # transport
    ("cuda", 1, 1, 2, 4, False, False),    # 1D
    ("cuda", 1, 3, 1, 4, True, False),     # mesh order 1
    ("cuda", 1, 3, 3, 6, True, False),     # mesh order 3
    ("cuda", 1, 3, 2, 4, True, False),     # p=1: a runtime size
    ("cuda", 1, 3, 2, 8, True, False),     # p=5
    ("cuda", 1, 2, 2, 3, True, False),     # 2D p=1
    ("cuda", 1, 2, 2, 7, True, False),     # 2D p=5
    ("cuda", 1, 3, 2, 5, False, False),    # no axis-aligned normals
]


@pytest.mark.parametrize("case", ENGAGE_CASES, ids=str)
def test_engages(case):
    *args, want = case
    assert fa.engages(*args) is want


@pytest.mark.parametrize("dim,p,mesh_order,exec_mode,kernel_tables", [
    (3, 2, 2, 1, True), (3, 4, 2, 1, True), (2, 3, 2, 1, True),
    (3, 2, 1, 1, False), (3, 2, 3, 1, False), (3, 5, 2, 1, False),
    (3, 2, 2, 0, False), (1, 3, 2, 1, False)])
def test_tables_follow_the_predicate(dim, p, mesh_order, exec_mode,
                                     kernel_tables):
    """On the CPU nothing engages and no kernel table is made; where
    `engages` holds but for the device, `add_kernel_tables` makes them
    there, and the packed tables have their layout's sizes."""
    disc = build_discretization(_grid(dim, 1, mesh_order), p)
    tb = fa.fa_assemble_tables(disc, torch.float64, "cpu", exec_mode)
    assert tb["engaged"] is False and "bsf" not in tb
    Q1 = round(len(disc.w_q) ** (1 / dim))
    assert fa.engages("cuda", exec_mode, dim, mesh_order, Q1,
                      tb["face_tan"] is not None) is kernel_tables
    if kernel_tables:
        fa.add_kernel_tables(tb, disc)
        Q1, D = tb["Q1"], tb["D"]
        assert (tb["m1"], D, Q1) == (3, p + 1, p + 1 + (2 if dim == 3 else 1))
        assert tb["bsf"].shape == (len(fa.BERNSTEIN_TABLES) * Q1 * D,)
        assert tb["fdesc"].dtype == torch.int32
        assert tb["fdesc"].shape == (2 * dim, 5)


def _pair(a, b):
    """[Q1, D, D] table a[q, i] b[q, j]."""
    return a[:, :, None] * b[:, None, :]


@pytest.mark.parametrize("dim,p", [(3, 2), (3, 3), (2, 2), (2, 4)])
def test_factor_tables_give_the_element_data(dim, p):
    """The kernel's contractions in numpy: w det J, w adj(J) v and wvn from
    the plain geometry, contracted one rule axis at a time (axis 0 fastest
    in points and dofs) with the pairs of B1, G1 and, for ml, S1, equal the
    plain chain's M, ml, K and face blocks to 1e-13 of their largest
    entries."""
    mesh = _grid(dim, 2)
    disc = build_discretization(mesh, p)
    bf = fa.bernstein_factor_tables(disc)
    B1, G1, S1, D, Q1 = (bf[k] for k in ("B1", "G1", "S1", "D", "Q1"))
    rng = np.random.default_rng(dim + p)
    x = mesh.x + 0.03 * np.sin(3.0 * mesh.x[..., ::-1])
    v = 0.3 * rng.standard_normal(x.shape)
    tb = fa.add_kernel_tables(fa.fa_assemble_tables(disc, torch.float64,
                                                    "cpu"), disc)
    xs, vt = torch.as_tensor(x), torch.as_tensor(v)
    ref = [r.numpy() for r in fa.fa_assemble(xs, vt, tb)]
    vol = geo.volume_geometry(xs, tb["Bm"], tb["Gm"])
    w = np.asarray(disc.w_q)
    E = x.shape[0]
    wd = (w * vol["detJ"].numpy()).reshape((E,) + (Q1,) * dim, order="F")
    va = (vol["adjJ"] * geo.interp_nodes(vt, tb["Bm"])[:, :, None, :]).sum(
        -1).numpy()
    wva = [(w * va[..., b]).reshape((E,) + (Q1,) * dim, order="F")
           for b in range(dim)]
    BB, BG, SS = _pair(B1, B1), _pair(B1, G1), S1
    if dim == 3:
        def mat(f, t0, t1, t2):
            return np.einsum("eabc,aik,bjl,cmn->emjinlk", f, t0, t1, t2
                             ).reshape(E, D ** 3, D ** 3)
        # rows (i0, i1, i2) and columns (j0, j1, j2), axis 0 fastest
        M = mat(wd, BB, BB, BB)
        K = mat(wva[0], BG, BB, BB) + mat(wva[1], BB, BG, BB) + \
            mat(wva[2], BB, BB, BG)
        ml = np.einsum("eabc,ai,bj,ck->ekji", wd, SS, SS, SS).reshape(E, -1)
    else:
        def mat(f, t0, t1):
            return np.einsum("eab,aik,bjl->ejilk", f, t0, t1).reshape(
                E, D ** 2, D ** 2)
        M = mat(wd, BB, BB)
        K = mat(wva[0], BG, BB) + mat(wva[1], BB, BG)
        ml = np.einsum("eab,ai,bj->eji", wd, SS, SS).reshape(E, -1)
    nf, Qf = len(disc.n_ref), len(disc.w_fq)
    _, nor = geo.face_geometry_tangent(xs, tb["Bmf"], *tb["face_tan"])
    vn = (geo.face_velocity(vt, tb["Bmf"]) * nor).sum(-1).numpy()
    wvn = np.asarray(disc.w_fq) * np.maximum(vn, 0.0)
    if dim == 3:
        bdr = np.einsum("efab,aik,bjl->efjilk",
                        wvn.reshape(E, nf, Q1, Q1, order="F"), BB, BB
                        ).reshape(E, nf, D * D, D * D)
    else:
        bdr = np.einsum("efa,aik->efik", wvn, BB)
    got = dict(M=M, ml=ml, K_elem=K, bdrInt=bdr)
    for name, r in zip(OUTPUTS, ref):
        if name in got:
            err = np.abs(got[name] - r).max() / np.abs(r).max()
            assert err <= 1e-13, name
    assert Qf == Q1 ** (dim - 1)


def test_wrapper_on_the_cpu_is_the_plain_chain():
    """CPU tensors: the plain chain with the velocity at the points made
    from the nodes, no launch counted; tables without the kernel's (the CPU
    operator's), and operands of another shape or dtype, are refused."""
    mesh = _grid(3, 2)
    adv = _remap_operator(mesh, 2)
    tb = fa.add_kernel_tables(dict(adv._fa_tables), adv.disc)
    xs = adv.x0_nodes + 0.2 * adv.v_nodes
    before = fa.fa_assemble.launches
    got = fa.fa_assemble(xs, adv.v_nodes, tb)
    assert fa.fa_assemble.launches == before
    _assert_same(dict(zip(OUTPUTS, got)), _chain_before(adv, 0.2))
    with pytest.raises(ValueError):
        fa.fa_assemble(xs[:, :8], adv.v_nodes, tb)
    with pytest.raises(TypeError):
        fa.fa_assemble(xs.float(), adv.v_nodes.float(), tb)
    with pytest.raises(ValueError, match="engages"):
        fa.fa_assemble(xs, adv.v_nodes, adv._fa_tables)


def test_kernel_registry_counts_fa_assemble():
    """`ops.KERNELS`, `launch_counts` and `reset_launch_counts` include the
    eighth kernel."""
    assert ops.KERNELS[-1] == "fa_assemble" and len(ops.KERNELS) == 8
    assert ops.wrappers()["fa_assemble"] is fa.fa_assemble
    fa.fa_assemble.launches = 5
    assert ops.launch_counts()["fa_assemble"] == 5
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_cost_counts_the_outputs_once():
    """`utils.cost.fa_assemble_cost` at the benchmark cell's size (64^3,
    p=2, f64): the outputs' 2,096 values an element, the nodes and the
    velocity read once, bound by bytes."""
    disc = build_discretization(_grid(3, 1), 2)
    tb = fa.add_kernel_tables(fa.fa_assemble_tables(disc, torch.float64,
                                                    "cpu"), disc)
    E = 64 ** 3
    xs = torch.empty((E, 27, 3), dtype=torch.float64, device="meta")
    nbytes, flops = cost.fa_assemble_cost(xs, tb)
    tables = sum(tb[k].numel() * tb[k].element_size()
                 for k in fa.KERNEL_TABLES)
    assert nbytes == E * (2096 + 2 * 81) * 8 + tables
    assert cost.matrix_macs(3, 5, 3) == 5 ** 3 * 9 + 5 ** 2 * 81 + 5 * 729
    assert cost.bound(nbytes, flops, torch.float64)["bound_by"] == "bytes"
