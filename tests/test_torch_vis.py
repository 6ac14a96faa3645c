"""remhos_torch.vis and the driver's output options against the JAX package
on the CPU.

- the MFEM mesh text of the same mesh and nodes is the JAX writer's, byte
  for byte: structured 1D, 2D and 3D meshes (periodic ones too), and
  general meshes built from the same arrays (2D quads with mixed start
  vertices, 3D hexes in rotated frames); the grid function text likewise;
- the port's round trip: a mesh written by the port and read back by path
  through the general loader runs to the registry mesh's final mass and max
  u within 1e-13 (tests/test_vis.py's limit);
- `-save` on both drivers: the final nodes (1e-13) and the field (1e-12
  relative) of the written files agree; `sltn_final.npz`'s `shape` is the
  grid's, or (E,) on a general mesh;
- the GLVis payload against a listener on localhost port 0 equals the JAX
  package's; no listener is not an error; a `-ps -vis` run streams the
  three windows of the reference's layout; `-visit` writes the VisIt
  collection; `-prof` writes a Chrome trace of the loop.
"""

import json
import os
import socket
import threading

import numpy as np
import pytest

from remhos_tpu import driver as jdriver
from remhos_tpu import umesh as jumesh
from remhos_tpu import umesh3d as jumesh3d
from remhos_tpu import vis as jvis
from remhos_tpu.config import RunConfig as JConfig
from remhos_tpu.mesh import load_mesh as jload_mesh

from remhos_torch import driver, umesh, umesh3d, vis
from remhos_torch.config import RunConfig
from remhos_torch.mesh import load_mesh
from torch_meshes import mixed_start_2d, scramble_3d, structured_corners
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name,rs", [
    ("inline-quad", 1), ("periodic-square", 1), ("cube01_hex", 1),
    ("periodic-cube", 0), ("periodic-segment", 2), ("inline-quad", 0)])
def test_mesh_text_equals_jax(name, rs):
    jm, tm = jload_mesh(name, rs), load_mesh(name, rs)
    assert np.array_equal(jm.x, tm.x)
    txt = vis.mfem_mesh_text(tm, tm.x)
    assert txt == jvis.mfem_mesh_text(jm, jm.x)
    assert txt.startswith("MFEM mesh v1.0")


def _general(dim, seed):
    """The same general mesh on both sides, from one set of arrays."""
    if dim == 2:
        c, p = mixed_start_2d(*structured_corners(load_mesh("inline-quad",
                                                            1)), seed)
        return jumesh.from_arrays(c, p, 2), umesh.from_arrays(c, p, 2)
    c, p = scramble_3d(*structured_corners(load_mesh("cube01_hex", 1)), seed)
    return jumesh3d.from_arrays_3d(c, p, 2), umesh3d.from_arrays_3d(c, p, 2)


@pytest.mark.parametrize("dim,seed", [(2, 0), (2, 1), (3, 0), (3, 7)])
def test_general_mesh_text_equals_jax(dim, seed):
    jm, tm = _general(dim, seed)
    txt = vis.mfem_mesh_text(tm, tm.x)
    assert txt == jvis.mfem_mesh_text(jm, jm.x)
    assert f"L2_T1_{dim}D_P2" in txt


@pytest.mark.parametrize("p,dim", [(1, 1), (3, 1), (2, 2), (3, 2), (2, 3),
                                   (3, 3)])
def test_gridfunction_text_equals_jax(p, dim):
    u = np.random.default_rng(p + 10 * dim).random((7, (p + 1) ** dim))
    txt = vis.gridfunction_text(u, p, dim)
    assert txt == jvis.gridfunction_text(u, p, dim)
    assert f"L2_T2_{dim}D_P{p}" in txt


ROUNDTRIP = [
    ("inline-quad", dict(problem=14, order=3, ho=3, lo=5, fct=2, pa=True)),
    ("inline-quad", dict(problem=14, order=2, ho=2, lo=4, fct=2, pa=True)),
    ("cube01_hex", dict(problem=10, order=2, ho=3, lo=1, fct=1)),
    ("cube01_hex", dict(problem=10, order=2, ho=3, lo=5, fct=2, pa=True)),
]


@pytest.mark.parametrize("name,kw", ROUNDTRIP)
def test_port_roundtrip(name, kw, tmp_path):
    """The port's writer, read back through the port's general loader, runs
    as the registry mesh does (tests/test_vis.py:20-46)."""
    mesh = load_mesh(name, rs_levels=1)
    path = tmp_path / "rt.mesh"
    path.write_text(vis.mfem_mesh_text(mesh, mesh.x))
    base = dict(dt=0.02, t_final=0.7, max_tsteps=4, device="cpu",
                verbose=False, **kw)
    r1 = driver.run(RunConfig(mesh=name, rs_levels=1, **base))
    r2 = driver.run(RunConfig(mesh=str(path), rs_levels=0, **base))
    assert r2.steps == r1.steps == 4
    assert abs(r1.final_mass_u - r2.final_mass_u) < 1e-13
    assert abs(r1.max_u - r2.max_u) < 1e-13


def _numbers(txt, after):
    return np.array([float(v) for v in txt.split(after)[1].split()])


@pytest.mark.parametrize("general", [False, True])
def test_save_final_equals_jax(general, tmp_path, monkeypatch):
    """-save on both drivers (on a general mesh: a written mixed-start
    mesh, read by path)."""
    mesh = "inline-quad"
    if general:
        _, tm = _general(2, 3)
        path = tmp_path / "mixed.mesh"
        path.write_text(vis.mfem_mesh_text(tm, tm.x))
        mesh = str(path)
    cfg = dict(mesh=mesh, problem=14, rs_levels=0 if general else 1,
               order=2, dt=0.02, t_final=0.7, max_tsteps=3, ho=3, lo=5,
               fct=2, pa=True, save=True, verbose=False)
    out = {}
    for side, run in (("jax", lambda: jdriver.run(JConfig(**cfg))),
                      ("port", lambda: driver.run(RunConfig(device="cpu",
                                                            **cfg)))):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        run()
        out[side] = {f: (d / f).read_text() for f in
                     ("meshHO_final.mesh", "sltn_final.gf")}
        out[side]["npz"] = dict(np.load(d / "sltn_final.npz"))
    j, t = out["jax"], out["port"]
    head = "Ordering: 1\n"
    assert (j["meshHO_final.mesh"].split(head)[0]
            == t["meshHO_final.mesh"].split(head)[0])
    xj = _numbers(j["meshHO_final.mesh"], head)
    xt = _numbers(t["meshHO_final.mesh"], head)
    assert xj.shape == xt.shape and np.abs(xj - xt).max() < 1e-13
    uj, ut = (_numbers(s["sltn_final.gf"], "Ordering: 0") for s in (j, t))
    assert np.abs(uj - ut).max() <= 1e-12 * np.abs(uj).max()
    assert np.array_equal(j["npz"]["shape"], t["npz"]["shape"])
    E = 64
    assert tuple(t["npz"]["shape"]) == ((E,) if general else (8, 8))
    assert t["npz"]["u"].shape == (E, 9) and t["npz"]["x"].shape == (E, 9, 2)


def _listener(backlog):
    srv = socket.socket()
    srv.bind(("localhost", 0))
    srv.listen(backlog)
    return srv, srv.getsockname()[1]


def _read_all(conn):
    chunks = []
    while True:
        b = conn.recv(65536)
        if not b:
            return b"".join(chunks)
        chunks.append(b)


def test_glvis_payload_equals_jax():
    """One frame each from the port and the JAX package to a mock GLVis
    server: the same bytes; and no server is a quiet False."""
    jm, tm = jload_mesh("inline-quad", 0), load_mesh("inline-quad", 0)
    u = np.random.default_rng(5).random((16, 16))
    srv, port = _listener(2)
    got = []

    def accept():
        for _ in range(2):
            conn, _ = srv.accept()
            got.append(_read_all(conn))
            conn.close()

    th = threading.Thread(target=accept)
    th.start()
    ok_t = vis.glvis_stream(tm, tm.x, u, 3, port=port, title="u",
                            keys="mA", geometry=(0, 0, 400, 400))
    ok_j = jvis.glvis_stream(jm, jm.x, u, 3, port=port, title="u",
                             keys="mA", geometry=(0, 0, 400, 400))
    th.join(timeout=10)
    srv.close()
    assert ok_t and ok_j and len(got) == 2
    assert got[0] == got[1]
    text = got[0].decode()
    assert text.startswith("solution\nMFEM mesh v1.0")
    assert "L2_T2_2D_P3" in text and "window_title 'u'" in text
    assert "keys mA" in text and "window_geometry 0 0 400 400" in text
    # nothing listens on a port that was just closed
    assert vis.glvis_stream(tm, tm.x, u, 3, port=port) is False


def test_glvis_product_windows():
    """A -ps -vis run streams "Solution u", "Solution s" and "Solution
    u_s" side by side, before the loop and at every vis step
    (tests/test_vis.py:64-150)."""
    srv, port = _listener(16)
    received = []
    stop = threading.Event()

    def accept_loop():
        srv.settimeout(0.5)
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            received.append(_read_all(conn).decode())
            conn.close()

    th = threading.Thread(target=accept_loop)
    th.start()
    try:
        driver.run(RunConfig(mesh="inline-quad", problem=14, rs_levels=1,
                             order=2, dt=0.005, t_final=0.75, max_tsteps=2,
                             ho=3, lo=5, fct=2, product_sync=True,
                             ode_solver=1, vis=True, vis_port=port,
                             vis_steps=1, pa=True, device="cpu",
                             verbose=False))
    finally:
        stop.set()
        th.join(timeout=5)
        srv.close()
    titles = [line for f in received for line in f.splitlines()
              if line.startswith("window_title")]
    for t in ("u", "s", "u_s"):
        assert titles.count(f"window_title 'Solution {t}'") == 3
    geoms = {line.split()[1] for f in received for line in f.splitlines()
             if line.startswith("window_geometry")}
    assert geoms == {"0", "400", "800"}


def test_visit_datacollection(tmp_path, monkeypatch):
    """-visit writes the VisItDataCollection layout (remhos.cpp:1036-1043):
    the root JSON and a directory of MFEM files per saved cycle, cycle 0
    included (tests/test_vis.py:154-176)."""
    monkeypatch.chdir(tmp_path)
    driver.run(RunConfig(mesh="inline-quad", problem=14, rs_levels=1,
                         order=2, dt=0.01, t_final=0.03, max_tsteps=5, ho=3,
                         lo=5, fct=2, pa=True, visit=True,
                         visit_prefix="Remhos", vis_steps=2, device="cpu",
                         verbose=False))
    roots = sorted(p.name for p in tmp_path.glob("Remhos_*.mfem_root"))
    assert roots == [f"Remhos_{c:06d}.mfem_root" for c in (0, 2, 4, 5)]
    meta = json.loads((tmp_path / roots[-1]).read_text())["dsets"]["main"]
    assert meta["domains"] == 1 and meta["cycle"] == 5
    assert "solution" in meta["fields"]
    mesh_txt = (tmp_path / "Remhos_000005" / "mesh.000000").read_text()
    gf_txt = (tmp_path / "Remhos_000005" / "solution.000000").read_text()
    assert mesh_txt.startswith("MFEM mesh v1.0")
    assert "L2_T2_2D_P2" in gf_txt
    # the cycle-0 collection holds the initial nodes
    m0 = (tmp_path / "Remhos_000000" / "mesh.000000").read_text()
    assert m0 == vis.mfem_mesh_text(load_mesh("inline-quad", 1),
                                    load_mesh("inline-quad", 1).x)


def test_save_final_1d(tmp_path, monkeypatch):
    """1D runs write MFEM segment meshes (geometry id 1)."""
    monkeypatch.chdir(tmp_path)
    driver.run(RunConfig(mesh="periodic-segment", problem=0, rs_levels=2,
                         order=3, dt=0.005, t_final=0.02, ho=3, lo=5, fct=2,
                         save=True, device="cpu", verbose=False))
    mesh_txt = (tmp_path / "meshHO_final.mesh").read_text()
    gf_txt = (tmp_path / "sltn_final.gf").read_text()
    assert "L2_T1_1D_P2" in mesh_txt and "L2_T2_1D_P3" in gf_txt
    elem_lines = mesh_txt.split("elements\n")[1].splitlines()
    assert elem_lines[0] == "16" and elem_lines[1].startswith("1 1 ")
    assert len(_numbers(gf_txt, "Ordering: 0")) == 16 * 4


def test_prof_writes_trace(tmp_path, capsys):
    """-prof records the time loop into a Chrome trace under profile_dir and
    prints where."""
    prof = tmp_path / "prof"
    r = driver.run(RunConfig(mesh="inline-quad", problem=14, rs_levels=1,
                             order=2, dt=0.01, t_final=0.03, max_tsteps=3,
                             ho=3, lo=5, fct=2, pa=True, device="cpu",
                             profile_dir=str(prof)))
    assert os.path.dirname(r.trace_path) == str(prof)
    trace = json.loads(open(r.trace_path).read())
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])
    assert f"Profiler trace written to {prof}" in capsys.readouterr().out
