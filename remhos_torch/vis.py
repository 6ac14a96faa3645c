"""MFEM-format output and GLVis streaming: the port of `remhos_tpu.vis`.

The reference writes `meshHO_final.mesh` / `sltn_final.gf` with
Mesh::PrintAsOne and GridFunction::SaveAsOne (remhos.cpp:1365-1380) and
streams fields to a live GLVis server (VisualizeField,
remhos_tools.cpp:1489-1537). This module makes the same artifacts, with
the same text as the JAX package:

- meshes as "MFEM mesh v1.0" with a per-element L2 (Gauss-Lobatto lattice)
  nodes GridFunction: valid for periodic, curved and moved meshes, and the
  layout `native/remhos_tables.cpp` reads back;
- solutions as Bernstein (Positive, BasisType 2) L2 GridFunctions in MFEM's
  element-major lexicographic dof order;
- `glvis_stream` speaks the GLVis socket protocol ("solution\\n<mesh><gf>")
  to a running server; no server listening is not an error (the reference
  warns and goes on).

Fields and nodes may be torch tensors on any device or numpy arrays; they
are written in float64.
"""

from __future__ import annotations

import json
import os
import socket

import numpy as np
import torch


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def _structured_corner_ids(mesh):
    """([E, 2^dim] lattice vertex ids in lexicographic corner order, the
    number of vertices) of a structured mesh; periodic axes wrap."""
    shape, dim = mesh.shape, mesh.dim
    nv_ax = [shape[a] + (0 if mesh.periodic[a] else 1) for a in range(dim)]
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    eflat = np.zeros_like(grids[0])
    mul = 1
    for a in range(dim):                      # flat element order: x fastest
        eflat = eflat + grids[a] * mul
        mul *= shape[a]
    out = np.zeros((mesh.num_elements, 2 ** dim), np.int64)
    for c in range(2 ** dim):
        vid = np.zeros_like(grids[0])
        mul = 1
        for a in range(dim):
            coord = grids[a] + ((c >> a) & 1)
            if mesh.periodic[a]:
                coord = coord % nv_ax[a]
            vid = vid + coord * mul
            mul *= nv_ax[a]
        out[eflat.reshape(-1), c] = vid.reshape(-1)
    return out, int(np.prod(nv_ax))


def _corner_table(mesh):
    if getattr(mesh, "structured", True):
        return _structured_corner_ids(mesh)
    corners = np.asarray(mesh.corners, np.int64)
    return corners, int(corners.max()) + 1


_GEOM = {1: 1, 2: 3, 3: 5}           # MFEM geometry ids: SEGMENT, SQUARE, CUBE
_MFEM_VERT = {1: [0, 1],             # segment end points
              2: [0, 1, 3, 2],       # lex corner -> MFEM ccw quad
              3: [0, 1, 3, 2, 4, 5, 7, 6]}   # lex -> MFEM hex


def mfem_mesh_text(mesh, x_nodes) -> str:
    """The mesh with geometry x_nodes[E, nm, dim] (each element's GLL
    lattice) as MFEM mesh v1.0 text with L2 nodes."""
    dim = mesh.dim
    corners, nv = _corner_table(mesh)
    x = _f64(x_nodes).reshape(mesh.num_elements, -1, dim)
    k = round(x.shape[1] ** (1.0 / dim)) - 1
    lines = ["MFEM mesh v1.0", "", "dimension", str(dim), "", "elements",
             str(mesh.num_elements)]
    vorder = _MFEM_VERT[dim]
    head = "1 %d " % _GEOM[dim]
    for ev in corners:
        lines.append(head + " ".join(str(int(ev[j])) for j in vorder))
    lines += ["", "boundary", "0", "", "vertices", str(nv), "", "nodes",
              "FiniteElementSpace",
              f"FiniteElementCollection: L2_T1_{dim}D_P{k}",
              f"VDim: {dim}", "Ordering: 1", ""]
    fmt = " ".join(["%.16g"] * dim)
    lines += [fmt % tuple(row) for row in x.reshape(-1, dim)]
    return "\n".join(lines) + "\n"


def gridfunction_text(u, p: int, dim: int) -> str:
    """A Bernstein DG field u[E, nd] as MFEM GridFunction text (L2_T2 =
    BasisType::Positive; element-major lexicographic dofs)."""
    lines = ["FiniteElementSpace",
             f"FiniteElementCollection: L2_T2_{dim}D_P{p}",
             "VDim: 1", "Ordering: 0", ""]
    lines += ["%.16g" % v for v in _f64(u).reshape(-1)]
    return "\n".join(lines) + "\n"


def save_final(mesh, x_nodes, u, p: int, mesh_path="meshHO_final.mesh",
               sltn_path="sltn_final.gf"):
    """The reference's -save artifacts (remhos.cpp:1365-1380)."""
    with open(mesh_path, "w") as fh:
        fh.write(mfem_mesh_text(mesh, x_nodes))
    with open(sltn_path, "w") as fh:
        fh.write(gridfunction_text(u, p, mesh.dim))


def visit_save(prefix, mesh, x_nodes, u, p: int, t: float, cycle: int,
               field_name="solution"):
    """A VisItDataCollection snapshot (remhos.cpp:1036-1043, 1324-1328):

    - `<prefix>_<cycle:06d>.mfem_root`: the JSON root file;
    - `<prefix>_<cycle:06d>/mesh.000000`: the mesh at its current nodes;
    - `<prefix>_<cycle:06d>/<field>.000000`: the field,

    the single-domain layout VisIt's MFEM reader (and GLVis) load."""
    dirname = f"{prefix}_{cycle:06d}"
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "mesh.000000"), "w") as fh:
        fh.write(mfem_mesh_text(mesh, x_nodes))
    with open(os.path.join(dirname, f"{field_name}.000000"), "w") as fh:
        fh.write(gridfunction_text(u, p, mesh.dim))
    base = os.path.basename(dirname)
    root = {"dsets": {"main": {
        "cycle": int(cycle), "time": float(t), "time_step": 0.0,
        "domains": 1,
        "mesh": {"path": f"{base}/mesh.%06d",
                 "tags": {"comments": "", "format": "MFEM mesh v1.0",
                          "size": "1", "spatial_dim": str(mesh.dim),
                          "topo_dim": str(mesh.dim), "max_lods": "32"}},
        "fields": {field_name: {"path": f"{base}/{field_name}.%06d",
                                "tags": {"assoc": "nodes", "comps": "1",
                                         "lod": str(max(p, 1))}}}}}}
    with open(dirname + ".mfem_root", "w") as fh:
        json.dump(root, fh, indent=3)


def glvis_stream(mesh, x_nodes, u, p: int, host="localhost", port=19916,
                 title="u", keys=None, timeout=0.5, geometry=None) -> bool:
    """Send one solution frame to a GLVis server; True on success.

    geometry: an optional (x, y, width, height) window placement, the
    reference's three-window product layout (remhos.cpp:1058-1069). No
    server listening is not an error: the reference warns once and turns
    visualization off (remhos_tools.cpp:1520-1534)."""
    payload = ("solution\n" + mfem_mesh_text(mesh, x_nodes)
               + gridfunction_text(u, p, mesh.dim))
    if keys:
        payload += f"keys {keys}\n"
    payload += f"window_title '{title}'\n"
    if geometry is not None:
        payload += "window_geometry %d %d %d %d\n" % tuple(geometry)
    try:
        with socket.create_connection((host, port), timeout=timeout) as s:
            s.sendall(payload.encode())
        return True
    except OSError:
        return False


def stream_fields(cfg, mesh, x_now, u, us=None):
    """Stream the reference's window set (remhos.cpp:1045-1070 before the
    loop, 1307-1321 in it): "Solution u" at (0, 0) and, for product remap,
    "Solution s" (s = us/u, ComputeRatio) and "Solution u_s" beside it."""
    Ww = Wh = 400
    glvis_stream(mesh, x_now, u, cfg.order, host=cfg.vis_host,
                 port=cfg.vis_port, title="Solution u",
                 geometry=(0, 0, Ww, Wh))
    if us is not None:
        from . import sync as syncm
        s, _, _ = syncm.compute_ratio(us, u)
        glvis_stream(mesh, x_now, s, cfg.order, host=cfg.vis_host,
                     port=cfg.vis_port, title="Solution s",
                     geometry=(Ww, 0, Ww, Wh))
        glvis_stream(mesh, x_now, us, cfg.order, host=cfg.vis_host,
                     port=cfg.vis_port, title="Solution u_s",
                     geometry=(2 * Ww, 0, Ww, Wh))
