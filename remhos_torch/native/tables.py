"""ctypes binding of the native setup tables and MFEM mesh parser
(`remhos_tables.cpp`, the port's own copy).

The library is compiled with g++ at first use into `remhos_torch/_build/`
(listed in .gitignore), under a name that carries a hash of the source, so
an edited source is never served from a stale build. A failed build raises
RuntimeError with the compiler's message: there is no quiet fallback, and a
general mesh file cannot load without the parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "remhos_tables.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lib = None


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libremhos_tables-{h}.so"


def build() -> Path:
    """Compile the library unless a build of exactly this source exists;
    returns its path. Raises RuntimeError with g++'s message on failure."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("remhos_torch.native: g++ not found on PATH; it "
                           "builds the MFEM mesh parser")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                           str(SRC), "-o", tmp], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"remhos_torch.native: g++ failed on {SRC}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)        # atomic: concurrent builds all succeed
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64, f64 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(
            ctypes.c_double)
        u8, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(
            ctypes.c_int32)
        for name, args in (
                ("build_neighbor_table", (ctypes.c_int, i64, u8, i32)),
                ("build_cg_index", (ctypes.c_int, i64, u8, ctypes.c_int,
                                    i32)),
                ("parse_mfem_mesh", (ctypes.c_char_p, i64)),
                ("get_inline_spec", (i64, f64)),
                ("get_mesh_arrays", (i64, f64, f64))):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _lib = lib
    return _lib


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def build_neighbor_table(shape, periodic) -> np.ndarray:
    """nbr[E, 2*dim] of a structured grid: the face neighbour across each
    local face (MFEM's local face order), -1 on a physical boundary."""
    lib = load()
    dim = len(shape)
    out = np.empty((int(np.prod(shape)), 2 * dim), dtype=np.int32)
    rc = lib.build_neighbor_table(
        dim, _ptr(np.asarray(shape, dtype=np.int64), ctypes.c_int64),
        _ptr(np.asarray(periodic, dtype=np.uint8), ctypes.c_uint8),
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"build_neighbor_table failed: rc={rc}")
    return out


def build_cg_index(shape, periodic, q) -> np.ndarray:
    """cg_idx[E, (q+1)^dim] of a structured grid: the global Gauss-Lobatto
    CG node of order q of each lexicographic dof, periodic axes wrapped."""
    lib = load()
    dim = len(shape)
    out = np.empty((int(np.prod(shape)), (q + 1) ** dim), dtype=np.int32)
    rc = lib.build_cg_index(
        dim, _ptr(np.asarray(shape, dtype=np.int64), ctypes.c_int64),
        _ptr(np.asarray(periodic, dtype=np.uint8), ctypes.c_uint8), q,
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"build_cg_index failed: rc={rc}")
    return out


def load_mfem_mesh(path: str) -> dict:
    """Parse an MFEM .mesh file. Returns a dict:
    inline meshes -> {kind: 'inline', dim, n: (..), s: (..)};
    v1.0 meshes   -> {kind: 'v10', dim, elem_verts[E, vpe],
                      verts[nv, dim] or l2_nodes[E, (o+1)^dim, dim] with
                      l2_order}.
    Raises OSError when the file cannot be read or parsed (rc -1: not
    readable, -2: empty, -3: an element geometry other than a segment,
    square or cube, -4: mixed element geometries)."""
    lib = load()
    dims = np.zeros(8, dtype=np.int64)
    rc = lib.parse_mfem_mesh(str(path).encode(), _ptr(dims, ctypes.c_int64))
    if rc != 0:
        raise OSError(f"parse_mfem_mesh({path}) failed: rc={rc}")
    dim, n_elems, n_verts, vpe, has_l2, l2_order, is_inline, n_l2 = (
        int(x) for x in dims)
    if is_inline:
        n = np.zeros(3, dtype=np.int64)
        s = np.zeros(3, dtype=np.float64)
        lib.get_inline_spec(_ptr(n, ctypes.c_int64), _ptr(s, ctypes.c_double))
        return {"kind": "inline", "dim": dim,
                "n": tuple(int(v) for v in n[:dim]),
                "s": tuple(float(v) for v in s[:dim])}
    ev = np.zeros((n_elems, vpe), dtype=np.int64)
    vs = np.zeros((max(n_verts, 1), dim), dtype=np.float64)
    l2 = np.zeros(max(n_l2, 1), dtype=np.float64)
    lib.get_mesh_arrays(_ptr(ev, ctypes.c_int64), _ptr(vs, ctypes.c_double),
                        _ptr(l2, ctypes.c_double))
    out = {"kind": "v10", "dim": dim, "elem_verts": ev}
    if has_l2:
        ndn = (l2_order + 1) ** dim
        out["l2_nodes"] = l2[:n_elems * ndn * dim].reshape(n_elems, ndn, dim)
        out["l2_order"] = l2_order
    else:
        out["verts"] = vs
    return out
