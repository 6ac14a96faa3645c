"""Build the CUDA sources with nvcc into shared libraries loaded by ctypes.

Each library is compiled at first use from the sources in the checkout into
`remhos_torch/_build/` (listed in .gitignore), under a name that carries a
hash of the sources, so an edited source is never served from a stale build.
The sources have a plain C interface and include no PyTorch header, which
keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels are built on the GPU machine")
    return path


def library_path(name: str, sources: list[str]) -> Path:
    h = hashlib.sha1()
    for s in sources:
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str, sources: list[str]) -> Path:
    """Compile `sources` (relative to csrc/) unless a build of exactly these
    sources exists. Returns the library path; the ptxas report (registers,
    shared memory, spills of each kernel) is written beside it as .log."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           *[str(CSRC / s) for s in sources]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def load(name: str, sources: list[str]) -> ctypes.CDLL:
    """Build if needed, then load once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, sources)))
        _LOADED[name] = lib
    return lib
