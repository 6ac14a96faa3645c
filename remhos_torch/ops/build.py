"""Build the CUDA sources with nvcc into shared libraries loaded by ctypes.

Each library is compiled at first use from the sources in the checkout into
`remhos_torch/_build/` (listed in .gitignore), under a name that carries a
hash of every file it is made of (its .cu sources and the headers they
include, both listed in `LIBRARIES`), so an edited source or header is never
served from a stale build. The sources have a plain C interface and include
no PyTorch header, which keeps a build to seconds. `build_all` starts one
nvcc per library at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

# library name -> (sources, headers they include), relative to csrc/
LIBRARIES = {
    "mega_stage": (("mega_stage.cu",), ("stage_core.cuh",)),
    "stage_ho": (("stage_ho.cu",), ("stage_core.cuh",)),
    "wdet": (("wdet.cu",), ("mesh_geom.cuh", "stage_core.cuh")),
    "geom_conv": (("geom_conv.cu",), ("mesh_geom.cuh", "stage_core.cuh")),
    "stage_ho_nodes": (("stage_ho_nodes.cu",),
                       ("mesh_geom.cuh", "stage_core.cuh")),
    "gl_cg": (("gl_cg.cu",), ("stage_core.cuh",)),
    "gather_nbr": (("gather_nbr.cu",), ()),
    "fa_assemble": (("fa_assemble.cu",), ("mesh_geom.cuh", "stage_core.cuh")),
}

_LOADED: dict[str, ctypes.CDLL] = {}
# mangled template type codes of the kernels' first template argument
_ENTRY_TYPES = {"f": "f32", "d": "f64", "t": "16-bit", "j": "32-bit",
                "m": "64-bit"}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels are built on the GPU machine")
    return path


def library_path(name: str) -> Path:
    sources, headers = LIBRARIES[name]
    h = hashlib.sha1()
    for s in (*sources, *headers):
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, out: Path):
    """Start nvcc for `name` into a temporary file beside `out`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           *[str(CSRC / s) for s in LIBRARIES[name][0]]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp


def _finish(name: str, out: Path, proc, tmp) -> Path:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{stderr}")
    out.with_suffix(".log").write_text(stdout + stderr)
    os.replace(tmp, out)
    return out


def build(name: str) -> Path:
    """Compile library `name` unless a build of exactly its files exists.
    Returns the library path; the ptxas report (registers, shared memory,
    spills of each kernel) is written beside it as .log."""
    return build_all([name])[name]


def build_all(names=None) -> dict[str, Path]:
    """Compile every library of `names` (default: all) that has no build of
    exactly its files, one nvcc each, all started together."""
    names = list(LIBRARIES) if names is None else list(names)
    outs = {n: library_path(n) for n in names}
    running = {n: _start(n, outs[n]) for n in names if not outs[n].exists()}
    errors = []
    for n, (proc, tmp) in running.items():
        try:
            _finish(n, outs[n], proc, tmp)
        except RuntimeError as e:        # let the other compilers end first
            errors.append(e)
    if errors:
        raise errors[0]
    return outs


def ptxas_report(name: str) -> dict[str, str]:
    """Registers and spills of each kernel of a built library, from its
    ptxas log: {"<scalar type> dim <d>[ sizes <a,b,...>]": "<spill line>;
    <register line>"}. The template arguments are read off the mangled entry
    name (`...kernelIfLi3ELi4ELi6EE...` is <float, 3, 4, 6>: dim 3, sizes
    4,6, the compiled 1D sizes, 0 for the runtime-size code; a bool
    argument, as kernel 1's per-dof-bounds flag, is listed as `flags`; the
    gather's element types are unsigned integers of 2, 4 or 8 bytes)."""
    log = library_path(name).with_suffix(".log").read_text()
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"I([fdtjm])((?:L[ib]\d+E)*)", m.group(1))
            ints = re.findall(r"Li(\d+)E", t.group(2)) if t else []
            flags = re.findall(r"Lb(\d+)E", t.group(2)) if t else []
            key = (_ENTRY_TYPES[t.group(1)]
                   + (f" dim {ints[0]}" if ints else "")
                   + (f" sizes {','.join(ints[1:])}" if ints[1:] else "")
                   + (f" flags {','.join(flags)}" if flags else "")
                   if t else m.group(1))
            out[key] = ""
        elif key is not None and ("registers" in ln or "spill" in ln):
            part = ln.replace("ptxas info    :", "").strip()
            out[key] = f"{out[key]}; {part}" if out[key] else part
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load once per process. The library's calls keep
    the GIL (ctypes.PyDLL): a launch entry only enqueues work, and releasing
    and taking back the GIL would cost more than the call."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.PyDLL(str(build(name)))
        _LOADED[name] = lib
    return lib


def bind(lib: ctypes.CDLL, fn: str, argtypes) -> ctypes.CDLL:
    """Set the argument types of the library's launch function `fn` and of
    its error-string function, once per function (a library may have
    several entries)."""
    bound = lib.__dict__.setdefault("_remhos_bound", set())
    if fn not in bound:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        lib.remhos_cuda_error_string.argtypes = [ctypes.c_int]
        lib.remhos_cuda_error_string.restype = ctypes.c_char_p
        bound.add(fn)
    return lib


def _stream_of(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# PyTorch's current CUDA device, and its current stream on a device as an
# int: the direct calls where this build of PyTorch has them
current_device = (getattr(torch._C, "_cuda_getDevice", None)
                  or torch.cuda.current_device)
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or _stream_of


def call_on(device, fn, *args) -> int:
    """fn(*args, stream): a C launch entry called on PyTorch's current
    stream of `device`. The device guard is entered only when `device` is
    not the current device already (the launch goes to the current one)."""
    index = device.index
    if current_device() == index:
        return fn(*args, raw_stream(index))
    with torch.cuda.device(device):
        return fn(*args, raw_stream(index))


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise on a launch function's nonzero return code."""
    if rc != 0:
        msg = (lib.remhos_cuda_error_string(rc).decode() if rc > 0
               else f"bad argument ({rc})")
        raise RuntimeError(f"{what} launch failed: {msg}")
