"""The port's CUDA kernels, one module each (wrapper, launch count, plain
PyTorch version), and their setup-time tables.

`KERNELS` names the seven wrappers; each wrapper's `.launches` counts the
launches of its kernel, and only those."""

from __future__ import annotations

import importlib

KERNELS = ("mega_stage", "stage_ho", "wdet", "geom_conv", "stage_ho_nodes",
           "gl_cg", "gather_nbr")


def wrappers() -> dict:
    """{name: wrapper function} of the seven kernels."""
    return {n: getattr(importlib.import_module(f"{__name__}.{n}"), n)
            for n in KERNELS}


def launch_counts() -> dict:
    """{name: launches so far} of the seven kernels."""
    return {n: w.launches for n, w in wrappers().items()}


def reset_launch_counts():
    for w in wrappers().values():
        w.launches = 0
