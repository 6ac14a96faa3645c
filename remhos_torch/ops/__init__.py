"""The port's CUDA kernels, one module each (wrapper, launch count, plain
PyTorch version), and their setup-time tables.

`KERNELS` names the eight wrappers; each wrapper's `.launches` counts the
launches of its kernel, and only those. A kernel with compile-time variants
(kernel 1's bounds layouts) also counts each variant's launches in
`.variant_launches`."""

from __future__ import annotations

import importlib

KERNELS = ("mega_stage", "stage_ho", "wdet", "geom_conv", "stage_ho_nodes",
           "gl_cg", "gather_nbr", "fa_assemble")


def wrappers() -> dict:
    """{name: wrapper function} of the eight kernels."""
    return {n: getattr(importlib.import_module(f"{__name__}.{n}"), n)
            for n in KERNELS}


def launch_counts() -> dict:
    """{name: launches so far} of the eight kernels."""
    return {n: w.launches for n, w in wrappers().items()}


def variant_counts() -> dict:
    """{name: {variant: launches so far}} of the kernels with variants."""
    return {n: dict(w.variant_launches) for n, w in wrappers().items()
            if hasattr(w, "variant_launches")}


def reset_launch_counts():
    for w in wrappers().values():
        w.launches = 0
        if hasattr(w, "variant_launches"):
            w.variant_launches = dict.fromkeys(w.variant_launches, 0)
