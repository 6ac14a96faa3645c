"""Native (C++) setup tables and the MFEM mesh parser, built with g++ at
first use into `remhos_torch/_build/` and bound with ctypes (tables.py)."""

from .tables import build_cg_index, build_neighbor_table, load_mfem_mesh

__all__ = ["build_neighbor_table", "build_cg_index", "load_mfem_mesh"]
