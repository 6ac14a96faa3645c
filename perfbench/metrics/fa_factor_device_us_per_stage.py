"""Device microseconds per RK stage of the assembled path's dense element
solver (`ho.mass_cholesky`, `ho.cho_solve`), the mass report's
factorization at the end of a phase included: the device events whose
launching `aten::` op (the innermost op around the runtime call) is the
batched Cholesky factorization, `aten::linalg_cholesky_ex` (cuSOLVER's
`potrf` batch kernels on an H100), its zeroing of the upper triangle,
`aten::tril_` (the program calls no `tril` of its own), or a triangular
solve, `aten::linalg_solve_triangular` (cuBLAS's `batch_trsm_left`). The
factorization's copy of M into its own layout runs as `aten::copy_` and is
not counted."""

FACTOR_OPS = ("aten::linalg_cholesky_ex", "aten::tril_",
              "aten::linalg_solve_triangular")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    durs = [o["dur"] for o in tr.events if o["op"] in FACTOR_OPS]
    if not durs:
        return None
    return sum(durs) / ctx["stages"]
