"""Checkpoint and resume of a run's state: the port of
`remhos_tpu.checkpoint` for its numpy-archive backend.

A checkpoint is one `.npz` file with the block state S[nfields, E, nd] in
global element order, the time t, the step size dt and the step count ti:
the JAX package's `load_state` reads it. Its other backend, an orbax
checkpoint directory, is not ported (orbax is not a dependency of the
port), so any path that does not end in `.npz` raises ValueError.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_path(path: str) -> None:
    if not path.endswith(".npz"):
        raise ValueError(
            f"checkpoint path {path!r}: remhos_torch writes and reads numpy "
            "archives only; give a path ending in .npz")


def save_state(path: str, S, t: float, dt: float, ti: int) -> None:
    _check_path(path)
    np.savez(path, S=torch.as_tensor(S).cpu().numpy(), t=float(t),
             dt=float(dt), ti=int(ti))


def load_state(path: str):
    """(S as a numpy array, t, dt, ti)."""
    _check_path(path)
    with np.load(path) as ck:
        return ck["S"], float(ck["t"]), float(ck["dt"]), int(ck["ti"])
