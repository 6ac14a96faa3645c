"""remhos_torch: the Remhos remap path in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

The package is a port of `remhos_tpu` (JAX/Pallas on a TPU), which stays in
the repository as the reference. Module names mirror the JAX package so a
reader finds each counterpart; nothing here imports `jax` or `remhos_tpu`.

Precision policy, set once at import:

- TF32 is OFF for matmuls and cuDNN. The GL<->Bernstein basis changes have
  a condition number of ~4.3e4, and TF32 geometry measured a ~3e-6/stage
  conservation bias on the reference (docs/PERF.md). Every float32 product
  in the port is a true float32 product.
- `torch.float32` is the production working type, `torch.float64` the
  verification type. Every entry point takes its dtype explicitly.

Device policy: entry points take `device=None`, which means "cuda". Without
a GPU they raise; they never fall back to the CPU on their own. Tests pass
`device="cpu"`, where each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` -> CUDA. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "remhos_torch: CUDA device requested but torch.cuda.is_available()"
            " is False; pass device='cpu' explicitly to run the plain PyTorch"
            " versions of the kernels")
    return dev
