"""Measurement tools of the port: the kernels' least work (`cost`), the
device trace of a loop (`trace`) and the phase ablation with the
reference's FOM report (`fom`)."""
