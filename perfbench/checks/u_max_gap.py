"""The widest gap between u as the program produced it and as the reference
computes it, over every dof of a phase (u lies in [0, 1])."""


def value(state, S0, want, ref):
    return float((state[0] - want[0]).abs().max())
