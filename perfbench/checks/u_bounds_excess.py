"""FCT's guarantee, as far as the end of a phase shows it: how far u as the
program produced it lies above the largest or below the smallest value of
the initial u (every dof's local bounds lie between the two)."""


def value(state, S0, want, ref):
    u, u0 = state[0], S0[0]
    return max(float(u.max() - u0.max()), float(u0.min() - u.min()), 0.0)
