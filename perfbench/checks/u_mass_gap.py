"""The closure's guarantee: the mass of u that the program produced, at the
final mesh, against the mass of the initial u at the initial mesh, as a
share of the latter (both in the reference's float64 lumped mass)."""


def value(state, S0, want, ref):
    m0 = ref.mass(0.0, S0[0])
    return abs(ref.mass(ref.t_end, state[0]) - m0) / abs(m0)
