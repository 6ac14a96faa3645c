"""The mass balance with the inflow: the mass of u that the program
produced against the reference's at the phase's end, as a share of the
latter (both in the reference's float64 lumped mass). With an inflow and
an outflow the mass of u changes over a phase, so the reference's mass is
the yardstick, not the initial one."""


def value(state, S0, want, ref):
    m = ref.mass(ref.t_end, want[0])
    return abs(ref.mass(ref.t_end, state[0]) - m) / abs(m)
