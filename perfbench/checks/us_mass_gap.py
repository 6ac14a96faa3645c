"""The gap between the mass of the product field us that the program
produced and the reference's, at the final mesh, as a share of the
reference's. The product sync keeps the mass of
us; its dof values are not compared one by one, since the ratio s = us / u
is ill-conditioned on the nearly empty dofs of the material's edge, where
round-off alone moves them."""


def value(state, S0, want, ref):
    m = ref.mass(ref.t_end, want[1])
    return abs(ref.mass(ref.t_end, state[1]) - m) / abs(m)
