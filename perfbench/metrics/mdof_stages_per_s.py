"""Remhos's figure of merit (remhos.cpp:1340-1347) over the whole window:
1e-6 x one field's dofs x the RK stages of every phase completed in the
window / the window's seconds."""


def read(ctx):
    walls = ctx.get("walls")
    if not walls:
        return None
    return (1e-6 * ctx["ndofs"] * ctx["stages_per_phase"] * len(walls)
            / ctx["seconds"])
