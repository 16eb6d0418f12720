"""``grad_step_ms``: the whole measured window over the optimisation
steps completed in it."""

LAYER = "end to end"
MOVES = "grad_step_ms"


def read(run, ctx):
    out = ctx["out"]
    return out["window_s"] * 1e3 / out["work"]
