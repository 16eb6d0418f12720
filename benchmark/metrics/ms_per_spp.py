"""``ms_per_spp``: the whole measured window over the full-image samples
per pixel completed in it (on several cards, every rank's samples)."""

LAYER = "end to end"
MOVES = "ms_per_spp"


def read(run, ctx):
    out = ctx["out"]
    return out["window_s"] * 1e3 / out["work"]
