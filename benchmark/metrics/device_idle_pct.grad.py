"""``device_idle_pct.grad``: 100 less the card's busy share of the
traced window (the union of its operations' intervals over the window's
host time); on several cards the idlest rank's."""

LAYER = "Device (H100)"
MOVES = "grad_step_ms"


def read(run, ctx):
    return max(100.0 * (1.0 - o["trace"]["busy_s"] / o["trace"]["window_s"])
               for o in ctx["outs"])
