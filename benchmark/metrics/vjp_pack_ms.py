"""``vjp_pack_ms``: the host time of ``render_vjp``'s packing, the mean
of the traced window's steps (the program's ``vjp.pack`` spans: the
parameters split and merged with autograd on, the tables packed on the
host and copied to the card, the cotangent moved there)."""

from benchmark.harness.spans import mean_s

LAYER = "Gradient entry points (ops/cuda/vjp.render_vjp: host packing with autograd, K8, the chain)"
MOVES = "grad_step_ms"


def read(run, ctx):
    s = mean_s("vjp.pack")
    return None if s is None else s * 1e3
