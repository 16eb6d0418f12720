"""``vjp_chain_ms``: the host time of ``render_vjp``'s chain, the mean of
the traced window's steps (the program's ``vjp.chain`` spans: autograd
from the table gradients, copied back once K8 is done, to the parameters
of ``split_params``; the wait for K8 is outside the span)."""

from benchmark.harness.spans import mean_s

LAYER = "Gradient entry points (ops/cuda/vjp.render_vjp: host packing with autograd, K8, the chain)"
MOVES = "grad_step_ms"


def read(run, ctx):
    s = mean_s("vjp.chain")
    return None if s is None else s * 1e3
