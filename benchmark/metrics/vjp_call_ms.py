"""``vjp_call_ms``: the host clock around each ``render_vjp`` call of the
window's steps (it returns once the gradient is on the host, which waits
for K8), averaged over the window's steps."""

LAYER = "Gradient entry points (ops/cuda/vjp.render_vjp: host packing with autograd, K8, the chain)"
MOVES = "grad_step_ms"


def read(run, ctx):
    out = ctx["out"]
    return out["vjp_call_s"] * 1e3 / out["work"]
