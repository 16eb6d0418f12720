"""``k8_lane_use_pct``: the share of K8's lane-steps that ran a live
bounce (the forward sweep) or a live bounce's adjoint (the reverse one),
the lower of the two sweeps' shares, in the traced window's first K8
call.  It reads the program's ``k8`` counter
(``utils/profiling.counters``; its columns are named by
``ops/cuda/vjp.K8_LANES``: each sweep's lane-steps issued and live),
which the first ``trace_k8`` call of a profiler's window adds into, in
K8's counting forms (the window's other calls run the kernels that count
nothing); None on a program without the counter."""

LAYER = "Kernel K8 (csrc/megakernel.cu k8_vjp, mask 128, through ops/cuda/vjp.trace_k8)"
MOVES = "grad_step_ms"


def read(run, ctx):
    try:
        from pathtrace_tpu_torch.ops.cuda.vjp import K8_LANES
        from pathtrace_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without the counter
        return None
    lanes = counters().get("k8")
    if lanes is None:
        return None
    got = dict(zip(K8_LANES, lanes.tolist()))
    shares = [got[f"{s}.live"] / got[f"{s}.issued"] for s in ("fwd", "rev")
              if got[f"{s}.issued"]]
    return 100.0 * min(shares) if shares else None
