"""``k8_roofline_pct``: the least time the card could take for the
window's K8 sweeps (the frozen count of one NEE sample of K1 plus K8's
own, ``benchmark/work/<config>.json`` keys ``k1.nee`` and ``k8.nee``,
times the samples of each step's sweep) over K8's device time in the
traced window (kernels ``k8_vjp`` and its rounding ``fx_round``)."""

from benchmark.harness.trace import kernel_seconds
from benchmark.reference import bound

LAYER = "Kernel K8 (csrc/megakernel.cu k8_vjp, mask 128, through ops/cuda/vjp.trace_k8)"
MOVES = "grad_step_ms"


def read(run, ctx):
    out = ctx["out"]
    k8_s = sum(kernel_seconds(o["trace"]["ops"], "k8_vjp", "fx_round")
               for o in ctx["outs"])
    if not run.work_counts or k8_s <= 0:
        return None
    k1, k8 = run.work_counts["k1.nee"], run.work_counts["k8.nee"]
    least_ms, _ = bound.bound(k1["ops"] + k8["ops"],
                              k1["bytes"] + k8["bytes"])
    samples = out["work"] * run.traffic["spp"]
    return 100.0 * least_ms * 1e-3 * samples / k8_s
