"""``k1_roofline_pct``: the least time the card could take for the
window's K1 samples (the configuration's frozen count of one sample,
``benchmark/work/<config>.json``, times the full-image samples of the
window, against the H100 data sheet's peaks) over K1's device time in
the traced window (kernels named ``k1_trace``, every rank's)."""

from benchmark.harness.trace import kernel_seconds
from benchmark.reference import bound

LAYER = "Kernel K1 (csrc/megakernel.cu k1_trace, through ops/cuda/megakernel.trace_k1)"
MOVES = "ms_per_spp"


def read(run, ctx):
    out = ctx["out"]
    k1_s = sum(kernel_seconds(o["trace"]["ops"], "k1_trace")
               for o in ctx["outs"])
    if not run.work_counts or k1_s <= 0:
        return None
    work = run.work_counts["k1.nee" if out.get("nee") else "k1"]
    least_ms, _ = bound.bound(work["ops"], work["bytes"])
    return 100.0 * least_ms * 1e-3 * out["work"] / k1_s
