"""``k1_call_us``: the host time of one ``megakernel.trace_k1`` call,
the mean of the traced window's (the program's ``k1`` spans: the table
checks, the two allocations and the fill, the library lookup and the
``ctypes`` launch, which returns before K1 has run)."""

from benchmark.harness.spans import mean_s

LAYER = "Render loop (cli.py's chunk loop, ops/cuda/megakernel.trace_k1's launch path)"
MOVES = "ms_per_spp"


def read(run, ctx):
    s = mean_s("k1")
    return None if s is None else s * 1e6
