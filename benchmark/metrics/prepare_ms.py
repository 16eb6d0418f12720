"""``prepare_ms``: the host time of one ``megakernel.prepare`` call, the
mean of the traced window's (the program's ``prepare`` spans: the scene,
light, mesh and texture tables packed on the host and moved to the
card, once an image)."""

from benchmark.harness.spans import mean_s

LAYER = "Tables (ops/cuda/megakernel.prepare, pack_*)"
MOVES = "ms_per_spp"


def read(run, ctx):
    s = mean_s("prepare")
    return None if s is None else s * 1e3
