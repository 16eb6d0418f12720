"""``k1_nodes_per_walk``: the mean number of BVH nodes that one mesh walk
of K1 visits in the traced window's first chunk, over every kind of ray
(nearest-hit rays that leave a refraction, the other nearest-hit rays,
shadow rays).  It reads the program's ``k1`` counter
(``utils/profiling.counters``; its columns are named by
``ops/cuda/megakernel.K1_EVENTS``), which the first K1 call of a
profiler's window adds into, in K1's counting form (the window's other
calls run the untraced kernel); None on a program without the counter,
or where no walk ran."""

LAYER = "Kernel K1's BVH walk (csrc/megakernel.cu nearest, mask 512)"
MOVES = "ms_per_spp"


def read(run, ctx):
    try:
        from pathtrace_tpu_torch.ops.cuda.megakernel import K1_EVENTS
        from pathtrace_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without the counter
        return None
    ev = counters().get("k1")
    if ev is None:
        return None
    total = dict(zip(K1_EVENTS, ev.sum(axis=0).tolist()))
    walks = sum(v for k, v in total.items() if k.startswith("walks."))
    nodes = sum(v for k, v in total.items() if k.startswith("nodes."))
    return nodes / walks if walks else None
