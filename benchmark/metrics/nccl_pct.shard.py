"""``nccl_pct.shard``: the share of the traced window in device kernels
whose names start with ``nccl`` (the image's and the counts'
``all_reduce`` of ``parallel/shard._sum``, and the window's stop flag;
not the ``nccl:all_reduce`` annotation around them), the highest of the
ranks."""

LAYER = "Multi-device (parallel/shard.py)"
MOVES = "ms_per_spp"


def read(run, ctx):
    shares = [100.0 * sum(v for k, v in o["trace"]["ops"].items()
                          if k.startswith("nccl") and not k.startswith("nccl:"))
              / o["trace"]["window_s"] for o in ctx["outs"]]
    return max(shares) if any(shares) else None
