#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (the progressive render and the texel
gradients) alone, on the card, its kernels built at first use.

    python3 tests/torch_phase19.py               # progressive_phase
    python3 tests/torch_phase19.py --texel N     # texel_gradients N times,
                                                 # then busy_share

The first form runs the phase as ``chip_smoke.py`` does, at full size
(cornell.txt and cornell_tex.txt at 800x800 d8), in a process that has
run nothing before it, so its first steps carry the process's first
calls.  The second repeats the texel-gradient step of both engines in
one process (the first round cold, the later ones warm) and then
measures the busy share of a 64-spp CLI loop in a fresh process.
"""

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pathtrace_tpu_torch as ptt  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import matgrad as MG  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import megakernel as K  # noqa: E402
from pathtrace_tpu_torch.render import diff as D  # noqa: E402
from pathtrace_tpu_torch.render import integrator as I  # noqa: E402


def main(argv):
    card = cs.card_line()
    print(card, flush=True)
    cornell = cs.load(ptt, "cornell", ())
    tex = cs.load(ptt, "cornell_tex", ())
    if argv[:1] == ["--texel"]:
        for k in range(int(argv[1])):
            t0 = time.perf_counter()
            cs.texel_gradients(K, I, D, torch, np, tex, card)
            print(f"round {k}: {time.perf_counter() - t0:.1f} s", flush=True)
        with tempfile.TemporaryDirectory() as work:
            cs.busy_share(cornell, work, card)
        return 0
    t0 = time.perf_counter()
    k1, k7 = cs.progressive_phase(
        ptt, K, MG, torch, np,
        {"cornell": (cornell,), "cornell_tex": (tex,)}, card)
    print(f"phase 19: K1 {k1}, K7 {k7}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
