#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py`` (multi-device rendering and the native
host runtime) alone, on the card.

    python3 tests/torch_phase20.py

Builds the kernels the phase runs (K1 without and with NEE, each with K5;
K8 with NEE; K6) and the native library at once, makes
``scenes/gen_icosphere7.obj`` if it is absent, then runs
``chip_smoke.shard_phase`` as ``chip_smoke.py`` does, the Python
parser's scenes parsed here.
"""

import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pathtrace_tpu_torch as ptt  # noqa: E402
from pathtrace_tpu_torch.native import lib as N  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import build  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import megakernel as K  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import span as SP  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import vjp as VJ  # noqa: E402
from pathtrace_tpu_torch.render import integrator as I  # noqa: E402


def main():
    t0 = time.perf_counter()
    card = cs.card_line()
    print(card, flush=True)
    if not os.path.exists(os.path.join(HERE, cs.HUGEMESH_OBJ)):
        subprocess.run([sys.executable,
                        os.path.join(HERE, "tools", "gen_mesh.py"), "7",
                        os.path.join(HERE, cs.HUGEMESH_OBJ)], check=True,
                       timeout=300)
    native = threading.Thread(target=N.available)
    native.start()
    build.build_kernels([0, K.NEE_BIT], k8_masks=(K.NEE_BIT,))
    native.join()
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = cs.shard_phase(ptt, K, SP, VJ, I, torch, np,
                              cs.load(ptt, "cornell", ()), {}, card)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s, launches {launches}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
