"""The control of ``correct``: the reference put in the program's place
and computed in bfloat16, the precision below the configurations' stated
float32, at a cell's own size, on several seeds:

    python benchmark/control.py --workload <cell> --seed <n> [<n> ...]

For each seed it prints the numbers a run compares, the control's beside
each limit (``benchmark/limits/<cell>.json``), and whether the control
fails the cell, as it must; it exits non-zero if it passes on any seed.
A render cell's control renders the run's first image (every sample of
the image from iteration ``seed + 1``, on the run's pixel sample) and its
first chunk; ``inverse_light``'s runs the checked steps from the light's
start.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import check  # noqa: E402
from benchmark.harness.cells import Cells, Run  # noqa: E402


def control_numbers(cells, name, seed, device, dtype=torch.bfloat16,
                    fault=None):
    """The numbers of ``name``'s check with the control (the reference
    in ``dtype``) in the program's place; for ``inverse_light`` with
    ``fault``, the float32 reference with that fault planted instead."""
    run = Run(cells, name, seed, device=device)
    run.write_scene()
    mix = run.traffic
    if mix["job"] == "inverse_light":
        from benchmark.reference import tables as RT

        start = RT.scene_from_config(run.config, run.obj_paths).translations(
        ).numpy().copy()
        start[mix["light"]] += np.asarray(mix["offset"], np.float32)
        out = dict(start=start, checked=[None] * mix["checked_steps"])
        if fault:
            return check.check_inverse(run, out, torch.float32, fault)
        return check.check_inverse(run, out, dtype)
    flags = mix["cli"]
    nee, chunk = "--nee" in flags, int(flags[flags.index("--chunk") + 1])
    cam = run.config["camera"]
    n_img = cam["iterations"]
    out = dict(nee=nee, rr="--rr" in flags, image=(seed + 1, n_img, None),
               chunks=[(seed + 1, min(chunk, n_img), None)])
    return check.check_render(run, out, dtype)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=("half", "altered", "stale"),
                   help="inverse_light: the reference with this fault in "
                        "the program's place, for the upper readings")
    args = p.parse_args(argv)
    cells = Cells(ROOT)
    limits = cells.limits(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    passed = []
    for seed in args.seed:
        t0 = time.time()
        nums = control_numbers(cells, args.workload, seed, device,
                               fault=args.fault)
        fails = {k: not v <= limits[k]["limit"] for k, v in nums.items()}
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              fault=args.fault, control=nums, fails=fails,
                              seconds=round(time.time() - t0, 1))),
              flush=True)
        if not any(fails.values()):
            passed.append(seed)
    if passed:
        print(f"the control passes {args.workload} on seeds {passed}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
