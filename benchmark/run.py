"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
per-layer metrics, frozen work count and limits are found by name
(``harness/cells.py``).  The run sets up (writes the scene, loads it,
builds or loads the kernels, warms up every shape the window runs),
measures the window for ``--seconds`` (with ``--trace 1`` under the
profiler, for the per-layer metrics), closes it, reads the peak memory,
frees the program's state, checks what the window produced against the
plain reference (``harness/check.py``), and prints the numbers compared
beside their limits on standard error and one JSON line last on standard
output.  A cell on more than one chip runs one process a card
(``torch.distributed`` on NCCL, ``--shard``); this process spawns them,
gathers their results and runs the check.

It exits non-zero and prints no result without CUDA or with fewer cards
than the cell asks for, without the program, or if the process holds
``jax``, ``jaxlib``, ``flax`` or ``pathtrace_tpu`` once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"
# every build and kernel cache in fixed directories of the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtrace_tpu")


def fail(msg, code=1):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules():
    """The top-level names of ``sys.modules`` that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(args, n, device):
    """Runs the cell's job in ``n`` processes, one a card, and returns
    their outputs (rank order)."""
    import torch

    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory(prefix="ptbench_ranks_") as work:
        procs = []
        for r in range(n):
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace),
                   "--rank-dir", work, "--device", device.type]
            if args.fault:
                cmd += ["--fault", args.fault]
            procs.append(subprocess.Popen(
                cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
        codes = []
        try:
            for p in procs:
                codes.append(p.wait(timeout=330))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            fail(f"a rank failed: exit codes {codes}")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


def rank_main(args, cells):
    """A rank of a cell on several cards: joins the group, runs the job
    on its card, saves its output for the spawning process."""
    import torch
    import torch.distributed as dist

    from benchmark.harness import jobs
    from benchmark.harness.cells import Run
    from pathtrace_tpu_torch.parallel import shard

    rank = int(os.environ["RANK"])
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    shard.join_world(device.type)
    try:
        if args.fault == "no_exchange":
            shard._sum = lambda t, mesh: t
        run = Run(cells, args.workload, args.seed, args.seconds, args.trace,
                  device, args.fault)
        out = jobs.JOBS[run.traffic["job"]](run, shard.make_mesh(
            device=device))
    finally:
        dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        fail(f"rank {rank} holds {found} after the window")
    torch.save(out, os.path.join(args.rank_dir, f"rank{rank}.pt"))


def measure(args, cells, device, fault=None):
    """Set-up, window and check of one run in this process (or its
    ranks'); returns the result line's dict and the numbers compared."""
    import numpy as np
    import torch

    from benchmark.harness import check, jobs
    from benchmark.harness.cells import Run

    run = Run(cells, args.workload, args.seed, args.seconds, args.trace,
              device, fault)
    ranks = int(run.traffic.get("ranks", 1))
    if ranks != run.cell["chips"]:
        fail(f"traffic {run.cell['traffic']} runs {ranks} ranks, the cell "
             f"asks for {run.cell['chips']} chips")
    if ranks == 1:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        outs = [jobs.JOBS[run.traffic["job"]](run)]
    else:
        outs = spawn_ranks(args, ranks, device)
    setup_s = outs[0]["window_start"] - T_START
    found = forbidden_modules()
    if found:
        fail(f"the process holds {found} after the window")
    out = outs[0]
    peak = max(o["memory_peak_bytes"] for o in outs)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.write_scene()  # the OBJ paths, for the reference
    t_check = time.time()
    numbers = check.CHECKS[run.traffic["job"]](run, out)
    q = np.quantile(np.asarray(out["unit_s"]) * 1e3, [0.1, 0.5, 0.9])
    print(f"benchmark: window {out['window_s']:.3f} s, {out['work']} done "
          f"in {len(out['unit_s'])} chunks or steps (ms p10 {q[0]:.3f} p50 "
          f"{q[1]:.3f} p90 {q[2]:.3f}); the check took "
          f"{time.time() - t_check:.1f} s", file=sys.stderr)
    limits = cells.limits(run.cell["name"])
    checks = {k: dict(value=v, limit=limits[k]["limit"])
              for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    metrics = {}
    ctx = dict(outs=outs, out=out, setup_s=setup_s)
    for m in cells.metrics(run.cell, args.trace):
        value = cells.metric(m["name"]).read(run, ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=ranks, memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=out["work"], failed=0,
                  metrics=metrics, device=dev)
    if args.trace:
        traces = [o["trace"] for o in outs]
        dev["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        dev["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = dict(device_ops=out["trace"]["device_ops"],
                                   idle_gaps=out["trace"]["idle_gaps"])
    result["checks"] = checks
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank-dir", help=argparse.SUPPRESS)
    p.add_argument("--fault", help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    try:
        import pathtrace_tpu_torch  # noqa: F401
        import torch
    except ImportError as e:
        fail(f"cannot import the program: {e}", 2)
    from benchmark.harness.cells import Cells

    cells = Cells(ROOT)
    if args.rank_dir:
        return rank_main(args, cells)
    chips = cells.cell(args.workload)["chips"]
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} cards, {torch.cuda.device_count()} "
             f"found")
    result = measure(args, cells, torch.device("cuda", 0), args.fault)
    found = forbidden_modules()
    if found:
        fail(f"the process holds {found} after the window")
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
