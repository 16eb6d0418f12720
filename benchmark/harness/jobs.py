"""The jobs a traffic mix names (``"job"`` in its file), driven through
the program's own entry points, each with its set-up (load, build, warm
up every shape the window runs), its measured window and what it keeps
for the check of ``correct``.

* ``render``: the CLI's render loop (``pathtrace_tpu_torch/cli.py``):
  the route that the CLI's flags (``"cli"`` in the mix) choose, through
  ``cli._engine``, once per image (``megakernel.prepare``); chunks of
  ``--chunk`` samples from iteration ``seed + done + 1``; ``accum += rad``
  and the counts copied to the host after each chunk; the image's end,
  every ``ITERATIONS`` samples (or ``--spp``), copied to the host and
  made ready for display, and the accumulation started again.  With
  ``--shard`` each rank is a process of its own, one a card
  (:func:`render` in each, the decision to stop made by rank 0).
* ``inverse_light``: the loop of ``render/inverse.inverse_light``, its
  defaults in the mix: the target rendered once, then per step a render
  with NEE (K1), the cotangent of the image's mean squared error, the
  light's gradient from ``ops/cuda/vjp.render_vjp`` (K8 and the packing's
  chain) and a capped step; the light put back at its start every
  ``steps`` steps.

A job returns a dict: ``window_start`` (the window's start on the wall
clock: the set-up is the time before it), ``window_s``, ``work`` (the
samples or steps completed in the window), ``unit_s`` (each chunk's or
step's seconds), the program's outputs that the check compares, the
numbers the per-layer metrics read, and the traced window's summary
(``trace.summary``) in a traced run.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import trace as T

clock = time.perf_counter


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --- faults, for the check's own test: the timed path broken underneath ----

def broken(fault, fn):
    """``fn`` (a chunk's ``run(it0, n)``) with ``fault`` planted: ``stale``
    adds nothing to the image, ``half`` renders half the samples and
    doubles them, ``altered`` changes one bounce's count."""
    if fault is None or fault == "no_exchange":
        return fn

    def run(it0, n):
        if fault == "half":
            rad, counts = fn(it0, max(n // 2, 1))
            return rad * (n / max(n // 2, 1)), counts * 2
        rad, counts = fn(it0, n)
        if fault == "stale":
            return torch.zeros_like(rad), counts
        if fault == "altered":
            counts = counts.clone()
            counts[1] += 1
            return rad, counts
        raise ValueError(f"unknown fault {fault!r}")
    return run


# --- render -------------------------------------------------------------------

class Stop:
    """Whether the window is over, decided by rank 0's clock and shared
    with every rank (one small broadcast a chunk) when ``mesh`` is given."""

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.flag = torch.zeros(1, dtype=torch.int32, device=device)

    def __call__(self, over):
        if self.mesh is None:
            return over
        import torch.distributed as dist

        self.flag.fill_(int(over))
        dist.broadcast(self.flag, src=0, group=self.mesh.group)
        return bool(self.flag.item())


def render(run, mesh=None):
    """The ``render`` job on this process's device (a rank's share with
    ``mesh``)."""
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.io import image_io

    scene_path = run.write_scene()
    tl = clock()
    scene = ptt.load_scene(scene_path)
    scene_load_s = clock() - tl
    device = run.device if mesh is None else mesh.device
    args = cli.build_parser().parse_args(
        [scene_path, "--device", device.type] + list(run.traffic["cli"]))
    n_img = args.spp if args.spp is not None else scene.iterations
    width, height = scene.resolution
    sizes = sorted({min(args.chunk, n_img), n_img % args.chunk} - {0})
    accum = torch.zeros((scene.pixel_count, 3), dtype=torch.float32,
                        device=device)
    stop = Stop(mesh, device)
    lead = mesh is None or mesh.rank == 0
    base = run.seed + 1
    # warm-up: an image's start and a chunk of each size the window runs
    _, fn = cli._engine(scene, device, args)
    for step in sizes:
        rad, counts = fn(base, step)
        accum += rad
        counts.cpu()
    image_io.to_display(accum.cpu().numpy(), width, height, 1)
    stop(False)
    _sync(device)

    chunks, image = [], None
    done = image_done = 0
    image_it0 = base
    with T.window(run.trace) as prof:
        # the window starts once the profiler runs: its start-up is set-up
        window_start = time.time()
        t_start = last = clock()
        unit_s = []
        while True:
            if image_done == 0:
                with T.span("prepare"):
                    _, fn = cli._engine(scene, device, args)
                    fn = broken(run.fault, fn)
                    accum.zero_()
                image_it0 = base + done
            step = min(args.chunk, n_img - image_done)
            with T.span("chunk"):
                rad, counts = fn(base + done, step)
            with T.span("accumulate"):
                accum += rad
            with T.span("counts_copy"):
                c = counts.cpu().numpy()
            now = clock()
            unit_s.append(now - last)
            last = now
            chunks.append((base + done, step, c))
            done += step
            image_done += step
            if image_done == n_img:
                if lead:  # as the CLI, rank 0 alone takes the image
                    with T.span("display"):
                        host = accum.cpu().numpy()
                        image_io.to_display(host, width, height, n_img)
                    if device.type == "cpu":  # .cpu() made no copy
                        host = host.copy()
                    image = (image_it0, n_img, host)
                image_done = 0
            if stop(clock() - t_start >= run.seconds):
                break
        _sync(device)
        window_s = clock() - t_start
    if image is None:  # no image finished in the window: the partial one
        image = (image_it0, image_done, accum.cpu().numpy())
    out = dict(window_s=window_s, work=done, window_start=window_start,
               scene_load_s=scene_load_s, chunks=chunks, image=image,
               unit_s=unit_s,
               nee=args.nee, rr=args.rr,
               memory_peak_bytes=_peak(device))
    if prof is not None:
        out["trace"] = T.summary(prof)
    return out


def _peak(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


# --- inverse_light ------------------------------------------------------------

def _with_translation(scene, tr):
    return dataclasses.replace(
        scene, geoms=dataclasses.replace(scene.geoms, translation=tr))


def inverse_light(run, mesh=None):
    """The ``inverse_light`` job."""
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.ops.cuda import megakernel as K
    from pathtrace_tpu_torch.ops.cuda import vjp

    mix = run.traffic
    light, spp, lr, max_step = (mix["light"], mix["spp"], mix["lr"],
                                mix["max_step"])
    device = run.device
    scene_path = run.write_scene()
    tl = clock()
    scene = ptt.load_scene(scene_path)
    scene_load_s = clock() - tl
    n_pix = scene.pixel_count
    it0 = run.seed + 1
    half = run.fault == "half"
    n_run = spp // 2 if half else spp
    target = K.pathtrace_batch_cuda(scene, it0, spp, device=device,
                                    nee=True)[0] / spp
    start = np.asarray(scene.geoms.translation, np.float32).copy()
    start[light] = start[light] + np.asarray(mix["offset"], np.float32)
    vjp_s = [0.0]

    def step(cur, tr):
        with T.span("render"):
            img = K.pathtrace_batch_cuda(cur, it0, n_run, device=device,
                                         nee=True)[0] / n_run
        ct = (img - target) * (2.0 / (n_pix * 3 * n_run))
        with T.span("vjp_call"):
            tv = clock()
            _, g = vjp.render_vjp(cur, ct, it0, n_run, nee=True,
                                  device=device)
            vjp_s[0] += clock() - tv
        with T.span("update"):
            gl = g["translation"][light].to(torch.float64).numpy()
            if run.fault == "altered":
                gl = gl * np.array([-1.0, 1.0, 1.0])
            upd = lr * gl
            norm = np.linalg.norm(upd)
            if norm > max_step:
                upd = upd * (max_step / norm)
            tr = tr.copy()
            if run.fault != "stale":
                tr[light] = (tr[light] - upd).astype(np.float32)
            cur = _with_translation(cur, tr)
        return img, gl, tr, cur

    # the first steps, through the window's own call: the check's, and
    # the warm-up of every shape and of the first (cold) autograd rounds
    tr, cur = start.copy(), _with_translation(scene, start.copy())
    checked = []
    for _ in range(mix["checked_steps"]):
        img, gl, tr, cur = step(cur, tr)
        loss = float(torch.mean((img - target) ** 2))
        checked.append(dict(image=img.cpu().numpy(), loss=loss, grad=gl,
                            position=tr[light].copy()))
    _sync(device)
    vjp_s[0] = 0.0

    k = len(checked)
    steps = 0
    with T.window(run.trace) as prof:
        # the window starts once the profiler runs: its start-up is set-up
        window_start = time.time()
        t_start = last = clock()
        unit_s = []
        while True:
            if k % mix["steps"] == 0:
                tr, cur = start.copy(), _with_translation(scene, start.copy())
            _, _, tr, cur = step(cur, tr)
            k += 1
            steps += 1
            now = clock()
            unit_s.append(now - last)
            last = now
            if clock() - t_start >= run.seconds:
                break
        _sync(device)
        window_s = clock() - t_start
    out = dict(window_s=window_s, work=steps, window_start=window_start,
               scene_load_s=scene_load_s, checked=checked, it0=it0,
               start=start, vjp_call_s=vjp_s[0], unit_s=unit_s,
               memory_peak_bytes=_peak(device))
    if prof is not None:
        out["trace"] = T.summary(prof)
    return out


JOBS = {"render": render, "inverse_light": inverse_light}
