"""The output bits, time and registers of K1 and K5, to compare two
versions of the port on one card.

    python3 tests/torch_digest.py [ROOT] [--time] [--k5-time]
                                  [--regs MASK,MASK,...]
                                  [--sass MASK,MASK,...] [--k8] [--k8-time]
                                  [--k6] [--k7] [--k7-time] [--k9]

For cornell.txt (the build without features, mask 0) and cornell_mesh.txt
(the mesh build, mask 512), each at 96x80, depth 8, 3 samples from
iteration 1, it prints the sha256 of the float32 radiance that
``trace_k1`` returns, first 16 hex digits, and of its int64 counts per
sample (``per_sample=True``).  These are the jobs of the digests that
``test_torch_cuda.py`` pins.  With ``--time`` it prints K1's ms/iter on
``TIMED``: cornell.txt (800x800) alone, with Russian roulette and with
NEE, cornell_tex.txt (800x800), cornell_mesh.txt, cornell_bigmesh.txt (also
at 1 sample a call) and cornell_hugemesh.txt (1920x1080), the files' own
size and depth 8: the median of 9 calls of 8 samples, CUDA events, after
one warm call (the
hugemesh's OBJ, ``scenes/gen_icosphere7.obj``, is made by
``tools/gen_mesh.py 7`` where absent).  With ``--k5-time`` it prints K5's
ms a launch on ``K5_TIMED`` (the sorted engine on cornell.txt and
cornell_mesh.txt, the split engine at 3 on cornell.txt, 1 spp, CUDA
events around each launch, the median of 5 runs).  With ``--regs`` it
first compiles ROOT's
``megakernel.cu`` for each feature mask listed (all ``nvcc`` processes
at once, no link, ROOT's flags) and prints each kernel's registers and
spills as ``-Xptxas -v`` reports them; without ``--time`` it then stops
(and needs only ``nvcc``).  With ``--sass`` it compiles ROOT's
``megakernel.cu`` for each mask listed (``k7:M``, ``k8:M``: the K7 or K8
build of mask M) to a cubin and prints, for each kernel of it, the
sha256 (first 16 hex digits) and the instruction count of its SASS as
``cuobjdump -sass`` prints it: equal digests on two checkouts are the same
machine code.  With ``--k8`` it prints, for each
build of K8 in ``vjp.MASKS`` (all built at once first), the sha256 of
its radiance and of its rounded gradient tables (cam, mats, gmat,
lights, concatenated) at 64x64 d4, 1 spp, iteration 1, under a
cotangent drawn from a numpy seed, on the scene of that build (``K8_JOBS``: cornell, cornell_mesh, cornell_glass,
cornell_checker and the variants of ``scene/variants.py``): these are the
digests that ``test_torch_cuda.py`` pins.  With ``--k8-time`` it prints
each K8 build's ms on its scene at the file's own size, depth 8, 1 spp a
call (``--k8-spp N``: N): the median of 9 calls, CUDA events, after one
warm call, and the device time of each of its kernels.  With
``--k6`` it prints the sha256 of K6's output at ``K6_SIZES`` (0/1 masks
from a numpy seed), checks it against ``cumsum(x) - x``, and prints the
device time a call of K6 and of ``torch.cumsum(x, dtype=int32) - x``
(the kernels alone: ``torch.profiler`` over 50 calls).  With ``--k7`` it
prints, for each job of ``K7_JOBS`` (cornell, mask 0, and cornell_mesh,
mask 512, at 64x64 d4 2 spp and at the file's own size d8 1 spp; cornell
at 32x32 d8 1024 spp, where a block of K7 flushes its table more than
once), the sha256 of K7's radiance, counts and rounded gradient table
under a cotangent drawn from a numpy seed.  With ``--k7-time`` it prints
K7's ms a call (1 spp) on cornell 800x800 and cornell_mesh 1920x1080, d8,
beside K1's on the same tables (1 spp a call): the median of 9 calls, CUDA
events.  With ``--k9`` it prints K9's result on the bigmesh tables for
the bundles of ``K9_BUNDLES`` and its time on the 32x128 bundle: CUDA
events around the call (median of 9) and the kernel alone on the device
(``torch.profiler`` over 50 calls).  ROOT is the root of a checkout whose
``pathtrace_tpu_torch`` and ``scenes/`` are used
(default: this one).  Needs a CUDA GPU.  Imports no JAX.
"""

import argparse
import dataclasses
import hashlib
import os
import statistics
import subprocess
import sys
import tempfile
import time

JOBS = (("cornell", 0), ("cornell_mesh", 512))  # scene file, feature mask
RES, DEPTH, SPP = (96, 80), 8, 3
# (label, scene file, NEE, Russian roulette, samples a call), at the
# files' own size
TIMED = (("cornell", "cornell", False, False, 8),
         ("cornell RR", "cornell", False, True, 8),
         ("cornell NEE", "cornell", True, False, 8),
         ("cornell_tex", "cornell_tex", False, False, 8),
         ("cornell_mesh", "cornell_mesh", False, False, 8),
         ("cornell_bigmesh", "cornell_bigmesh", False, False, 8),
         ("cornell_bigmesh 1 spp", "cornell_bigmesh", False, False, 1),
         ("cornell_hugemesh", "cornell_hugemesh", False, False, 8))
HUGEMESH_OBJ = os.path.join("scenes", "gen_icosphere7.obj")
# (label, scene file, split or None for the sorted engine), the files' size
K5_TIMED = (("sorted cornell", "cornell", None),
            ("sorted cornell_mesh", "cornell_mesh", None),
            ("split cornell s3", "cornell", 3))
K5_RUNS = 5
TIME_SPP, TIME_CALLS = 8, 9
# the kernels of the sources, by the names ptxas reports them under
KERNELS = ("k1_trace", "k5_span", "k6_scan", "k9_probe", "k7_grads",
           "k8_vjp_fwd", "k8_vjp_rev", "k8_vjp", "fx_round")
# K8's builds: (scene file, variants of scene/variants.py, mask without
# NEE); each is run without and with NEE
K8_JOBS = (("cornell", (), 0), ("cornell_mesh", (), 512),
           ("cornell_glass", (), 7), ("cornell_checker", (), 24),
           ("cornell_glass", ("BUMP", "SSS"), 103),
           ("cornell_mesh", ("MESH_GLASS", "MESH_MOTION"), 537),
           ("cornell_mesh", ("MESH_BUMP",), 544))
K8_RES, K8_DEPTH = (64, 64), 4
K8_TIME_DEPTH, K8_TIME_CALLS = 8, 9
# K8's kernels, by the names the profiler reports: the parent's one kernel
# holds "k8_vjp"
K8_KERNELS = ("k8_vjp_fwd", "k8_vjp_rev", "k8_vjp", "fx_round")
K6_SIZES = (640000, 2073600, 5000, 16200)
# K7: (scene file, mask, resolution or None for the file's, depth, spp)
K7_JOBS = (("cornell", 0, (64, 64), 4, 2), ("cornell", 0, None, 8, 1),
           ("cornell", 0, (32, 32), 8, 1024),
           ("cornell_mesh", 512, (64, 64), 4, 2),
           ("cornell_mesh", 512, None, 8, 1))
K7_TIMED = (("cornell", 0), ("cornell_mesh", 512))
K9_BUNDLES = ((32, 128), (1, 32), (2, 40))


def digest(rad):
    """sha256 of a float32 tensor's bytes, first 16 hex digits."""
    return hashlib.sha256(rad.cpu().numpy().tobytes()).hexdigest()[:16]


def form(mangled):
    """The form of a template kernel its mangled name shows: "<true>" (K1's
    per-sample form), "<counting>" (K1's and K8's counting forms), both or
    neither."""
    return ("<true>" if "ILb1E" in mangled else "") + (
        "<counting>" if "JyE" in mangled else "")


def ptxas_usage(log):
    """{kernel: "registers ... | spills"} from nvcc's ``-Xptxas -v``
    output: a kernel of KERNELS under its own name, any other under its
    mangled one."""
    usage, fn, spill = {}, None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = next((k for k in KERNELS if k in ln), ln.split("'")[1])
            fn += form(ln)
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and fn:
            usage[fn] = f"{ln.split(':', 1)[1].strip()} | {spill}"
    return usage


def registers(root, masks):
    """Compiles ROOT's megakernel.cu for each mask at once (no link) and
    prints each kernel's registers and spills."""
    from pathtrace_tpu_torch.ops.cuda import build

    csrc = os.path.join(root, "pathtrace_tpu_torch", "csrc")
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(m, subprocess.Popen(
            [build.nvcc_path(), *flags, f"-DPT_FEATURES={m}", "-I", csrc,
             "-c", "-o", os.path.join(tmp, f"m{m}.o"),
             os.path.join(csrc, "megakernel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for m in masks]
        for m, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for mask {m}:\n{log}")
            for fn, usage in ptxas_usage(log).items():
                print(f"regs {root} mask {m} {fn}: {usage}", flush=True)


def sass(root, masks):
    """Compiles ROOT's megakernel.cu for each mask at once to a cubin and
    prints each kernel's SASS digest and instruction count.  A mask
    ``k7:M`` or ``k8:M`` is the K7 (``-DPT_GRAD=1``) or K8
    (``-DPT_VJP=1``) build of mask M."""
    from pathtrace_tpu_torch.ops.cuda import build

    csrc = os.path.join(root, "pathtrace_tpu_torch", "csrc")
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    dump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    grad = {"k7": ["-DPT_GRAD=1"], "k8": ["-DPT_VJP=1"]}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for m in masks:
            kind, _, bits = str(m).rpartition(":")
            cubin = os.path.join(tmp, f"m{kind}{bits}.cubin")
            procs.append((m, cubin, subprocess.Popen(
                [build.nvcc_path(), *flags, f"-DPT_FEATURES={bits}",
                 *grad.get(kind, []), "-I", csrc, "-cubin", "-o", cubin,
                 os.path.join(csrc, "megakernel.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for m, cubin, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for mask {m}:\n{log}")
            text = subprocess.run([dump, "-sass", cubin], check=True,
                                  capture_output=True, text=True).stdout
            for part in text.split("Function : ")[1:]:
                name = part.splitlines()[0].strip()
                fn = next((k for k in KERNELS if k in name), name)
                fn += form(name)
                # the instruction lines, "/*0010*/ OP ... ;", each
                # followed by its encoding, "/* 0x... */", their runs of
                # spaces as one (cuobjdump's padding of the columns moves
                # with the rest of the cubin)
                code = [" ".join(ln.split()) for ln in part.splitlines()
                        if ln.strip().startswith("/*")
                        and not ln.strip().startswith("/* 0x")]
                h = hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]
                print(f"sass {root} mask {m} {fn}: {h} ({len(code)} "
                      f"instructions)", flush=True)


def k1_times(root, torch, ptt, K):
    """K1's ms/iter on the TIMED scenes, median of TIME_CALLS calls."""
    obj = os.path.join(root, HUGEMESH_OBJ)
    if not os.path.exists(obj):
        subprocess.run([sys.executable, os.path.join(root, "tools",
                                                     "gen_mesh.py"), "7", obj],
                       check=True, stdout=subprocess.DEVNULL)
    for label, name, nee, rr, spp in TIMED:
        scene = ptt.load_scene(os.path.join(root, "scenes", f"{name}.txt"))
        scene = dataclasses.replace(scene, trace_depth=DEPTH)
        job = K.prepare(scene, "cuda", nee=nee, rr=rr)
        K.trace_k1(job, 1, spp)
        runs = []
        for _ in range(TIME_CALLS):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            K.trace_k1(job, 1, spp)
            stop.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(stop) / spp)
        width, height = scene.resolution
        print(f"k1 {label} {width}x{height} d{DEPTH} ({root}): "
              f"{statistics.median(runs):.4f} ms/iter, runs "
              f"{[round(t, 4) for t in runs]}", flush=True)


def k5_times(root, torch, ptt, K, label=None):
    """K5's ms a launch on the K5_TIMED engines, 1 spp: CUDA events
    around each launch (``span.EVENTS``), the median of K5_RUNS runs."""
    from pathtrace_tpu_torch.ops.cuda import span as SP

    for name, scene_file, split in K5_TIMED:
        scene = ptt.load_scene(os.path.join(root, "scenes",
                                            f"{scene_file}.txt"))
        scene = dataclasses.replace(scene, trace_depth=DEPTH)
        job = K.prepare(scene, "cuda")
        run = SP.engine(scene, job, split, split is None)[1]
        run(1, 1)
        runs = []
        try:
            for _ in range(K5_RUNS):
                SP.EVENTS = []
                run(1, 1)
                torch.cuda.synchronize()
                spans = [a.elapsed_time(b) for n, a, b in SP.EVENTS
                         if n == "span"]
                runs.append(sum(spans) / len(spans))
        finally:
            SP.EVENTS = None
        width, height = scene.resolution
        # the kernel alone: the events around a launch also hold the host's
        # wait where the engine's loop is host-bound
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(1, 1)
            torch.cuda.synchronize()
        dev = [(getattr(e, "device_time_total", 0) or
                getattr(e, "cuda_time_total", 0), e.count)
               for e in prof.key_averages() if "k5_span" in e.key]
        dev_ms = sum(t for t, _ in dev) / max(sum(n for _, n in dev), 1) / 1e3
        print(f"k5 {name} {width}x{height} d{DEPTH} ({label or root}): "
              f"{statistics.median(runs):.4f} ms a launch ({len(spans)} "
              f"an iteration), runs {[round(t, 4) for t in runs]}; on the "
              f"device alone {dev_ms:.4f} ms a launch", flush=True)


def k8_scenes(root, ptt, K):
    """(scene, NEE, mask) of each K8 build of K8_JOBS, at the file's own
    size."""
    from pathtrace_tpu_torch.scene import variants

    out = []
    for name, edits, mask in K8_JOBS:
        with open(os.path.join(root, "scenes", f"{name}.txt")) as f:
            text = variants.edit_text(
                f.read(), [getattr(variants, e) for e in edits])
        scene = ptt.parse_scene(text, base_dir=os.path.join(root, "scenes"))
        for nee in (False, True):
            want = mask | (K.NEE_BIT if nee else 0)
            if K.scene_mask(scene, nee) != want:
                raise RuntimeError(f"{name} {edits}: mask "
                                   f"{K.scene_mask(scene, nee)}, want {want}")
            out.append((scene, nee, want))
    return out


def k8_digest(torch, K, VJ, scene, nee, mask):
    """(radiance digest, tables digest) of K8's build ``mask`` on
    ``scene`` at K8_RES, K8_DEPTH, 1 spp, under a cotangent drawn from
    numpy seed ``mask``; checks that it launched once."""
    import numpy as np

    scene = dataclasses.replace(scene, resolution=K8_RES,
                                trace_depth=K8_DEPTH)
    job = K.prepare(scene, "cuda", nee=nee)
    ct = torch.from_numpy(np.random.RandomState(mask).rand(
        scene.pixel_count, 3).astype(np.float32)).cuda()
    VJ.LAUNCHES.clear()
    rad, tabs = VJ.trace_k8(job, 1, 1, ct)
    torch.cuda.synchronize()
    if dict(VJ.LAUNCHES) != {mask: 1}:
        raise RuntimeError(f"K8 launches {dict(VJ.LAUNCHES)}, want one of "
                           f"mask {mask}")
    return digest(rad), digest(torch.cat([t.reshape(-1) for t in tabs]))


def k8_digests(root, torch, ptt, K, VJ, masks):
    """The digests of K8's radiance and rounded tables, each build of
    ``masks``."""
    seen = set()
    for scene, nee, mask in k8_scenes(root, ptt, K):
        if mask not in masks:
            continue
        rad, tabs = k8_digest(torch, K, VJ, scene, nee, mask)
        seen.add(mask)
        print(f"k8 digest mask {mask} {K8_RES[0]}x{K8_RES[1]} d{K8_DEPTH} "
              f"({VJ.__file__}): rad {rad} tables {tabs}", flush=True)
    if seen != set(masks):
        raise RuntimeError(f"K8 builds {sorted(seen)}, vjp.MASKS "
                           f"{sorted(VJ.MASKS)}")


def k8_times(root, torch, ptt, K, VJ, masks, label=None, spp=1):
    """Each K8 build of ``masks``: its ms at its scene's own size, ``spp``
    samples a call, printed under ``label`` (default: ``root``), and the
    device time of each of its kernels a call (:data:`K8_KERNELS`; the
    profiler's window runs the counting forms in its first call of 10)."""
    for scene, nee, mask in k8_scenes(root, ptt, K):
        if mask not in masks:
            continue
        scene = dataclasses.replace(scene, trace_depth=K8_TIME_DEPTH)
        job = K.prepare(scene, "cuda", nee=nee)
        ct = torch.ones((scene.pixel_count, 3), device="cuda")
        args = (job, 1, spp, ct)
        VJ.trace_k8(*args)
        runs = []
        for _ in range(K8_TIME_CALLS):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            VJ.trace_k8(*args)
            stop.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(stop))
        width, height = scene.resolution
        print(f"k8 time mask {mask} {width}x{height} d{K8_TIME_DEPTH} "
              f"{spp}spp ({label or root}): {statistics.median(runs):.4f} ms,"
              f" runs {[round(t, 4) for t in runs]}", flush=True)
        split = device_split(torch, lambda: VJ.trace_k8(*args), 10,
                             K8_KERNELS)
        print(f"k8 device mask {mask} {width}x{height} d{K8_TIME_DEPTH} "
              f"{spp}spp ({label or root}): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items()) + " ms a call",
              flush=True)


def device_ms(torch, fn, calls=50, name=None):
    """The device time of ``fn``'s kernels (those whose name holds
    ``name``, if given), ms a call (torch.profiler)."""
    return device_split(torch, fn, calls, (name or "",))[name or ""]


def device_split(torch, fn, calls, names):
    """{name: the device time of ``fn``'s kernels whose name holds it, ms
    a call} (torch.profiler, one window of ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {n: sum(getattr(e, "device_time_total", 0) or
                   getattr(e, "cuda_time_total", 0)
                   for e in events if n in e.key) / calls / 1e3
            for n in names}


def k7_job(root, torch, ptt, K, MG, name, res, depth):
    """(job, material table, geoms' materials, cotangent) of K7 on
    ``name`` at ``res`` (None: the file's) and ``depth``."""
    import numpy as np

    scene = ptt.load_scene(os.path.join(root, "scenes", f"{name}.txt"))
    scene = dataclasses.replace(scene, trace_depth=depth,
                                resolution=res or scene.resolution)
    ct = torch.from_numpy(np.random.RandomState(depth).rand(
        scene.pixel_count, 3).astype(np.float32)).cuda()
    return (K.prepare(scene, "cuda"), MG.material_table(scene, "cuda"),
            tuple(int(m) for m in scene.geoms.material_id), ct)


def k7_digests(root, torch, ptt, K, MG):
    """The digests of K7's radiance, counts and rounded table on
    K7_JOBS."""
    for name, mask, res, depth, spp in K7_JOBS:
        job, mtab, mat_of, ct = k7_job(root, torch, ptt, K, MG, name, res,
                                       depth)
        MG.LAUNCHES.clear()
        rad, counts, tab = MG.trace_k7(job, mtab, mat_of, ct, 1, spp)
        torch.cuda.synchronize()
        if dict(MG.LAUNCHES) != {mask: 1}:
            raise RuntimeError(f"K7 launches {dict(MG.LAUNCHES)}, want one "
                               f"of mask {mask}")
        print(f"k7 digest mask {mask} {name} {job['width']}x{job['height']} "
              f"d{depth} {spp}spp ({MG.__file__}): rad {digest(rad)} counts "
              f"{digest(counts)} table {digest(tab)}", flush=True)


def events_ms(torch, fn, calls):
    """The median over ``calls`` calls of ``fn``'s CUDA-event time, after
    one warm call, and the runs."""
    fn()
    runs = []
    for _ in range(calls):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop))
    return statistics.median(runs), runs


def k7_times(root, torch, ptt, K, MG):
    """K7's ms a call of one sample on K7_TIMED at the files' own size,
    d8, beside K1's on the same tables."""
    for name, mask in K7_TIMED:
        job, mtab, mat_of, ct = k7_job(root, torch, ptt, K, MG, name, None,
                                       8)
        k7, runs = events_ms(
            torch, lambda: MG.trace_k7(job, mtab, mat_of, ct, 1, 1),
            TIME_CALLS)
        k1, _ = events_ms(torch, lambda: K.trace_k1(job, 1, 1),
                          TIME_CALLS)
        print(f"k7 time mask {mask} {name} {job['width']}x{job['height']} d8 "
              f"1spp ({root}): {k7:.4f} ms, runs "
              f"{[round(t, 4) for t in runs]}; k1 {k1:.4f} ms; k7 / k1 "
              f"{k7 / k1:.3f}", flush=True)


def k9_report(root, torch, ptt, K):
    """K9's result on the bigmesh tables for K9_BUNDLES, and its time on
    the first."""
    from pathtrace_tpu_torch.ops.cuda import probe as P

    scene = ptt.load_scene(os.path.join(root, "scenes",
                                        "cornell_bigmesh.txt"))
    tri, nodes, meta = K.pack_mesh(scene, "cuda")
    for bundle in K9_BUNDLES:
        got = P.probe_k9(nodes, tri, meta[0], *bundle)
        want = P.probe_plain(nodes, tri, meta[0], *bundle)
        print(f"k9 result {bundle[0]}x{bundle[1]} ({root}): (n, "
              f"steps, leaves, tsum) {got}, plain {want}", flush=True)
        if got != want:
            raise RuntimeError(f"K9 {bundle}: {got} != plain {want}")

    def call():
        return P.probe_k9(nodes, tri, meta[0])

    res = call()
    ms, runs = events_ms(torch, call, TIME_CALLS)
    dev = device_ms(torch, call, name="k9_probe")
    print(f"k9 time {P.BUNDLE[0]}x{P.BUNDLE[1]} ({root}): "
          f"around the call {ms:.4f} ms, runs "
          f"{[round(t, 4) for t in runs]}; device alone {dev:.5f} ms; "
          f"{res[1]} steps, {res[2]} leaves: {1e3 * dev / res[1]:.4f} us "
          f"a step", flush=True)


def k6_digests(root, torch):
    """K6's output at K6_SIZES, against cumsum(x) - x."""
    import numpy as np
    from pathtrace_tpu_torch.ops import scan as SC

    for n in K6_SIZES:
        x = torch.from_numpy((np.random.RandomState(n).rand(n) < 0.4).astype(
            np.int32)).cuda()
        got = SC.scan_int(x)
        want = torch.cumsum(x, 0, dtype=torch.int32) - x
        print(f"k6 digest n={n} ({SC.__file__}): {digest(got)}, equal to "
              f"cumsum(x) - x {torch.equal(got, want)}", flush=True)
        if not torch.equal(got, want):
            raise RuntimeError(f"K6 at {n} is not cumsum(x) - x")
        dev = [device_ms(torch, fn) for fn in (
            lambda: SC.scan_int(x),
            lambda: torch.cumsum(x, 0, dtype=torch.int32) - x)]
        print(f"k6 device n={n}: K6 {dev[0]:.5f} ms a call, "
              f"torch.cumsum(x, dtype=int32) - x {dev[1]:.5f} ms",
              flush=True)


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("root", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--time", action="store_true")
    p.add_argument("--k5-time", action="store_true")
    p.add_argument("--regs", default="")
    p.add_argument("--sass", default="")
    p.add_argument("--k8", action="store_true")
    p.add_argument("--k8-time", action="store_true")
    p.add_argument("--k8-spp", type=int, default=1)
    p.add_argument("--k6", action="store_true")
    p.add_argument("--k7", action="store_true")
    p.add_argument("--k7-time", action="store_true")
    p.add_argument("--k9", action="store_true")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.regs:
        registers(root, [int(m) for m in args.regs.split(",")])
    if args.sass:
        sass(root, args.sass.split(","))
    if (args.regs or args.sass) and not (
            args.time or args.k8 or args.k6 or args.k8_time or args.k5_time
            or args.k7 or args.k7_time or args.k9):
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_digest: needs a CUDA GPU", file=sys.stderr)
        return 2
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.ops.cuda import megakernel as K
    from pathtrace_tpu_torch.ops.cuda import vjp as VJ

    for name, mask in JOBS:
        scene = ptt.load_scene(os.path.join(root, "scenes", f"{name}.txt"))
        scene = dataclasses.replace(scene, resolution=RES, trace_depth=DEPTH)
        K.LAUNCHES.clear()
        job = K.prepare(scene, "cuda")
        rad, _ = K.trace_k1(job, 1, SPP)
        _, counts = K.trace_k1(job, 1, SPP, per_sample=True)
        torch.cuda.synchronize()
        if dict(K.LAUNCHES) != {mask: 2}:
            raise RuntimeError(f"{name}: launches {dict(K.LAUNCHES)}, want "
                               f"two of mask {mask}")
        print(f"digest {name} {RES[0]}x{RES[1]} d{DEPTH} {SPP}spp mask "
              f"{mask} ({K.__file__}): {digest(rad)} counts "
              f"{digest(counts)}", flush=True)
    if args.time:
        k1_times(root, torch, ptt, K)
    if args.k5_time:
        k5_times(root, torch, ptt, K)
    masks = list(VJ.MASKS)
    if args.k8 or args.k8_time:
        from pathtrace_tpu_torch.ops.cuda import build

        t0 = time.perf_counter()
        logs = {}
        build.build_kernels((), k8_masks=masks, logs=logs)  # nvcc at once
        print(f"build K8 masks {masks} ({root}): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for m in masks:
            sec, log = logs.get(f"k8_m{m}", (0.0, ""))
            for fn, usage in ptxas_usage(log).items():
                print(f"regs {root} k8 mask {m} {fn}: {usage} (build "
                      f"{sec:.2f} s)", flush=True)
    if args.k8:
        k8_digests(root, torch, ptt, K, VJ, masks)
    if args.k8_time:
        k8_times(root, torch, ptt, K, VJ, masks, spp=args.k8_spp)
    if args.k6:
        k6_digests(root, torch)
    if args.k7 or args.k7_time:
        from pathtrace_tpu_torch.ops.cuda import matgrad as MG

        if args.k7:
            k7_digests(root, torch, ptt, K, MG)
        if args.k7_time:
            k7_times(root, torch, ptt, K, MG)
    if args.k9:
        k9_report(root, torch, ptt, K)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
