"""The output bits, time and registers of K1, to compare two versions of
the port on one card.

    python3 tests/torch_digest.py [ROOT] [--time] [--regs MASK,MASK,...]
                                  [--sass MASK,MASK,...]

For cornell.txt (the build without features, mask 0) and cornell_mesh.txt
(the mesh build, mask 512), each at 96x80, depth 8, 3 samples from
iteration 1, it prints the sha256 of the float32 radiance that
``trace_k1`` returns, first 16 hex digits.  These are the jobs of the
digests that ``test_torch_cuda.py`` pins.  With ``--time`` it prints K1's
ms/iter on cornell.txt (800x800) and cornell_bigmesh.txt (1920x1080), the
files' own size and depth 8: the median of 9 calls of 8 samples, CUDA
events, after one warm call.  With ``--regs`` it first compiles ROOT's
``megakernel.cu`` for each feature mask listed (all ``nvcc`` processes
at once, no link, ROOT's flags) and prints each kernel's registers and
spills as ``-Xptxas -v`` reports them; without ``--time`` it then stops
(and needs only ``nvcc``).  With ``--sass`` it compiles ROOT's
``megakernel.cu`` for each mask listed to a cubin and prints, for each
kernel of it, the sha256 (first 16 hex digits) and the instruction count
of its SASS as ``cuobjdump -sass`` prints it: equal digests on two
checkouts are the same machine code.  ROOT is the root of a checkout whose
``pathtrace_tpu_torch`` and ``scenes/`` are used (default: this one).
Needs a CUDA GPU.  Imports no JAX.
"""

import argparse
import dataclasses
import hashlib
import os
import statistics
import subprocess
import sys
import tempfile

JOBS = (("cornell", 0), ("cornell_mesh", 512))  # scene file, feature mask
RES, DEPTH, SPP = (96, 80), 8, 3
TIMED = ("cornell", "cornell_bigmesh")  # at the files' own size
TIME_SPP, TIME_CALLS = 8, 9
# the kernels of the sources, by the names ptxas reports them under
KERNELS = ("k1_trace", "k5_span", "k6_scan_tiles", "k6_add_offsets",
           "k9_probe", "k7_grads", "k8_vjp", "fx_round")


def digest(rad):
    """sha256 of a float32 tensor's bytes, first 16 hex digits."""
    return hashlib.sha256(rad.cpu().numpy().tobytes()).hexdigest()[:16]


def ptxas_usage(log):
    """{kernel: "registers ... | spills"} from nvcc's ``-Xptxas -v``
    output: a kernel of KERNELS under its own name, any other under its
    mangled one."""
    usage, fn, spill = {}, None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = next((k for k in KERNELS if k in ln), ln.split("'")[1])
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
    prints each kernel's SASS digest and instruction count."""
    from pathtrace_tpu_torch.ops.cuda import build

    csrc = os.path.join(root, "pathtrace_tpu_torch", "csrc")
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    dump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(m, os.path.join(tmp, f"m{m}.cubin"), subprocess.Popen(
            [build.nvcc_path(), *flags, f"-DPT_FEATURES={m}", "-I", csrc,
             "-cubin", "-o", os.path.join(tmp, f"m{m}.cubin"),
             os.path.join(csrc, "megakernel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for m in masks]
        for m, cubin, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for mask {m}:\n{log}")
            text = subprocess.run([dump, "-sass", cubin], check=True,
                                  capture_output=True, text=True).stdout
            for part in text.split("Function : ")[1:]:
                name = part.splitlines()[0].strip()
                fn = next((k for k in KERNELS if k in name), name)
                # the instruction lines, "/*0010*/ OP ... ;", each
                # followed by its encoding, "/* 0x... */"
                code = [ln.strip() for ln in part.splitlines()
                        if ln.strip().startswith("/*")
                        and not ln.strip().startswith("/* 0x")]
                h = hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]
                print(f"sass {root} mask {m} {fn}: {h} ({len(code)} "
                      f"instructions)", flush=True)


def k1_times(root, torch, ptt, K):
    """K1's ms/iter on the TIMED scenes, median of TIME_CALLS calls."""
    for name in TIMED:
        scene = ptt.load_scene(os.path.join(root, "scenes", f"{name}.txt"))
        scene = dataclasses.replace(scene, trace_depth=DEPTH)
        job = K.prepare(scene, "cuda")
        K.trace_k1(**job, it0=1, n_spp=TIME_SPP)
        runs = []
        for _ in range(TIME_CALLS):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            K.trace_k1(**job, it0=1, n_spp=TIME_SPP)
            stop.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(stop) / TIME_SPP)
        width, height = scene.resolution
        print(f"k1 {name} {width}x{height} d{DEPTH} ({root}): "
              f"{statistics.median(runs):.4f} ms/iter, runs "
              f"{[round(t, 4) for t in runs]}", flush=True)


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("root", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--time", action="store_true")
    p.add_argument("--regs", default="")
    p.add_argument("--sass", default="")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.regs:
        registers(root, [int(m) for m in args.regs.split(",")])
    if args.sass:
        sass(root, [int(m) for m in args.sass.split(",")])
    if (args.regs or args.sass) and not args.time:
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_digest: needs a CUDA GPU", file=sys.stderr)
        return 2
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.ops.cuda import megakernel as K

    for name, mask in JOBS:
        scene = ptt.load_scene(os.path.join(root, "scenes", f"{name}.txt"))
        scene = dataclasses.replace(scene, resolution=RES, trace_depth=DEPTH)
        K.LAUNCHES.clear()
        rad, _ = K.trace_k1(**K.prepare(scene, "cuda"), it0=1, n_spp=SPP)
        torch.cuda.synchronize()
        if dict(K.LAUNCHES) != {mask: 1}:
            raise RuntimeError(f"{name}: launches {dict(K.LAUNCHES)}, want "
                               f"one of mask {mask}")
        print(f"digest {name} {RES[0]}x{RES[1]} d{DEPTH} {SPP}spp mask "
              f"{mask} ({K.__file__}): {digest(rad)}", flush=True)
    if args.time:
        k1_times(root, torch, ptt, K)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
