#!/usr/bin/env python3
"""Does ``chip_smoke.py``'s hold of K8 against its plain version catch a
wrong adjoint?  A mutation check on the card.

    python3 tests/torch_k8_faults.py [fault ...]

Each fault of ``FAULTS`` changes one line of the reverse sweep in
``pathtrace_tpu_torch/csrc/megakernel.cu``, in a copy of the sources in a
temporary directory (the checkout is never touched): a section adjoint
with its sign turned.  The fault's K8 build (with NEE) is compiled from
that copy, every fault's at once, and ``chip_smoke.k8_vs_plain`` holds it
against the plain version on the fault's configuration of
``chip_smoke.K8_SECTION_CONFIGS``, at 64x64 depth 4 and at the
configuration's own size, exactly as ``chip_smoke.py`` holds the true
build.  A fault is caught at a size where that hold raises on a table
(K8's radiance stays K1's: the forward sweep is not changed).  Prints
each hold's rows and a line a fault and size; exits 1 if a fault passed
a hold, or without a CUDA GPU.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# name: (configuration label in chip_smoke.K8_SECTION_CONFIGS, the line of
# megakernel.cu, the line with the fault)
FAULTS = {
    "bump strength": (
        "cornell_glass bump+SSS", "gadd(gm + 16, g_bk);",
        "gadd(gm + 16, -g_bk);"),
    "lens aperture": (
        "cornell_glass", "g_cam[14] += (g_lc * cth + g_ls * sth) * sq1;",
        "g_cam[14] -= (g_lc * cth + g_ls * sth) * sq1;"),
    "Snell ior": (
        "cornell_glass", "gadd(gm + 9, -g_eta * (eta * eta));",
        "gadd(gm + 9, g_eta * (eta * eta));"),
    "motion velocity": (
        "cornell_checker",
        "for (int i = 0; i < 3; ++i) gadd(tg + 33 + i, gp[i] * time);",
        "for (int i = 0; i < 3; ++i) gadd(tg + 33 + i, -gp[i] * time);"),
}


def mutant(tmp, fault):
    """A copy of ``csrc`` in ``tmp`` with ``fault``'s line changed; returns
    (its csrc, its build directory)."""
    _, line, bad = FAULTS[fault]
    root = os.path.join(tmp, fault.replace(" ", "_"))
    csrc = os.path.join(root, "csrc")
    shutil.copytree(os.path.join(REPO, "pathtrace_tpu_torch", "csrc"), csrc)
    path = os.path.join(csrc, "megakernel.cu")
    with open(path) as f:
        text = f.read()
    if text.count(line) != 1:
        raise RuntimeError(f"{fault}: {line!r} is in megakernel.cu "
                           f"{text.count(line)} times, not once")
    with open(path, "w") as f:
        f.write(text.replace(line, bad))
    return csrc, os.path.join(root, "build")


def use(B, csrc, build_dir):
    """Point the build module at these sources and this build directory."""
    from pathlib import Path

    B.CSRC, B.BUILD_DIR = Path(csrc), Path(build_dir)


def build_one(csrc, build_dir, mask):
    """Child process: K8 of ``mask`` from ``csrc`` into ``build_dir``."""
    sys.path.insert(0, REPO)
    from pathtrace_tpu_torch.ops.cuda import build as B

    use(B, csrc, build_dir)
    B.build_many([B._k8_job(mask)])


def main(names):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import dataclasses

    import chip_smoke as CS
    import torch_gradcheck as GC
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.ops.cuda import build as B
    from pathtrace_tpu_torch.ops.cuda import megakernel as K
    from pathtrace_tpu_torch.ops.cuda import vjp as VJ

    print(f"card: {CS.card_line()}", flush=True)
    configs = {label: (name, edits)
               for label, name, edits in CS.K8_SECTION_CONFIGS}
    scenes = {FAULTS[f][0]: CS.load(ptt, *configs[FAULTS[f][0]])
              for f in names}
    masks = {f: K.scene_mask(scenes[FAULTS[f][0]], True) for f in names}
    tmp = tempfile.mkdtemp(prefix="k8_faults_")
    try:
        # K1 from the true sources (the holds take K1's radiance), each
        # fault's K8 from its copy, every nvcc at once
        t0 = time.perf_counter()
        dirs = {f: mutant(tmp, f) for f in names}
        procs = [subprocess.Popen([sys.executable, __file__, "--build",
                                   *dirs[f], str(masks[f])]) for f in names]
        B.build_many([B._k1_job(m) for m in sorted(set(masks.values()))])
        if any(p.wait() for p in procs):
            raise RuntimeError("a fault's K8 build failed")
        print(f"built K1 {sorted(set(masks.values()))} and the faults' K8: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for m in set(masks.values()):
            B.load_k1(m)
        missed = []
        for f in names:
            label = FAULTS[f][0]
            use(B, *dirs[f])
            B._LIBS.pop(("k8", masks[f]), None)
            scene = scenes[label]
            small = dataclasses.replace(scene, resolution=CS.GRAD_SMALL[0],
                                        trace_depth=CS.GRAD_SMALL[1])
            for full, sc in ((False, small), (True, scene)):
                size = f"{sc.resolution[0]}x{sc.resolution[1]} " \
                       f"d{sc.trace_depth}"
                try:
                    CS.k8_vs_plain(K, VJ, GC, torch, f"fault {f!r}", sc,
                                   True, full)
                except RuntimeError as e:
                    caught = "against the plain version" in str(e)
                    print(f"fault {f!r} (mask {masks[f]}) {label} {size}: "
                          f"{'caught' if caught else 'ERROR'}: {e}",
                          flush=True)
                    if not caught:
                        missed.append((f, size))
                    continue
                print(f"fault {f!r} (mask {masks[f]}) {label} {size}: "
                      f"MISSED, the hold passed", flush=True)
                missed.append((f, size))
            B._LIBS.pop(("k8", masks[f]), None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"faults missed: {missed}", flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build_one(sys.argv[2], sys.argv[3], int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main(sys.argv[1:] or list(FAULTS)))
