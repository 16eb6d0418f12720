"""A tiny copy of the benchmark for the CPU tests: the checkout's
``BENCHMARK.json`` and ``benchmark/`` in a temporary root beside a link
to the program, its configurations cut to a few pixels and bounces (the
mesh to a level-1 icosphere) and its mixes to few samples."""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def make_root(tmp, res=(16, 12), depth=3, iterations=16, spp=2):
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(REPO / "pathtrace_tpu_torch", root / "pathtrace_tpu_torch")
    from benchmark.harness import meshes

    level = 1
    text = meshes.obj_text(*meshes.icosphere(level))
    for p in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg["camera"].update(res=list(res), depth=depth,
                             iterations=iterations)
        for o in cfg["objects"]:
            if o["shape"] == "mesh":
                o["obj"] = dict(generator="icosphere", level=level,
                                sha256=hashlib.sha256(
                                    text.encode()).hexdigest())
        p.write_text(json.dumps(cfg))
    for p in (root / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        if "spp" in mix:
            mix["spp"] = spp
        p.write_text(json.dumps(mix))
    return root


# scenes/cornell_glass.txt's glass (Schlick, IOR 1.5) and imperfect
# specular (SPECEX 64, REFL .6) materials, its two spheres and its lens
GLASS = dict(rgb=[0.98, 0.98, 0.98], specex=0.0, specrgb=[0.98, 0.98, 0.98],
             refl=0.0, refr=1.0, refrior=1.5, emittance=0.0)
IMPERFECT = dict(rgb=[0.6, 0.7, 0.95], specex=64.0,
                 specrgb=[0.95, 0.95, 0.95], refl=0.6, refr=0.0,
                 refrior=0.0, emittance=0.0)
GLASS_SPHERE = dict(shape="sphere", trans=[-1.5, 2.0, 1.0],
                    rotat=[0.0, 0.0, 0.0], scale=[3.0, 3.0, 3.0])
IMPERFECT_SPHERE = dict(shape="sphere", trans=[2.5, 6.5, -3.0],
                        rotat=[0.0, 0.0, 0.0], scale=[2.5, 2.5, 2.5])
LENS = dict(aperture=0.25, focal=11.5)


def glass_config(cfg):
    """``cfg`` (cornell or cornell_bigmesh) with glass, an imperfect
    specular sphere and a thin lens: its box (objects 0-5) kept, its mesh
    made glass (or, without one, its sphere replaced by the glass
    sphere), the SPECEX-64 sphere added, the lens opened."""
    cfg = json.loads(json.dumps(cfg))
    cfg["name"] += "_glass"
    cfg["camera"].update(LENS)
    mats = cfg["materials"][:4] + [dict(GLASS), dict(IMPERFECT)]
    box = cfg["objects"][:6]
    glass = [o for o in cfg["objects"][6:] if o["shape"] == "mesh"] or \
        [dict(GLASS_SPHERE)]
    cfg["materials"] = mats
    cfg["objects"] = box + [dict(o, material=4) for o in glass] + [
        dict(IMPERFECT_SPHERE, material=5)]
    return cfg


def run_module(root):
    """``run.py`` of the tiny root, as a module."""
    spec = importlib.util.spec_from_file_location(
        "ptbench_tiny_run", root / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root, workload, seed=3000000001, seconds=0.5, trace=0,
            fault=None):
    """One run of ``workload`` in the tiny root on the CPU: the result
    line's dict."""
    import torch

    from benchmark.harness.cells import Cells

    mod = run_module(root)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace, fault=fault)
    return mod.measure(args, Cells(root), torch.device("cpu"), fault)
