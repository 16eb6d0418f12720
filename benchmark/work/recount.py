"""Recounts the frozen work of configurations for the rooflines:

    python benchmark/work/recount.py <config> [<config> ...] [--out DIR]

For each configuration, one sample (iteration 1) of the reference tracer
at the configuration's full size, on the card when there is one, under
``reference/bound.count_work`` (the frozen copy of the port's count):
the float operations each section needs on the lanes that need it, and
the bytes of the tables (each read once) and of the image written (12 B
a pixel).  ``k1`` is K1's work without NEE and ``k1.nee`` with it;
``k8.nee`` is what K8's NEE sweep needs beside K1's (``bound.k8_extra``).
It writes ``<DIR>/<config>.json`` (default: ``benchmark/work``).  Only a
change that may change the benchmark recounts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import scenes  # noqa: E402
from benchmark.harness.cells import Cells  # noqa: E402
from benchmark.reference import bound as B  # noqa: E402
from benchmark.reference import tables as RT  # noqa: E402
from benchmark.reference import tracer as RTR  # noqa: E402

IT0 = 1


def table_bytes(tab):
    """The scene tables' bytes, each read once: every table but the mesh
    rows (counted by the rows read), and the int tables the kernel gets
    (types, bvh_meta, charts)."""
    n = sum(tab[k].numel() * tab[k].element_size()
            for k in ("cam", "mats", "gmat", "lights") if tab[k] is not None)
    return n + 4 * (len(tab["geom_types"]) * (1 + 6)
                    + 5 * len(tab["bvh_meta"]))


def count(tab, n_pix):
    """(ops, bytes, ops by section, bytes by table, the lanes of K8's
    section adjoints, the sample's live counts) of one sample."""
    tallies = {}
    (_, counts), ops_by, bytes_by = B.count_work(
        lambda: RTR.trace(tab, IT0, 1, walk="skip"), tallies)
    n_bytes = table_bytes(tab) + sum(bytes_by.values()) + 12 * n_pix
    return (sum(ops_by.values()), n_bytes, ops_by, bytes_by, tallies,
            [int(c) for c in counts.tolist()])


def recount(cfg, scene_dir, device):
    _, objs = scenes.write_scene(cfg, scene_dir)
    scene = RT.scene_from_config(cfg, objs)
    n_pix = scene.pixel_count
    out = dict(config=cfg["name"], iteration=IT0, width=scene.width,
               height=scene.height, depth=scene.depth,
               peaks=dict(flops=B.PEAK_FLOPS, bytes_per_s=B.PEAK_BYTES))
    for key, nee in (("k1", False), ("k1.nee", True)):
        tab = RT.pack(scene, device=device, nee=nee)
        t0 = time.time()
        ops, n_bytes, ops_by, bytes_by, tallies, counts = count(tab, n_pix)
        out[key] = dict(ops=ops, bytes=n_bytes, ops_by_section=ops_by,
                        bytes_by_table=bytes_by, live_counts=counts,
                        bound_ms=B.bound(ops, n_bytes)[0],
                        bound_by=B.bound(ops, n_bytes)[1])
        print(f"{cfg['name']} {key}: {ops:.6g} ops, {n_bytes} bytes, bound "
              f"{out[key]['bound_ms']:.6f} ms by {out[key]['bound_by']} "
              f"({time.time() - t0:.1f} s)", flush=True)
        if nee:
            n_tab = sum(tab[k].numel() for k in ("cam", "mats", "gmat",
                                                 "lights"))
            ops8, bytes8 = B.k8_extra(counts, n_pix, n_tab, True,
                                      mesh=bool(tab["bvh_meta"]),
                                      tallies=tallies)
            out["k8.nee"] = dict(ops=ops8, bytes=bytes8, table_floats=n_tab)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("configs", nargs="+")
    p.add_argument("--out", default=str(ROOT / "benchmark" / "work"))
    args = p.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cells = Cells(ROOT)
    for name in args.configs:
        cfg = cells.config(name)
        res = recount(cfg, cells.dir / ".cache" / "scenes" / name, device)
        Path(args.out).mkdir(parents=True, exist_ok=True)
        with open(Path(args.out) / f"{name}.json", "w") as f:
            json.dump(res, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
