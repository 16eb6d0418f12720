"""Finds what a cell names, by name, in files of its own: nothing here
changes when a later change adds a configuration, a traffic mix, a
per-layer metric, a frozen work count or a cell.

* ``BENCHMARK.json`` at the checkout's root: the cells and the metrics;
* a configuration: the ``file`` its entry names
  (``benchmark/configs/<name>.json``);
* a traffic mix: ``benchmark/traffic/<name>.json``;
* a per-layer metric: ``benchmark/metrics/<name>.py``, which defines
  ``LAYER``, ``MOVES`` and ``read(run)``;
* a configuration's frozen work count: ``benchmark/work/<config>.json``;
* a cell's limits for ``correct``: ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

BENCH_DIR = "benchmark"


class Cells:
    """The benchmark of the checkout at ``root``."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def cell(self, name):
        for c in self.spec["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return _json(self.dir / "traffic" / f"{name}.json")

    def work(self, config):
        path = self.dir / "work" / f"{config}.json"
        return _json(path) if path.exists() else None

    def limits(self, cell):
        return _json(self.dir / "limits" / f"{cell}.json")

    def metric(self, name):
        """The reader module of per-layer metric ``name``."""
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"ptbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, cell, trace):
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics with ``trace`` 0, its per-layer ones with 1 (an entry with
        ``workloads`` only in the cells it lists)."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]


def _json(path):
    with open(path) as f:
        return json.load(f)


class Run:
    """One run of one cell: what the jobs, the check and the metrics
    read."""

    def __init__(self, cells, name, seed, seconds=0.0, trace=0,
                 device=None, fault=None):
        self.cells = cells
        self.cell = cells.cell(name)
        self.config = cells.config(self.cell["config"])
        self.traffic = cells.traffic(self.cell["traffic"])
        self.work_counts = cells.work(self.cell["config"])
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.fault = fault
        # a directory a rank: the ranks write their scene files at once
        self.scene_dir = (cells.dir / ".cache" / "scenes" / self.config["name"]
                          / f"rank{os.environ.get('RANK', 0)}")
        self.obj_paths = {}

    def write_scene(self):
        """Writes the configuration's scene and OBJ files; returns the
        scene file's path (``obj_paths`` then names the OBJ files)."""
        from . import scenes

        path, self.obj_paths = scenes.write_scene(self.config, self.scene_dir)
        return path
