"""The harness on the CPU: what it imports, that it finds a new
configuration, traffic mix, metric and cell by name with no edit, the
idle arithmetic, ``BENCHMARK.json`` against the benchmark's contract, and
(marked ``cuda``, on a card only) one short run of a cell."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest
import torch

from benchmark.harness import trace
from benchmark.harness.cells import Cells
from benchmark.tests import tiny

BENCH = tiny.REPO / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "pathtrace_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_what_a_run_imports_holds_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import jobs, check, trace, cells, scenes\n"
        "from benchmark.reference import tracer, tables, bound\n"
        "import pathtrace_tpu_torch, pathtrace_tpu_torch.cli\n"
        "from pathtrace_tpu_torch.ops.cuda import megakernel, vjp, span\n"
        "from pathtrace_tpu_torch.parallel import shard\n"
        "from pathtrace_tpu_torch.io import image_io\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
        % (str(tiny.REPO), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole(tmp_path):
    mod = tiny.run_module(tiny.make_root(tmp_path))
    sys.modules["pathtrace_tpu_torch_like"] = sys
    try:
        assert "pathtrace_tpu" not in mod.forbidden_modules()
    finally:
        del sys.modules["pathtrace_tpu_torch_like"]


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a metric, limits and a cell, added as new
    files and entries in a copy, run with no edit to an existing file."""
    root = tiny.make_root(tmp_path)
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "cornell.json").read_text())
    cfg["name"] = "cornell_far"
    cfg["camera"]["eye"] = [0.0, 5.0, 12.0]
    (b / "configs" / "cornell_far.json").write_text(json.dumps(cfg))
    (b / "traffic" / "render_nee.json").write_text(json.dumps(
        dict(job="render", cli=["--chunk", "4", "--nee"], ranks=1)))
    (b / "metrics" / "chunks_done.py").write_text(
        'LAYER = "CLI driver (cli.py)"\nMOVES = "ms_per_spp"\n\n\n'
        'def read(run, ctx):\n    return len(ctx["out"]["chunks"])\n')
    (b / "limits" / "cornell_far.render_nee.json").write_text(
        (b / "limits" / "cornell.render.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="cornell_far", source="x",
                                file="benchmark/configs/cornell_far.json",
                                reduced=[], why="x"))
    spec["workloads"].append(dict(name="cornell_far.render_nee",
                                  config="cornell_far", traffic="render_nee",
                                  chips=1, why="x"))
    for m in spec["end_to_end"]:
        if m["name"] == "ms_per_spp":
            m["workloads"].append("cornell_far.render_nee")
    spec["per_layer"].append(dict(
        name="chunks_done", unit="chunks", better="higher",
        source="program_counter", layer="CLI driver (cli.py)",
        moves="ms_per_spp", workloads=["cornell_far.render_nee"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cells = Cells(root)
    assert cells.config("cornell_far")["camera"]["eye"][2] == 12.0
    assert cells.traffic("render_nee")["cli"][-1] == "--nee"
    res = tiny.measure(root, "cornell_far.render_nee", trace=1)
    assert res["correct"]
    assert res["metrics"]["chunks_done"]["value"] >= 1
    res = tiny.measure(root, "cornell_far.render_nee")
    assert res["correct"] and set(res["metrics"]) == {"ms_per_spp",
                                                       "setup_s"}


def test_union_of_intervals():
    busy, merged = trace.union([(5, 7), (0, 2), (1, 3), (6, 6.5), (9, 10)])
    assert busy == 3 + 2 + 1
    assert merged == [(0, 3), (5, 7), (9, 10)]
    assert trace.gaps(merged, -1, 12) == [(-1, 0), (3, 5), (7, 9), (10, 12)]
    assert trace.gaps(merged, 1, 6) == [(3, 5)]
    # idle share of a synthetic window: 6 of 13 busy
    assert 100 * (1 - busy / 13) == pytest.approx(53.846, abs=1e-3)


def test_file_names_are_not_the_tier1_tests():
    ours = {p.name for p in (BENCH / "tests").glob("*.py")}
    theirs = {p.name for p in (tiny.REPO / "tests").rglob("*.py")}
    assert not (ours - {"__init__.py"}) & theirs


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head|expert")


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) < 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch") and (tiny.REPO / p).is_dir()
    assert all(not w.startswith("/") and ".." not in w
               for w in spec["command"])
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (tiny.REPO / c["file"]).is_file()
        assert c["file"].startswith(tuple(spec["paths"]))
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        names.add(c["name"])
    cells = spec["workloads"]
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["config"] in names and c["chips"] in (1, 4)
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert 1 <= len(c["why"]) <= 200
        assert (BENCH / "traffic" / f"{c['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{c['name']}.json").is_file()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= {c["name"] for c in cells} \
            if "workloads" in m else True
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in cells:
        mine = [m for m in spec["end_to_end"]
                if c["name"] in m.get("workloads", [c["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(c["name"] in m.get("workloads", [c["name"]])
                   for m in spec["per_layer"])
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        reader = Cells(tiny.REPO).metric(m["name"])
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
        for c in m.get("workloads", [c["name"] for c in cells]):
            assert c in e2e[m["moves"]].get("workloads", [c])


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cornell.render",
         "--seed", "3000000017", "--seconds", "2", "--trace", "0"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
