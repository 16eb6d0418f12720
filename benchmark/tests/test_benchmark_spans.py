"""The per-layer metrics that read the program's own spans
(``benchmark/harness/spans.py``; ``k1_call_us``, ``prepare_ms``,
``vjp_pack_ms``, ``vjp_chain_ms``): a traced tiny run on the CPU reports
them as positive numbers and no device operation named after a span; an
untraced run reports none of them."""

from __future__ import annotations

import pytest

from benchmark.tests import tiny

SPAN_METRICS = {"cornell.render": ("k1_call_us", "prepare_ms"),
                "cornell.inverse_light": ("vjp_pack_ms", "vjp_chain_ms")}
ALL = {m for ms in SPAN_METRICS.values() for m in ms}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_run_reads_the_spans(root, cell):
    res = tiny.measure(root, cell, trace=1)
    assert res["correct"]
    got = {m: v["value"] for m, v in res["metrics"].items() if m in ALL}
    assert set(got) == set(SPAN_METRICS[cell])
    assert all(v > 0 for v in got.values()), got
    assert not any(name.startswith("ptt.")
                   for name, _ in res["breakdown"]["device_ops"])


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_untraced_run_reads_no_span(root, cell):
    res = tiny.measure(root, cell, trace=0)
    assert res["correct"] and not set(res["metrics"]) & ALL
