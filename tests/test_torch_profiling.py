"""The program's host spans (``utils/profiling.span``): nothing is kept
and ``record_function`` is never entered when no profiler runs; under a
profiler each span is a ``ptt.<name>`` event and a record with its
parent and ``it``, stamped on the clock of the profiler's raw events;
the spans of ``trace_k1``, ``prepare`` and ``render_vjp``; ``trace``
clears the records of an earlier window."""

import dataclasses

import numpy as np
import torch

from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ
from pathtrace_tpu_torch.utils import profiling

from torch_scenes import load

SLACK_NS = 200_000  # 200 µs


def _tree(records):
    return [(s.name, s.parent, s.it) for s in records]


def _leaves(x):
    """The tensors of a gradient tree (dicts, dataclasses, sequences)."""
    if torch.is_tensor(x):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    elif not isinstance(x, (list, tuple)):
        return []
    return [t for v in x for t in _leaves(v)]


def _events(prof, name):
    """(start, end) ns of the ``ptt.<name>`` events of the profiler's raw
    records, in order."""
    return sorted((e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == f"ptt.{name}")


def test_no_profiler_no_record(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: entered.append(a))
    assert not torch._C._autograd._profiler_enabled()
    before = profiling.spans()
    with profiling.span("outer", 3):
        with profiling.span("inner"):
            pass
    assert entered == [] and profiling.spans() == before


def _nested(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.span("warm"):  # the first record_function's set-up
            pass
        with profiling.span("outer", 7):
            with profiling.span("inner", 7):
                torch.ones(64).sum()
            with profiling.span("inner"):
                pass
        with profiling.span("after"):
            pass
    return prof, profiling.spans()


def test_nested_spans_record_parent_and_it(tmp_path):
    _, rec = _nested(tmp_path)
    assert _tree(rec) == [("warm", -1, None), ("outer", -1, 7),
                          ("inner", 1, 7), ("inner", 1, None),
                          ("after", -1, None)]
    assert all(s.start_ns <= s.end_ns for s in rec)
    assert (tmp_path / "trace.json").is_file()


def test_spans_on_the_profiler_clock(tmp_path):
    """Each record lies inside its own ``ptt.<name>`` event, up to 200 µs
    at either end: the inner spans last some µs, so a clock other than
    the profiler's fails."""
    prof, rec = _nested(tmp_path)
    for name in ("outer", "inner", "after"):
        mine = [s for s in rec if s.name == name]
        events = _events(prof, name)
        assert len(events) == len(mine)
        for s, (e0, e1) in zip(mine, events):
            assert e0 - SLACK_NS <= s.start_ns <= s.end_ns <= e1 + SLACK_NS


def test_trace_clears_an_earlier_window(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.span("first"):
            pass
    assert _tree(profiling.spans()) == [("first", -1, None)]
    with profiling.trace(str(tmp_path), device="cpu"):
        pass
    assert profiling.spans() == []


def test_prepare_and_k1_spans(tmp_path):
    scene = load("cornell", res=(8, 6), depth=2)
    with profiling.trace(str(tmp_path), device="cpu"):
        job = K.prepare(scene, "cpu")
        rad, _ = K.trace_k1(job, 11, 1)
    assert _tree(profiling.spans()) == [("prepare", -1, None),
                                        ("k1", -1, 11)]
    assert torch.equal(rad, K.trace_plain(**job, it0=11, n_spp=1)[0])


def test_render_vjp_spans_keep_the_bits(tmp_path):
    scene = load("cornell", res=(8, 6), depth=2)
    ct = np.random.RandomState(0).rand(scene.pixel_count, 3).astype(
        np.float32)
    rad0, g0 = VJ.render_vjp(scene, ct, 5, 1, nee=True, device="cpu",
                             plain=True)
    with profiling.trace(str(tmp_path), device="cpu"):
        rad1, g1 = VJ.render_vjp(scene, ct, 5, 1, nee=True, device="cpu",
                                 plain=True)
    rec = profiling.spans()
    assert _tree(rec) == [("vjp", -1, 5), ("vjp.pack", 0, None),
                          ("vjp.chain", 0, None)]
    vjp, pack, chain = rec
    assert vjp.start_ns <= pack.start_ns <= pack.end_ns <= chain.start_ns \
        <= chain.end_ns <= vjp.end_ns
    assert torch.equal(rad0, rad1) and g0.keys() == g1.keys()
    l0, l1 = _leaves(g0), _leaves(g1)
    assert len(l0) == len(l1) > 4
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert any(bool(t.abs().sum() > 0) for t in l1)
