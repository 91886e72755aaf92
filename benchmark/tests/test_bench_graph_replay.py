"""The reader of ``step.graph_replay_share.serve``: the share of the steady
denoiser calls that replayed a CUDA graph, from the ``model.call`` spans'
``graph`` attribute; nothing from a port whose spans carry none; 0 on the
CPU, where every call runs eagerly."""

import pytest

from benchmark import run
from benchmark.lib import program_spans
from benchmark.tests.helpers import run_tiny
from benchmark.tests.test_bench_spans import _served

NAME = "step.graph_replay_share.serve"


def _with_graph(made, values):
    """The spans with ``attrs``, the model calls' ``graph`` from ``values``
    in order (the others' {})."""
    values = iter(values)
    for s in made:
        s.attrs = {"graph": next(values)} if s.name == "model.call" else {}
    return made


def test_share_of_the_steady_calls_that_replayed(monkeypatch):
    made, r = _served()
    # two calls in each of four batches; the first and last batch lie
    # outside the steady part, so their captures do not count
    made = _with_graph(made, [1, 1, 1, 2, 2, 2, 1, 0])
    monkeypatch.setattr(program_spans, "recorded", lambda: made)
    assert run.reader(NAME)(r) == pytest.approx(75.0)


def test_nothing_where_the_spans_carry_no_graph_attribute(monkeypatch):
    made, r = _served()
    made = _with_graph(made, [2] * 8)
    for s in made:
        if s.name == "model.call":
            s.attrs = {}
    monkeypatch.setattr(program_spans, "recorded", lambda: made)
    assert run.reader(NAME)(r) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert run.reader(NAME)(r) is None


def test_the_tiny_traced_run_reports_no_replay_on_the_cpu():
    metrics = run_tiny("tiny-serve", trace=True)["metrics"]
    assert metrics[NAME] == {"value": 0.0, "unit": "%"}
