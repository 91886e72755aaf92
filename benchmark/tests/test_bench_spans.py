"""The readers of the program's own spans (``lib.program_spans`` and the
``server.*``, ``step.*_ms.serve`` and ``train.*_ms`` metrics): on synthetic
spans, against a port without a recorder (nothing, no error), and through
the tiny cells' traced runs on the CPU."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.lib import program_spans
from benchmark.tests.helpers import run_tiny

SERVE = ("server.queue_ms", "server.collect_ms", "server.batch_mean", "step.enqueue_ms.serve",
         "step.device_ms.serve")
TRAIN = ("train.forward_ms", "train.backward_ms", "train.optimizer_ms")
MS = 1_000_000


def _span(sid, name, start_ms, end_ms, requests=(), parent=None, device_ms=None):
    s = SimpleNamespace(id=sid, name=name, start_ns=int(start_ms * MS), end_ns=int(end_ms * MS),
                        requests=tuple(requests), parent=parent, device_ms=device_ms)
    s.host_ms = end_ms - start_ms
    return s


def _served():
    """Three batches: one before the steady part (ids 0), two inside (ids
    1-2 and 3-5), then a profiled one (id 6); each with its queue, collect,
    run and two model calls."""
    made, sid = [], iter(range(1, 1000))
    batches = [((0,), 0, 100), ((1, 2), 200, 400), ((3, 4, 5), 500, 800), ((6,), 900, 1000)]
    for ids, t, t_end in batches:
        for k, i in enumerate(ids):
            made.append(_span(next(sid), "server.queue", t - 50 + 10 * k, t - 30 + 10 * k, (i,)))
        made.append(_span(next(sid), "server.collect", t - 30, t - 1, ids))
        run_span = _span(next(sid), "server.run", t, t_end, ids)
        made.append(run_span)
        for c in range(2):
            made.append(_span(next(sid), "model.call", t + 10 + 40 * c, t + 30 + 40 * c, ids,
                              run_span.id, device_ms=25.0 + c))
    readings = {"steady_calls": [{"start": 0.2001, "end": 0.3999}, {"start": 0.5001,
                                                                      "end": 0.7999}],
                "t_profiled": 0.9001}
    return made, readings


def test_serving_readers_on_synthetic_spans(monkeypatch):
    made, r = _served()
    monkeypatch.setattr(program_spans, "recorded", lambda: made)
    got = {name: run.reader(name)(r) for name in SERVE}
    # queue: put until the run's start; ids 1, 2: 50, 40; ids 3-5: 50, 40, 30
    assert got["server.queue_ms"] == pytest.approx(40.0)
    assert got["server.collect_ms"] == pytest.approx(29.0)
    assert got["server.batch_mean"] == pytest.approx(2.5)
    assert got["step.enqueue_ms.serve"] == pytest.approx(20.0)
    assert got["step.device_ms.serve"] == pytest.approx(25.5)


def test_training_readers_leave_the_first_step_out(monkeypatch):
    made, sid = [], iter(range(1, 1000))
    for k, scale in enumerate((100.0, 1.0, 2.0, 3.0)):  # the first step is slow
        step = _span(next(sid), "train.step", 0, 1, device_ms=10 * scale)
        made.append(step)
        for phase, share in (("forward", 3), ("backward", 6), ("optimizer", 1)):
            made.append(_span(next(sid), f"train.{phase}", 0, 1, parent=step.id,
                              device_ms=share * scale))
    monkeypatch.setattr(program_spans, "recorded", lambda: made)
    got = {name: run.reader(name)({}) for name in TRAIN}
    assert got == {"train.forward_ms": 6.0, "train.backward_ms": 12.0,
                   "train.optimizer_ms": 2.0}


def test_nothing_without_a_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffbir_tpu_torch.utils.spans", None)
    assert program_spans.recorded() is None
    _, r = _served()
    for name in SERVE + TRAIN:
        assert run.reader(name)(r) is None


def test_tiny_traced_runs_report_the_span_metrics():
    """On the CPU the host-clock readings report and the device times do
    not (no CUDA events)."""
    serve = run_tiny("tiny-serve", trace=True)["metrics"]
    train = run_tiny("tiny-train", seconds=2.0, trace=True)["metrics"]
    host = [n for n in SERVE if n != "step.device_ms.serve"]
    assert set(host) <= set(serve) and all(serve[n]["value"] > 0 for n in host)
    assert "step.device_ms.serve" not in serve and not set(TRAIN) & set(train)
    assert serve["server.batch_mean"]["value"] == serve["serve.batch_mean"]["value"]
    assert abs(serve["server.queue_ms"]["value"] - serve["serve.queue_wait_ms"]["value"]) < 5.0
