"""The port's span recorder (``diffbir_tpu_torch.utils.spans``) on the CPU.

- the recorder: parent links on one thread and none across threads, the
  request ids a span is given or inherits, host-only spans, a caller's own
  list of spans (``into``), the ring's bound (the newest kept), the off
  switch (nothing recorded, no span object, a caller's own spans still
  kept), no device time without a CUDA device (``seconds`` says "host");
- ``StageClock``: one ``pipeline.<stage>`` span per lap, its seconds in
  ``timings`` (the host's without a card), nothing left open;
- ``BatchingServer`` on a stub pipeline: one ``server.queue`` per request,
  one ``server.collect`` and one ``server.run`` per batch, sized as the
  stub's calls, and a request's queue plus collect time (its put until its
  batch's run) within 5 ms of the same interval on an outside clock;
- one ``model.call`` per denoiser call for each sampler family (spaced,
  ddim, dpm-solver, an edm row solver and an edm solver of two calls a
  step) on the tiny pipeline, each a child of its stage's caller.

Every test reads only the spans it made (``_since``), so tests that run in
the same process do not see each other's.
"""

import statistics
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

from diffbir_tpu_torch import serve
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.models.layers import random_init_
from diffbir_tpu_torch.pipeline import IdentityCleanerPipeline
from diffbir_tpu_torch.profile_step import stand_in_tokenizer
from diffbir_tpu_torch.schedule import Schedule
from diffbir_tpu_torch.utils import spans
from diffbir_tpu_torch.utils.common import StageClock

CPU = torch.device("cpu")


def _since(t0_ns, name=None):
    return [s for s in spans.snapshot()
            if s.start_ns >= t0_ns and (name is None or s.name == name)]


@pytest.fixture
def recorder_on(monkeypatch):
    monkeypatch.setattr(spans, "_enabled", True)


def test_parents_requests_and_counters(recorder_on):
    t0 = time.perf_counter_ns()
    own = []
    with spans.span("test.outer", requests=[7, 9], size=2) as outer:
        with spans.span("test.inner", CPU, into=own) as inner:
            spans.record("test.measured", time.perf_counter_ns() - 1000, time.perf_counter_ns())
        sp = spans.open_span("test.opened", push=False, extra=1)
        spans.close_span(sp)
    got = {s.name: s for s in _since(t0)}
    assert set(got) == {"test.outer", "test.inner", "test.measured", "test.opened"}
    assert got["test.outer"].parent is None and got["test.outer"].attrs == {"size": 2}
    assert got["test.inner"].parent == outer.id
    assert got["test.measured"].parent == inner.id
    assert got["test.opened"].parent == outer.id and got["test.opened"].attrs == {"extra": 1}
    assert all(s.requests == (7, 9) for s in got.values())
    assert own == [got["test.inner"]]
    for s in got.values():
        assert s.start_ns <= s.end_ns and s.host_ms >= 0.0
        assert s.device_ms is None  # no CUDA device: no device time
        assert s.seconds() == (pytest.approx(s.host_ms / 1e3), "host")
    assert got["test.outer"].start_ns <= got["test.inner"].start_ns
    assert got["test.inner"].end_ns <= got["test.outer"].end_ns


def test_spans_of_another_thread_have_their_own_parents(recorder_on):
    t0 = time.perf_counter_ns()
    ready, done = threading.Event(), threading.Event()

    def other():
        ready.wait(5)
        with spans.span("test.other"):
            pass
        done.set()

    th = threading.Thread(target=other)
    th.start()
    with spans.span("test.main"):
        ready.set()
        assert done.wait(5)
    th.join(5)
    assert not th.is_alive()
    assert _since(t0, "test.other")[0].parent is None


def test_the_ring_keeps_the_newest(recorder_on, monkeypatch):
    assert spans._ring.maxlen == spans.RING_SPANS
    monkeypatch.setattr(spans, "_ring", deque(maxlen=5))
    for i in range(12):
        with spans.span("test.ring", idx=i):
            pass
    kept = spans.snapshot()
    assert [s.attrs["idx"] for s in kept] == list(range(7, 12))
    assert [s.attrs["idx"] for s in spans.drain()] == list(range(7, 12))
    assert spans.snapshot() == []


def test_off_records_nothing(monkeypatch):
    t0 = time.perf_counter_ns()
    monkeypatch.setattr(spans, "_enabled", False)
    assert not spans.enabled()
    with spans.span("test.off", CPU) as sp:
        assert sp is None
    spans.record("test.off", t0, t0 + 1)
    clock = StageClock(None, CPU)
    clock.lap("stage")
    clock.finish()
    assert clock.cur is None and clock.laps == []
    own = []
    with spans.span("test.kept", CPU, into=own) as kept:
        time.sleep(0.001)
    assert own == [kept] and kept.seconds()[0] >= 0.001
    monkeypatch.setattr(spans, "_enabled", True)
    assert _since(t0) == []


@pytest.mark.parametrize("on", [True, False])
def test_stage_clock_fills_timings_from_its_spans(on, monkeypatch):
    monkeypatch.setattr(spans, "_enabled", on)
    t0 = time.perf_counter_ns()
    timings = {}
    clock = StageClock(timings, CPU)
    time.sleep(0.002)
    clock.lap("first")
    time.sleep(0.004)
    clock.lap("second")
    clock.lap("first")
    clock.finish()
    assert set(timings) == {"first", "second"}
    assert timings["second"] >= 0.004 and timings["first"] >= 0.002
    made = _since(t0)
    if on:
        assert [s.name for s in made] == ["pipeline.first", "pipeline.second", "pipeline.first"]
        assert timings["first"] == pytest.approx(made[0].host_ms / 1e3 + made[2].host_ms / 1e3)
    else:
        assert made == []
    assert clock.cur is None


class StubPipeline:
    """Records each run() call's clients (each image is filled with its
    client's number) and start on the host clock."""

    def __init__(self, delay):
        self.delay, self.calls = delay, []

    def run(self, imgs, **kw):
        self.calls.append(([int(img[0, 0, 0]) for img in imgs], time.perf_counter()))
        time.sleep(self.delay)
        return np.asarray(imgs)


def test_server_spans_per_request_and_batch(recorder_on):
    t0 = time.perf_counter_ns()
    pipe = StubPipeline(delay=0.06)
    srv = serve.BatchingServer(pipe, batch=3, max_wait_ms=40)
    submitted = {}

    def client(i):
        submitted[i] = time.perf_counter()
        srv.submit(np.full((16, 16, 3), i, np.uint8), 4, 2.0, "", "", "spaced", 1)

    threads = []
    for i in range(7):
        th = threading.Thread(target=client, args=(i,))
        th.start()
        threads.append(th)
        time.sleep(0.015)
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    srv.stop()
    queue = _since(t0, "server.queue")
    collect = _since(t0, "server.collect")
    runs = _since(t0, "server.run")
    assert len(queue) == 7 and sorted(r for s in queue for r in s.requests) == list(range(7))
    assert len(collect) == len(runs) == len(pipe.calls)
    assert [len(s.requests) for s in runs] == [len(c) for c, _ in pipe.calls]
    assert [s.requests for s in collect] == [s.requests for s in runs]
    assert all(s.parent is None for s in queue + collect + runs)
    assert all(s.attrs["waited_ms"] >= 0 for s in collect)
    # each request's put until its batch's run against the outside clock,
    # submit() until the stub's call (a batch's ids and images in one order):
    # the program's interval lies inside the outside one, and their medians
    # agree within 5 ms (a client thread can wait for the interpreter lock
    # between its clock read and the put)
    put = {s.requests[0]: s.start_ns for s in queue}
    program, outside = [], []
    for run, (clients, t_call) in zip(runs, pipe.calls):
        for rid, i in zip(run.requests, clients):
            program.append((run.start_ns - put[rid]) / 1e6)
            outside.append((t_call - submitted[i]) * 1e3)
            assert program[-1] <= outside[-1] + 1e-3, (rid, program[-1], outside[-1])
            taken = next(s for s in queue if s.requests == (rid,))
            coll = next(s for s in collect if rid in s.requests)
            assert taken.end_ns <= coll.end_ns <= run.start_ns
    assert abs(statistics.median(program) - statistics.median(outside)) < 5.0, (program, outside)


@pytest.fixture(scope="module")
def tiny_pipe():
    cldm = random_init_(ControlLDM.tiny(), torch.Generator().manual_seed(0)).eval()
    return IdentityCleanerPipeline(cldm, Schedule.v21(), CPU, min_cond_size=64,
                                   tokenizer=stand_in_tokenizer())


@pytest.mark.parametrize("sampler", ["spaced", "ddim", "dpm++_m2", "edm_dpm++_3m_sde",
                                     "edm_heun"])
def test_one_model_call_span_per_denoiser_call(tiny_pipe, sampler, recorder_on):
    calls = []
    hook = tiny_pipe.cldm.unet.register_forward_hook(lambda *a: calls.append(1))
    timings = {}
    t0 = time.perf_counter_ns()
    try:
        with spans.span("test.request", requests=[3]) as outer:
            tiny_pipe.run(np.zeros((1, 64, 64, 3), np.uint8), steps=2, cfg_scale=3.0,
                          sampler_type=sampler, seed=1, timings=timings)
    finally:
        hook.remove()
    made = _since(t0)
    model = [s for s in made if s.name == "model.call"]
    assert len(calls) > 0 and len(model) == len(calls)
    stages = [s for s in made if s.name.startswith("pipeline.")]
    assert [s.name for s in stages] == ["pipeline." + k for k in (
        "cleaner", "condition", "hoist", "denoise", "decode", "colour_fix")]
    assert list(timings) == [s.name.split(".")[1] for s in stages]
    denoise = stages[3]
    assert all(s.parent == outer.id and s.requests == (3,) for s in stages + model)
    assert all(denoise.start_ns <= s.start_ns <= s.end_ns <= denoise.end_ns for s in model)
