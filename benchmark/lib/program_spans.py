"""What the readers of the program's own spans share: the spans the port
recorded in this process (``diffbir_tpu_torch.utils.spans``), selected for
the traced run's steady part. Each returns None where the port has no
recorder (a checkout from before it) or recorded nothing there, so that
the metric is left out of the result instead of failing the run."""

from __future__ import annotations

import importlib
import statistics


def recorded():
    """The recorder's spans, oldest first, or None."""
    try:
        spans = importlib.import_module("diffbir_tpu_torch.utils.spans")
    except ImportError:
        return None
    return spans.snapshot() or None


def steady_runs(r):
    """(every span, the served run's steady ``server.run`` spans): those
    whose middle lies between the start of the first steady pipeline call
    and the first profiled call (``t_profiled``), the benchmark's
    ``perf_counter`` seconds and the spans' ``perf_counter_ns`` being one
    clock; (None, None) where there are none."""
    made = recorded()
    if not made or not r.get("steady_calls"):
        return None, None
    lo, hi = min(c["start"] for c in r["steady_calls"]), r["t_profiled"]
    runs = [s for s in made if s.name == "server.run" and s.end_ns is not None
            and lo <= (s.start_ns + s.end_ns) / 2e9 <= hi]
    return (made, runs) if runs else (None, None)


def steady_model_calls(r):
    """The ``model.call`` spans inside the steady ``server.run`` spans."""
    made, runs = steady_runs(r)
    if not runs:
        return []
    ids = {s.id for s in runs}
    return [s for s in made if s.name == "model.call" and s.parent in ids]


def median_or_none(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def train_phase_ms(phase: str):
    """The median over the process's ``train.step`` spans but the first of
    the device milliseconds of the step's ``train.<phase>`` child (between
    its CUDA events; none without a CUDA device)."""
    made = recorded()
    if not made:
        return None
    steps = [s for s in made if s.name == "train.step"][1:]
    ids = {s.id for s in steps}
    return median_or_none(s.device_ms for s in made
                          if s.name == f"train.{phase}" and s.parent in ids)
