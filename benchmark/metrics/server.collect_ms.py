"""The mean over the pipeline calls of the steady part of the traced run's
window of ``BatchingServer``'s batching wait: its ``server.collect`` span,
from taking a batch's first request off the queue to closing the batch
(full, or ``max_wait_ms`` after the first), during which the device has no
call to run. A batch either fills at once from a backlog (well under a
millisecond) or waits the whole ``max_wait_ms``, so a median flips between
the two with how the batches happened to form; the mean is the wait a call
carries on average."""

import statistics

from benchmark.lib.program_spans import steady_runs


def read(r):
    made, runs = steady_runs(r)
    if not runs:
        return None
    collect = {s.requests: s for s in made if s.name == "server.collect"}
    waits = [collect[run.requests].host_ms for run in runs if run.requests in collect]
    return statistics.fmean(waits) if waits else None
