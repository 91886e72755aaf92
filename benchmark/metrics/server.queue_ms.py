"""The program's twin of ``serve.queue_wait_ms``: the median over the
requests of the steady part of the traced run's window of the time from
the request's put on ``BatchingServer``'s queue (the start of its
``server.queue`` span) to the start of its batch's ``server.run``: its
wait behind the running call plus the collector's wait for the batch to
fill."""

from benchmark.lib.program_spans import median_or_none, steady_runs


def read(r):
    made, runs = steady_runs(r)
    if not runs:
        return None
    put = {s.requests[0]: s.start_ns for s in made if s.name == "server.queue" and s.requests}
    return median_or_none((run.start_ns - put[i]) / 1e6 for run in runs for i in run.requests
                          if i in put)
