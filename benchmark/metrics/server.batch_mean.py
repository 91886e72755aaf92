"""The program's twin of ``serve.batch_mean``: requests per pipeline call
in the steady part of the traced run's window, from the request ids of
``BatchingServer``'s ``server.run`` spans."""

from benchmark.lib.program_spans import steady_runs


def read(r):
    _, runs = steady_runs(r)
    return sum(len(s.requests) for s in runs) / len(runs) if runs else None
