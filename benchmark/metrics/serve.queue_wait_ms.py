"""The median over the requests of the steady part of the window of the
time from ``submit`` to the start of the pipeline call that ran the request
(the recording proxy's clock)."""

import statistics


def read(r):
    waits = [c["start"] - r["submitted"][i] for c in r["steady_calls"] for i in c["ids"]
             if i is not None and r["submitted"][i] is not None]
    return statistics.median(waits) * 1e3 if waits else None
