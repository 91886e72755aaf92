"""The nearest-rank p90 of the latency, from its due time to its image, of
the requests of the traced run's steady part: those returned before the
first profiled call (the profiler's start and stop stall the host for
seconds, so what follows is left out). A tail of the host-bound path that
spreads 14-48 % from run to run: read here; the median over the whole
window is the cell's end-to-end ``latency_p50_s``."""

from benchmark.lib import stats


def read(r):
    lat = r["steady_latencies"]
    return stats.percentile(lat, 90) if lat else None
