"""The share, in %, of the denoiser calls inside the steady pipeline calls
of the traced run (the ``model.call`` spans) that replayed a captured CUDA
graph: the span's ``graph`` attribute 2 (0 an eager call, 1 a capture).
Nothing where the port's spans carry no such attribute."""

from benchmark.lib.program_spans import steady_model_calls


def read(r):
    calls = steady_model_calls(r)
    if not calls or any("graph" not in getattr(s, "attrs", {}) for s in calls):
        return None
    return 100.0 * sum(s.attrs["graph"] == 2 for s in calls) / len(calls)
