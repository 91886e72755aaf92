"""The median host time of one denoiser call (a ``model.call`` span:
``GuidedModel.raw``, the call every sampler makes) inside the steady
pipeline calls of the traced run: the host's enqueue of the call's
kernels, from the call's entry to its return."""

from benchmark.lib.program_spans import median_or_none, steady_model_calls


def read(r):
    return median_or_none(s.host_ms for s in steady_model_calls(r))
