"""The median device time of one denoiser call inside the steady pipeline
calls of the traced run: the stream's time from the ``model.call`` span's
first CUDA event to its last. Close to ``step.enqueue_ms.serve``, the
host sets the pace and the device waits on it."""

from benchmark.lib.program_spans import median_or_none, steady_model_calls


def read(r):
    return median_or_none(s.device_ms for s in steady_model_calls(r))
