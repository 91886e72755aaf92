"""The FLOPs of the training steps of the traced run's window before the
profiled steps (``lib.flops.train_flops``: the reference step's count, no
recompute) over those seconds at the bf16 peak of one H100."""

from benchmark.lib import peaks


def read(r):
    if r["steady_s"] <= 0 or not r["steady_flops"]:
        return None
    return 100.0 * r["steady_flops"] / (r["steady_s"] * peaks.BF16_FLOPS)
