"""The FLOPs of the requests of the pipeline calls in the steady part of
the traced run's window (``lib.flops.serve_flops``: the reference's count
at the cell's shapes) over the seconds spent inside those calls, at the
bf16 peak of one H100: the device's share of its peak while a call runs,
which a faster call raises whatever the offered rate."""

from benchmark.lib import peaks


def read(r):
    if r["steady_s"] <= 0 or not r["steady_flops"]:
        return None
    return 100.0 * r["steady_flops"] / (r["steady_s"] * peaks.BF16_FLOPS)
