"""The median over the pipeline calls of the steady part of the window of
the denoise stage's milliseconds (``Pipeline.run(timings=)``:
``utils.common.StageClock``, whose laps sync the device; so the traced run
only)."""

import statistics


def read(r):
    ms = [c["timings"]["denoise"] * 1e3 for c in r["steady_calls"]
          if c["timings"] and "denoise" in c["timings"]]
    return statistics.median(ms) if ms else None
