"""The share of the profiled sub-window in which no kernel ran on the
device: one minus the union of the kernel intervals over the window."""


def read(r):
    t = r["trace"]
    return 100.0 * (1.0 - t.busy_us / t.window_us) if t.window_us > 0 else None
