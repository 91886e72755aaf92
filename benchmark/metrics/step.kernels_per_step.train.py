"""Device kernels per training step in the profiled steps."""


def read(r):
    return len(r["trace"].kernels) / r["steps_profiled"] if r["steps_profiled"] else None
