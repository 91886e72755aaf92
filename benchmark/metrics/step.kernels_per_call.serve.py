"""Device kernels in the profiled pipeline calls, per denoiser call in
them (the profiler's CUDA kernel events; every kernel of the calls, the
cleaner's, encoders' and decoder's too)."""


def read(r):
    if not r["denoiser_calls"]:
        return None
    return len(r["trace"].kernels) / r["denoiser_calls"]
