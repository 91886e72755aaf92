"""K2a + K2b's share of their roofline in the profiled training steps: the
least times of the backward's launches (``lib.flops.attn_bwd`` at the
training shapes: the ControlNet's and the UNet decoder's self-attention,
where the gradient reaches) over the device time of the
``flash_bwd_dq_tc_kernel`` and ``flash_bwd_dkv_tc_kernel`` events. Only
steps whose launches the profiler, ``CudaKernel.launches`` and the shapes
count alike are read (the driver leaves the others out)."""


def read(r):
    dq, dkv = (r["trace"].kernel_us(s) for s in r["k2_symbols"])
    return 100.0 * r["k2_least_us"] / (sum(dq) + sum(dkv)) if dq and dkv else None
