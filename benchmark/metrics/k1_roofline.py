"""K1's share of its roofline in the profiled pipeline calls: the sum of
the least times of its launches (``lib.flops``: each launch's FLOPs at the
bf16 peak or its bytes at the HBM rate, from the configuration's attention
shapes at the batch each call ran) over the device time of the
``flash_fwd_tc_kernel`` events. Only calls whose K1 launches the shapes,
the profiler and ``CudaKernel.launches`` count alike are read (the driver
leaves the others out); nothing where none is left."""


def read(r):
    times = r["trace"].kernel_us(r["k1_symbol"])
    return 100.0 * r["k1_least_us"] / sum(times) if times else None
