"""The median over the process's training steps but the first (the set-up's
checked steps, the window's and the profiled ones) of the device time of the
step's ``train.optimizer`` span: the gradients' fp32 casts and norm and the
AdamW step on the fp32 masters."""

from benchmark.lib.program_spans import train_phase_ms


def read(r):
    return train_phase_ms("optimizer")
