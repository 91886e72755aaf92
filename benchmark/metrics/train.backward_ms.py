"""The median over the process's training steps but the first (the set-up's
checked steps, the window's and the profiled ones) of the device time of the
step's ``train.backward`` span: the backward through the ControlNet and
UNet, with the checkpointed blocks' recompute."""

from benchmark.lib.program_spans import train_phase_ms


def read(r):
    return train_phase_ms("backward")
