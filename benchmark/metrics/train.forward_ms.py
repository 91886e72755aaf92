"""The median over the process's training steps but the first (the set-up's
checked steps, the window's and the profiled ones) of the device time of the
step's ``train.forward`` span: the loss: the frozen VAE encode, cleaner and
text tower, then the ControlNet and UNet forward."""

from benchmark.lib.program_spans import train_phase_ms


def read(r):
    return train_phase_ms("forward")
