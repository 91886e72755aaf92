"""Faults planted in the timed path, and the training cell's control: each
must turn ``correct`` false (``tests/test_bench_faults.py`` on the CPU;
``tools.py seeds --fault`` and ``tools.py train_control`` read them on the
chip at the cells' sizes).

Training (``faults={"step": f}``, ``f(step, optimizer) -> step``):
``state_unchanged`` (the optimiser never updates), ``half_batch`` (each step
on the first half of its rows, the mean over those), ``moments_reset``
(AdamW's first and second moments zeroed before every step, its step count
kept: each update forgets the steps before it). Serving
(``faults={"answer": f}``, ``f(images) -> images``): ``answer_altered``
(each returned image's every pixel raised by a quarter of the range).
The training control (the program has no lower-precision training path of
its own): the reference in the program's place with every matrix product
and convolution of the UNet and ControlNet on float8 e4m3 operands, the
nearest precision below the configuration's bf16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def state_unchanged(step, optimizer):
    optimizer.step = lambda grads=None: False
    return step


def half_batch(step, optimizer):
    def half(batch, generator=None, draws=None):
        h = batch["gt"].shape[0] // 2
        return step({k: v[:h] for k, v in batch.items()}, generator,
                    None if draws is None else {k: v[:h] for k, v in draws.items()})
    return half


def moments_reset(step, optimizer):
    def reset(batch, generator=None, draws=None):
        for state in optimizer.optimizer.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key].zero_()
        return step(batch, generator, draws)
    return reset


def answer_altered(images: np.ndarray) -> np.ndarray:
    return np.clip(images.astype(np.int32) + 64, 0, 255).astype(np.uint8)


TRAIN_FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
                "moments_reset": moments_reset}
SERVE_FAULTS = {"answer_altered": answer_altered}


E4M3_MAX = 448.0


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude to 448), straight through for the gradient."""
    scale = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-12)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


def fp8_operands_(cldm) -> None:
    """Every matrix product and convolution of the UNet and the ControlNet
    on float8 e4m3 operands: its input and its weight rounded, each under
    one scale, the product accumulated in float32."""
    for root in (cldm.unet, cldm.controlnet):
        for m in root.modules():
            if isinstance(m, torch.nn.Linear):
                m.forward = (lambda mod: lambda x: F.linear(_e4m3(x), _e4m3(mod.weight),
                                                            mod.bias))(m)
            elif isinstance(m, torch.nn.Conv2d):
                m.forward = (lambda mod: lambda x: mod._conv_forward(_e4m3(x), _e4m3(mod.weight),
                                                                     mod.bias))(m)
