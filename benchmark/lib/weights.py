"""The benchmark's weights: made on the device from the seed.

One standard-normal draw in bf16 from a ``torch.Generator`` on the device
covers every parameter of a network, laid out in the order of the
parameters' names; each parameter's value is its slice, shaped and scaled
in bf16: a tensor of rank >= 2 by fan_in^-1/2, a 1-D ``weight`` (a norm's
scale) as 1 + 0.1 z, any other 1-D tensor (a bias) as 0.02 z. Every value
is a bf16 number, so the program (bf16 weights, fp32 norms) and the
float32 reference hold the same numbers.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


def leaf_value(name: str, z: torch.Tensor) -> torch.Tensor:
    """A parameter's bf16 value from its standard-normal slice ``z``."""
    if z.dim() >= 2:
        return z * (z[0].numel() ** -0.5)
    if name.endswith("weight"):
        return 1.0 + 0.1 * z
    return 0.02 * z


@torch.no_grad()
def fill_(params: Iterable[Tuple[str, torch.Tensor]], generator: torch.Generator) -> None:
    """Fill ``(name, tensor)`` pairs (a module's ``named_parameters``) from
    one draw of ``generator``, in name order."""
    params = sorted(params, key=lambda kv: kv[0])
    total = sum(p.numel() for _, p in params)
    flat = torch.randn(total, generator=generator, dtype=torch.bfloat16,
                       device=generator.device)
    off = 0
    for name, p in params:
        n = p.numel()
        p.copy_(leaf_value(name, flat[off:off + n].view(p.shape)))
        off += n
    del flat


def generator(seed: int, device) -> torch.Generator:
    """The weights' generator (the run's seed, on ``device``)."""
    return torch.Generator(device=device).manual_seed(int(seed))
