"""Sampler base: classifier-free guidance folded into the batch.

Counterpart of ``diffbir_tpu/sampler/base.py``: one model call on 2B rows
(cond then uncond) per step instead of two calls.

The model function's contract: ``model_fn(x, t, cond)``, where ``t`` is the
step's model timestep as a host float, the same for every row (as every
sampler's is); the model function makes its own [B] timestep tensor. So a
step's hoisted rows are found on the host (``cldm.HoistTables.lookup``).
The samplers call the model function once per model evaluation, in order,
so a model function that carries state from call to call (the turbo
control cache, ``cldm.CachedControlModel``) works through them.

Restoration guidance (``utils.cond_fn``): ``guidance_gate`` is the host
table of the steps it acts on (model t in [t_stop, t_start]);
``apply_guidance`` adds ``repeat`` gradient steps to an x0 prediction.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..schedule import cfg_scale_schedule
from ..utils import spans

# model_fn(x, t_model, cond) -> eps/v prediction; cond = {"c_txt", "c_img"}
ModelFn = Callable[[torch.Tensor, float, Mapping[str, torch.Tensor]], torch.Tensor]


def timestep_vector(t: float, x: torch.Tensor) -> torch.Tensor:
    """The model's [B] fp32 timestep input for a step at host value ``t``."""
    return torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)


class GuidedModel:
    """Batched classifier-free guidance in the order of the JAX
    ``cfg_model_call`` (cond rows, then uncond), with the cond/uncond
    concatenation made once per request instead of once per step.
    ``raw(x2, t)`` is one model call on the batch the model sees (2B rows
    under CFG: x twice, ``batch(x)``); ``combine`` folds such an output back
    to B rows, ``o_uncond + cfg (o_cond - o_uncond)``; ``__call__`` is
    both. Each model call is one ``model.call`` span (``utils.spans``: the
    host's enqueue and, on a CUDA device, the stream's time)."""

    def __init__(self, model_fn: ModelFn, cond: Mapping[str, torch.Tensor],
                 uncond: Optional[Mapping[str, torch.Tensor]]):
        self.model_fn = model_fn
        self.use_cfg = uncond is not None
        self.cond = ({k: torch.cat([cond[k], uncond[k]], dim=0) for k in cond}
                     if self.use_cfg else dict(cond))

    def batch(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x], dim=0) if self.use_cfg else x

    def raw(self, x2: torch.Tensor, t: float) -> torch.Tensor:
        with spans.span("model.call", x2.device):
            return self.model_fn(x2, t, self.cond)

    def combine(self, out: torch.Tensor, cfg_scale: float) -> torch.Tensor:
        if not self.use_cfg:
            return out
        o_cond, o_uncond = out.chunk(2, dim=0)
        return o_uncond + cfg_scale * (o_cond - o_uncond)

    def __call__(self, x: torch.Tensor, t: float, cfg_scale: float) -> torch.Tensor:
        return self.combine(self.raw(self.batch(x), t), cfg_scale)


def guidance_gate(cond_fn, model_ts) -> np.ndarray:
    """Host bool table: guidance acts where the model t is in [t_stop,
    t_start]."""
    model_ts = np.asarray(model_ts)
    return (model_ts <= cond_fn.t_start) & (model_ts >= cond_fn.t_stop)


def apply_guidance(cond_fn, target: torch.Tensor, x0: torch.Tensor, g_on: bool
                   ) -> torch.Tensor:
    """``repeat`` rounds of x0 += cond_fn's gradient step where ``g_on``;
    ``repeat <= 0`` is off, as the reference's ``for _ in range(repeat)``."""
    if not g_on:
        return x0
    for _ in range(int(cond_fn.repeat)):
        g, _loss = cond_fn(target, x0)
        x0 = x0 + g
    return x0


class NoiseSource:
    """Standard normals of x's shape in fp32, from a ``torch.Generator`` or
    a pre-drawn ``table``: ``draw(i)`` gives the table's row i (a sampler
    whose draws belong to steps), ``draw()`` the next unused row (draws in
    call order); with a generator both draw afresh. The sampler checks the
    table's shape."""

    def __init__(self, shape, device, generator: Optional[torch.Generator] = None,
                 table: Optional[torch.Tensor] = None):
        if (generator is None) == (table is None):
            raise ValueError("pass exactly one of generator and noise_table")
        self.shape, self.device = tuple(shape), device
        self.generator, self.table = generator, table
        self.used = 0

    def draw(self, i: Optional[int] = None) -> torch.Tensor:
        if self.table is None:
            return torch.randn(self.shape, generator=self.generator, dtype=torch.float32,
                               device=self.device)
        if i is None:
            i, self.used = self.used, self.used + 1
        if i >= len(self.table):
            raise ValueError(f"noise_table has {len(self.table)} rows; draw {i} needs more")
        return self.table[i].to(device=self.device, dtype=torch.float32)


class Sampler:
    """Holds the training schedule; subclasses implement ``sample``."""

    def __init__(self, betas: np.ndarray, parameterization: str, rescale_cfg: bool):
        if parameterization not in ("eps", "v"):
            raise ValueError(f"unknown parameterization {parameterization!r}")
        self.training_betas = np.asarray(betas, np.float64)
        self.training_alphas_cumprod = np.cumprod(1.0 - self.training_betas)
        self.num_timesteps = len(betas)
        self.parameterization = parameterization
        self.rescale_cfg = rescale_cfg

    def cfg_scales(self, cfg_scale: float, model_ts: np.ndarray) -> np.ndarray:
        """Per-step (optionally cosine-ramped) CFG scale, fp32."""
        return cfg_scale_schedule(cfg_scale, model_ts, self.rescale_cfg).astype(np.float32)

    def model_ts(self, steps: int) -> Optional[np.ndarray]:
        """Every model timestep ``sample(steps=...)`` calls the model at (a
        superset is fine), or None when unknown; the hoisted timestep tables
        are built for these (``cldm.make_hoist_tables``)."""
        return None
