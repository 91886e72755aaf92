"""Sampler base: classifier-free guidance folded into the batch.

Counterpart of ``diffbir_tpu/sampler/base.py``: one model call on 2B rows
(cond then uncond) per step instead of two calls.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..schedule import cfg_scale_schedule

# model_fn(x, t_model, cond) -> eps/v prediction; cond = {"c_txt", "c_img"}
ModelFn = Callable[[torch.Tensor, torch.Tensor, Mapping[str, torch.Tensor]], torch.Tensor]


def cfg_model_call(
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    cond: Mapping[str, torch.Tensor],
    uncond: Optional[Mapping[str, torch.Tensor]],
    cfg_scale: float,
) -> torch.Tensor:
    """Batched classifier-free guidance (one forward on 2B)."""
    if uncond is None:
        return model_fn(x, t, cond)
    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t, t], dim=0)
    c2 = {k: torch.cat([cond[k], uncond[k]], dim=0) for k in cond}
    o_cond, o_uncond = model_fn(x2, t2, c2).chunk(2, dim=0)
    return o_uncond + cfg_scale * (o_cond - o_uncond)


class Sampler:
    """Holds the training schedule; subclasses implement ``sample``."""

    def __init__(self, betas: np.ndarray, parameterization: str, rescale_cfg: bool):
        if parameterization not in ("eps", "v"):
            raise ValueError(f"unknown parameterization {parameterization!r}")
        self.training_betas = np.asarray(betas, np.float64)
        self.parameterization = parameterization
        self.rescale_cfg = rescale_cfg

    def cfg_scales(self, cfg_scale: float, model_ts: np.ndarray) -> np.ndarray:
        """Per-step (optionally cosine-ramped) CFG scale, fp32."""
        return cfg_scale_schedule(cfg_scale, model_ts, self.rescale_cfg).astype(np.float32)
