"""Ancestral DDPM sampling on a respaced schedule.

Counterpart of ``diffbir_tpu/sampler/spaced.py``: the same host-side table of
per-step coefficients (``make_tables``), walked by a Python loop instead of a
``lax.scan``. The state is fp32. Per-step noise comes from a
``torch.Generator``, or from a pre-drawn table (one row per step, as the JAX
EDM sampler's ``noise_table``) so that a test can feed in JAX's draws.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..schedule import make_spaced_coeffs
from .base import ModelFn, Sampler, cfg_model_call


class SpacedSampler(Sampler):
    def make_tables(self, steps: int, cfg_scale: float) -> dict:
        """Per-step fp32 coefficient rows, high noise -> low noise."""
        c = make_spaced_coeffs(self.training_betas, steps)
        order = np.arange(steps)[::-1]
        model_ts = c.timesteps[order]
        return {
            "model_t": model_ts.astype(np.float32),
            "sqrt_recip": c.sqrt_recip_alphas_cumprod[order].astype(np.float32),
            "sqrt_recipm1": c.sqrt_recipm1_alphas_cumprod[order].astype(np.float32),
            "sqrt_ac": c.sqrt_alphas_cumprod[order].astype(np.float32),
            "sqrt_omac": c.sqrt_one_minus_alphas_cumprod[order].astype(np.float32),
            "coef1": c.posterior_mean_coef1[order].astype(np.float32),
            "coef2": c.posterior_mean_coef2[order].astype(np.float32),
            "sqrt_var": np.sqrt(c.posterior_variance[order]).astype(np.float32),
            "nonzero": (order != 0).astype(np.float32),
            "cfg": self.cfg_scales(cfg_scale, model_ts),
        }

    @torch.no_grad()
    def sample(
        self,
        model_fn: ModelFn,
        x_T: torch.Tensor,
        cond: Mapping[str, torch.Tensor],
        uncond: Optional[Mapping[str, torch.Tensor]],
        cfg_scale: float,
        steps: int,
        generator: Optional[torch.Generator] = None,
        noise_table: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Denoise ``x_T`` (fp32 NHWC). Exactly one of ``generator`` and
        ``noise_table`` ([steps, *x_T.shape]) supplies the per-step noise."""
        if (generator is None) == (noise_table is None):
            raise ValueError("pass exactly one of generator and noise_table")
        if noise_table is not None and tuple(noise_table.shape) != (steps, *x_T.shape):
            raise ValueError(f"noise_table shape {tuple(noise_table.shape)} != "
                             f"{(steps, *x_T.shape)}")
        tables = self.make_tables(steps, cfg_scale)
        x = x_T.float()
        bs = x.shape[0]
        for i in range(steps):
            row = {k: float(v[i]) for k, v in tables.items()}
            t = torch.full((bs,), row["model_t"], dtype=torch.float32, device=x.device)
            out = cfg_model_call(model_fn, x, t, cond, uncond, row["cfg"]).float()
            if self.parameterization == "eps":
                x0 = row["sqrt_recip"] * x - row["sqrt_recipm1"] * out
            else:
                x0 = row["sqrt_ac"] * x - row["sqrt_omac"] * out
            mean = row["coef1"] * x0 + row["coef2"] * x
            if noise_table is not None:
                noise = noise_table[i].to(device=x.device, dtype=torch.float32)
            else:
                noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                                    device=x.device)
            x = mean + row["nonzero"] * row["sqrt_var"] * noise
        return x
