"""DDIM sampling as a host loop over per-step rows.

Counterpart of ``diffbir_tpu/sampler/ddim.py``: uniform or quad timestep
selection with the +1 shift, sigma(eta), the v -> eps conversion and
batched CFG; the rows are the JAX scan's fp32 tables. With ``eta`` 0 (the
pipeline's setting, as in the reference) no noise is drawn; otherwise one
draw per step, row i of a ``noise_table`` [steps, *x]. With ``cond_fn``
(restoration guidance) pred_x0 takes the guidance rounds where
``guidance_gate`` allows and e_t follows it, on every step, as in JAX.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..schedule import make_ddim_params
from .base import GuidedModel, ModelFn, NoiseSource, Sampler, apply_guidance, guidance_gate


class DDIMSampler(Sampler):
    def __init__(self, betas, parameterization, rescale_cfg, eta: float = 0.0):
        super().__init__(betas, parameterization, rescale_cfg)
        self.eta = eta

    def model_ts(self, steps: int) -> np.ndarray:
        return make_ddim_params(self.training_betas, steps, self.eta, "uniform")[0].astype(
            np.float32)

    def make_tables(self, steps: int, cfg_scale: float, discretize: str = "uniform") -> dict:
        """Per-step fp32 rows, high noise -> low noise."""
        ts, alphas, alphas_prev, sigmas = make_ddim_params(
            self.training_betas, steps, self.eta, discretize)
        order = np.arange(len(ts))[::-1]
        return {
            "model_t": ts[order].astype(np.float32),
            "a_t": alphas[order].astype(np.float32),
            "a_prev": alphas_prev[order].astype(np.float32),
            "sigma": sigmas[order].astype(np.float32),
            "cfg": self.cfg_scales(cfg_scale, ts[order]),
        }

    @torch.no_grad()
    def sample(self, model_fn: ModelFn, x_T: torch.Tensor, cond: Mapping[str, torch.Tensor],
               uncond: Optional[Mapping[str, torch.Tensor]], cfg_scale: float, steps: int,
               generator: Optional[torch.Generator] = None,
               noise_table: Optional[torch.Tensor] = None,
               discretize: str = "uniform", cond_fn=None,
               guidance_target: Optional[torch.Tensor] = None) -> torch.Tensor:
        tables = self.make_tables(steps, cfg_scale, discretize)
        if cond_fn is not None:
            g_on = guidance_gate(cond_fn, tables["model_t"])
        if noise_table is not None and tuple(noise_table.shape) != (steps, *x_T.shape):
            raise ValueError(f"noise_table shape {tuple(noise_table.shape)} != "
                             f"{(steps, *x_T.shape)}")
        noise = (NoiseSource(x_T.shape, x_T.device, generator, noise_table)
                 if generator is not None or noise_table is not None else None)
        model = GuidedModel(model_fn, cond, uncond)
        v_param = self.parameterization == "v"
        x = x_T.float()
        for i in range(len(tables["model_t"])):
            row = {k: v[i] for k, v in tables.items()}
            out = model(x, float(row["model_t"]), float(row["cfg"])).float()
            # the square roots in fp32, as the JAX scan takes them
            sqrt_a = float(np.sqrt(row["a_t"]))
            sqrt_oma = float(np.sqrt(np.float32(1.0) - row["a_t"]))
            e_t = sqrt_a * out + sqrt_oma * x if v_param else out
            pred_x0 = (x - sqrt_oma * e_t) / sqrt_a
            if cond_fn is not None:
                pred_x0 = apply_guidance(cond_fn, guidance_target, pred_x0, g_on[i])
                # keep the ODE direction consistent with the guided x0
                e_t = (x - sqrt_a * pred_x0) / sqrt_oma
            dir_xt = float(np.sqrt(np.float32(1.0) - row["a_prev"] - row["sigma"] ** 2)) * e_t
            x = float(np.sqrt(row["a_prev"])) * pred_x0 + dir_xt
            if row["sigma"] != 0:
                if noise is None:
                    raise ValueError("eta > 0 needs a generator or a noise_table")
                x = x + float(row["sigma"]) * noise.draw(i)
        return x
