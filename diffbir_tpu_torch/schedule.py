"""Diffusion noise-schedule math: host-side numpy tables in float64, and the
training-time forward process on tensors.

The numpy parts of ``diffbir_tpu/schedule.py`` that the samplers and the
stage-2 trainer use (linear betas, zero-terminal-SNR rescale,
guided-diffusion respacing, spaced-sampler and DDIM tables, CFG schedule), copied
because this package does not import the JAX one; plus the ``Schedule``
methods the trainer calls (``q_sample``, ``get_v``, ``target``, ``loss``),
which gather fp32 tables by timestep as the JAX ones do.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch


def linear_betas(n_timestep: int, linear_start: float, linear_end: float) -> np.ndarray:
    """The "linear" training beta schedule (linear in sqrt(beta)), float64."""
    return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2


def enforce_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal SNR is exactly zero (arXiv:2305.08891)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas, axis=0))
    a0, aT = alphas_bar_sqrt[0], alphas_bar_sqrt[-1]
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * (a0 / (a0 - aT))
    alphas_bar = alphas_bar_sqrt**2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def space_timesteps(num_timesteps: int, count: int) -> np.ndarray:
    """Guided-diffusion respacing with one section: ``count`` evenly spaced
    original timesteps (the stride accumulated in float, then rounded)."""
    if count > num_timesteps:
        raise ValueError(f"cannot divide {num_timesteps} steps into {count}")
    stride = 1.0 if count <= 1 else (num_timesteps - 1) / (count - 1)
    taken, cur = [], 0.0
    for _ in range(count):
        taken.append(round(cur))
        cur += stride
    return np.array(sorted(set(taken)), np.int32)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Training noise schedule; ``parameterization`` in {"eps", "v"},
    ``loss_type`` in {"l2", "l1"}."""

    betas: np.ndarray  # float64 [T]
    parameterization: str = "eps"
    loss_type: str = "l2"

    @classmethod
    def create(cls, timesteps: int = 1000, linear_start: float = 1e-4,
               linear_end: float = 2e-2, zero_snr: bool = False,
               parameterization: str = "eps", loss_type: str = "l2") -> "Schedule":
        """Linear betas (the only beta schedule DiffBIR trains with),
        optionally rescaled to zero terminal SNR."""
        if parameterization not in ("eps", "v"):
            raise ValueError(f"unknown parameterization {parameterization!r}")
        if loss_type not in ("l2", "l1"):
            raise ValueError(f"unknown loss type {loss_type!r}")
        betas = linear_betas(timesteps, linear_start, linear_end)
        if zero_snr:
            betas = enforce_zero_terminal_snr(betas)
        return cls(betas=betas, parameterization=parameterization, loss_type=loss_type)

    @classmethod
    def v21(cls) -> "Schedule":
        """DiffBIR v2.1: linear 0.00085..0.012 over 1000 steps, zero terminal
        SNR, v-parameterization (diffusion_v2.1.yaml)."""
        return cls.create(1000, linear_start=0.00085, linear_end=0.0120, zero_snr=True,
                          parameterization="v")

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @functools.cached_property
    def _on_device(self) -> Dict[torch.device, torch.Tensor]:
        """sqrt(alpha_bar) and sqrt(1 - alpha_bar), fp32 [2, T], per device:
        copied at their first use there and kept."""
        return {}

    def _coeffs(self, t: torch.Tensor, ndim: int):
        """sqrt(alpha_bar_t) and sqrt(1 - alpha_bar_t) at integer timesteps t
        [B], each shaped to broadcast against a rank-``ndim`` batch."""
        tab = self._on_device.get(t.device)
        if tab is None:
            ac = np.cumprod(1.0 - self.betas, axis=0)
            tab = torch.as_tensor(np.stack([np.sqrt(ac), np.sqrt(1.0 - ac)]),
                                  dtype=torch.float32).to(t.device)
            self._on_device[t.device] = tab
        out = tab[:, t.long()]
        shape = out.shape[1:] + (1,) * (ndim - out.dim() + 1)
        return out[0].reshape(shape), out[1].reshape(shape)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward diffusion: x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps."""
        a, s = self._coeffs(t, x_start.dim())
        return a * x_start + s * noise

    def get_v(self, x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """v-parameterization target: v = sqrt(ab) eps - sqrt(1 - ab) x0."""
        a, s = self._coeffs(t, x.dim())
        return a * noise - s * x

    def target(self, x_start: torch.Tensor, noise: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
        if self.parameterization == "eps":
            return noise
        return self.get_v(x_start, noise, t)

    def loss(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Mean l2 or l1 over every element."""
        if self.loss_type == "l2":
            return ((pred - target) ** 2).mean()
        return (pred - target).abs().mean()


@dataclasses.dataclass(frozen=True)
class SpacedCoeffs:
    """Per-step float64 tables for the ancestral spaced sampler; index i is
    the spaced step (0 = lowest noise)."""

    timesteps: np.ndarray  # int32 [S]: original-process t of each spaced step
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray


def make_spaced_coeffs(training_betas: np.ndarray, num_steps: int) -> SpacedCoeffs:
    training_alphas_cumprod = np.cumprod(1.0 - training_betas, axis=0)
    used = space_timesteps(len(training_betas), num_steps)
    used_set = set(int(x) for x in used)
    betas = []
    last = 1.0
    for i, ac in enumerate(training_alphas_cumprod):
        if i in used_set:
            betas.append(1 - ac / last)
            last = ac
    betas = np.array(betas, np.float64)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas, axis=0)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    # zero-terminal-SNR schedules end at ac == 0: clamp the eps-space
    # reciprocals to large finite values instead of inf
    ac_recip_safe = np.maximum(ac, 1e-8)
    return SpacedCoeffs(
        timesteps=used.astype(np.int32),
        sqrt_alphas_cumprod=np.sqrt(ac),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac_recip_safe),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac_recip_safe - 1.0),
        posterior_variance=post_var,
        posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
        posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
    )


def make_ddim_timesteps(num_ddim_steps: int, num_ddpm_steps: int,
                        method: str = "uniform") -> np.ndarray:
    """DDIM timestep selection with the +1 shift."""
    if method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        steps = np.asarray(list(range(0, num_ddpm_steps, c)))
        if steps[-1] + 1 >= num_ddpm_steps:
            raise ValueError(
                f"ddim uniform steps={num_ddim_steps} over T={num_ddpm_steps} produces "
                f"timestep {steps[-1] + 1} >= T; pick a step count n with (T // n) not "
                f"dividing T - 1 (e.g. 10, 20, 50)")
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_steps * 0.8), num_ddim_steps) ** 2).astype(int)
    else:
        raise NotImplementedError(method)
    return steps + 1


def make_ddim_params(training_betas: np.ndarray, num_steps: int, eta: float,
                     method: str = "uniform"):
    """(timesteps, alphas, alphas_prev, sigmas) per DDIM step, float64."""
    alphacums = np.cumprod(1.0 - training_betas, axis=0)
    ts = make_ddim_timesteps(num_steps, len(training_betas), method)
    alphas = alphacums[ts]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ts[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return ts, alphas, alphas_prev, sigmas


def cfg_scale_schedule(default_cfg_scale: float, model_t: np.ndarray,
                       rescale: bool) -> np.ndarray:
    """Cosine-ramped CFG scale per original-process timestep."""
    model_t = np.asarray(model_t, np.float64)
    if rescale and default_cfg_scale > 1:
        ramp = (1 - np.cos(np.pi * ((1000 - model_t) / 1000) ** 5.0)) / 2
        return 1 + default_cfg_scale * ramp
    return np.full_like(model_t, default_cfg_scale, dtype=np.float64)
