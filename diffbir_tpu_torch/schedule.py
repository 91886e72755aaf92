"""Diffusion noise-schedule math: host-side numpy, float64.

The numpy parts of ``diffbir_tpu/schedule.py`` that the spaced sampler uses
(linear betas, zero-terminal-SNR rescale, guided-diffusion respacing,
spaced-sampler tables, CFG schedule), copied because this package does not
import the JAX one.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
    """Training noise schedule; ``parameterization`` in {"eps", "v"}."""

    betas: np.ndarray  # float64 [T]
    parameterization: str = "eps"

    @classmethod
    def v21(cls) -> "Schedule":
        """DiffBIR v2.1: linear 0.00085..0.012 over 1000 steps, zero terminal
        SNR, v-parameterization (diffusion_v2.1.yaml)."""
        betas = enforce_zero_terminal_snr(linear_betas(1000, 0.00085, 0.0120))
        return cls(betas=betas, parameterization="v")


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


def cfg_scale_schedule(default_cfg_scale: float, model_t: np.ndarray,
                       rescale: bool) -> np.ndarray:
    """Cosine-ramped CFG scale per original-process timestep."""
    model_t = np.asarray(model_t, np.float64)
    if rescale and default_cfg_scale > 1:
        ramp = (1 - np.cos(np.pi * ((1000 - model_t) / 1000) ** 5.0)) / 2
        return 1 + default_cfg_scale * ramp
    return np.full_like(model_t, default_cfg_scale, dtype=np.float64)
