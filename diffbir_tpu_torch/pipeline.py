"""Two-stage restoration pipeline: cleaner -> ControlLDM -> colour fix.

Counterpart of ``diffbir_tpu/pipeline.py`` on its untiled, unchunked branch.
Public arrays are NHWC: uint8 LQ in, uint8 out, with [0, 1] images and
[-1, 1] VAE images in between.

- Samplers: every entry of ``SAMPLER_CHOICES`` (``build_sampler``), with
  ``eta``, ``s_churn``, ``s_tmin``, ``s_tmax``, ``s_noise`` and ``order``.
- Start point "noise" (x_T ~ N(0, I)) or "cond" (the condition latent
  diffused to the last training step); ``noise_aug`` diffuses the
  condition latent to that step; ``size_bucket`` pads the LQ (reflect) to
  x64 and the condition to multiples of the bucket, and crops back.
- Hoisting (``hoist``, on by default as in JAX): the cross-attention k/v of
  the prompts and the ResBlocks' timestep tables for the sampler's grid are
  computed once per request (``cldm.make_hoist_tables``); each step takes
  its rows by the host value of its model timestep.
- Randomness: one ``torch.Generator`` on the device per request, seeded
  with ``seed``, draws the start noise, then the augmentation noise, then
  the sampler's noise. A caller may hand in ``x_T`` (the start point's
  standard-normal draw: x_T itself, or for "cond" the noise mixed into the
  condition), ``aug_noise`` and the sampler's ``noise_table`` instead.

Prompts: a pipeline takes a ``tokenizer``, a callable from a list of strings
to int token ids [n, 77] (``models.tokenizer.ClipTokenizer``), and encodes
the prompt text with it. Without one the empty prompt is the empty-prompt
ids (SOT, EOT, zeros) and any other text raises ValueError; the JAX pipeline
encodes every prompt as the empty prompt then, which drops the text
silently.

Not ported yet, and refused with NotImplementedError naming the option:
tiling (cleaner, VAE, diffusion), turbo control caching and restoration
guidance.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .models.cldm import ControlLDM, HoistTables
from .models.swinir import SwinIR
from .sampler.base import ModelFn, Sampler, timestep_vector
from .sampler.ddim import DDIMSampler
from .sampler.dpms import DPMSolverSampler
from .sampler.edm import EDMSampler
from .sampler.spaced import SpacedSampler
from .schedule import Schedule
from .utils.common import (
    StageClock,
    bicubic_resize,
    pad_to_multiples_of,
    resize_short_edge_to,
    wavelet_reconstruction,
)

SOT, EOT = 49406, 49407

SAMPLER_CHOICES = [
    "dpm++_m2", "spaced", "ddim",
    "edm_euler", "edm_euler_a", "edm_heun", "edm_dpm_2", "edm_dpm_2_a",
    "edm_lms", "edm_dpm++_2s_a", "edm_dpm++_sde", "edm_dpm++_2m",
    "edm_dpm++_2m_sde", "edm_dpm++_3m_sde",
    "dpm++_m1", "dpm++_m3", "dpm++_s2", "dpm++_s3", "dpm_m2", "dpm_m3",
    "edm_dpm_fast", "edm_dpm_adaptive",
]


def build_sampler(sampler_type: str, schedule: Schedule, rescale_cfg: bool,
                  eta: float = 0.0, s_churn: float = 0.0, s_tmin: float = 0.0,
                  s_tmax: float = 300.0, s_noise: float = 1.0, order: int = 1) -> Sampler:
    """The sampler of ``sampler_type``, by the JAX ``build_sampler``'s
    dispatch (DDIM always at eta 0, as the reference pipeline runs it)."""
    betas, param = schedule.betas, schedule.parameterization
    if sampler_type == "spaced":
        return SpacedSampler(betas, param, rescale_cfg)
    if sampler_type == "ddim":
        return DDIMSampler(betas, param, rescale_cfg, eta=0.0)
    if sampler_type.startswith("dpm"):
        return DPMSolverSampler(betas, param, rescale_cfg, sampler_type)
    if sampler_type.startswith("edm"):
        return EDMSampler(betas, param, rescale_cfg, sampler_type, s_churn=s_churn,
                          s_tmin=s_tmin, s_tmax=s_tmax, s_noise=s_noise, eta=eta, order=order)
    raise NotImplementedError(sampler_type)


def model_function(cldm: ControlLDM, strength: float = 1.0,
                   tables: Optional[HoistTables] = None) -> ModelFn:
    """The sampler's ``model_fn`` of a request: the ControlLDM at control
    scale ``strength`` on the step's [B] timestep vector, with the step's
    rows of ``tables`` when hoisting (the pipeline's and profile_step's)."""
    def model_fn(x, t, c):
        return cldm(x, timestep_vector(t, x), c, control_scales=strength,
                    hoisted=None if tables is None else tables.lookup(t))

    return model_fn


def _pad_nhwc(x: torch.Tensor, ph: int, pw: int, mode: str) -> torch.Tensor:
    """Pad an NHWC batch at the bottom and right ("reflect" or "replicate")."""
    return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode).permute(0, 2, 3, 1)


class Pipeline:
    """Base pipeline; subclasses override ``apply_cleaner``."""

    def __init__(self, cldm: ControlLDM, schedule: Schedule, device: torch.device,
                 min_cond_size: int = 512,
                 tokenizer: Optional[Callable[[List[str]], np.ndarray]] = None,
                 hoist: bool = True):
        self.cldm = cldm
        self.schedule = schedule
        self.device = torch.device(device)
        self.min_cond_size = min_cond_size
        self.tokenizer = tokenizer
        self.hoist = hoist
        self.output_size: Tuple[int, int] = None

    def set_output_size(self, lq_hw: Tuple[int, int]) -> None:
        self.output_size = lq_hw

    def apply_cleaner(self, lq: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def tokenize(self, prompt: str, bs: int) -> torch.Tensor:
        """The tokenizer's ids of ``prompt`` repeated ``bs`` times; without a
        tokenizer the empty-prompt ids (SOT, EOT, padding) for "", and
        ValueError for any other text."""
        if self.tokenizer is not None:
            ids = torch.as_tensor(np.asarray(self.tokenizer([prompt])), dtype=torch.long)
            return ids.repeat(bs, 1).to(self.device)
        if prompt:
            raise ValueError(f"prompt text {prompt!r} needs a tokenizer: pass tokenizer= to "
                             "the pipeline, or empty prompts")
        t = torch.zeros((bs, self.cldm.clip.context_length), dtype=torch.long,
                        device=self.device)
        t[:, 0], t[:, 1] = SOT, EOT
        return t

    def _normal(self, shape, generator: Optional[torch.Generator],
                given: Optional[torch.Tensor], name: str) -> torch.Tensor:
        if given is not None:
            if tuple(given.shape) != tuple(shape):
                raise ValueError(f"{name} shape {tuple(given.shape)} != {tuple(shape)}")
            return given.to(self.device, torch.float32)
        if generator is None:
            raise ValueError(f"pass a generator, or {name}")
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def apply_cldm(
        self,
        cond_img: torch.Tensor,
        steps: int,
        strength: float,
        pos_prompt: str,
        neg_prompt: str,
        cfg_scale: float,
        start_point_type: str = "noise",
        sampler_type: str = "spaced",
        noise_aug: int = 0,
        rescale_cfg: bool = False,
        generator: Optional[torch.Generator] = None,
        x_T: Optional[torch.Tensor] = None,
        aug_noise: Optional[torch.Tensor] = None,
        noise_table: Optional[torch.Tensor] = None,
        clock: Optional[StageClock] = None,
        **sampler_kwargs,
    ) -> torch.Tensor:
        """Stage 2 on a [0, 1] NHWC condition image -> [-1, 1] NHWC fp32.

        Noise comes from ``generator`` (start, augmentation, then the
        sampler's draws) or from ``x_T``, ``aug_noise`` (with ``noise_aug``)
        and ``noise_table`` (for a sampler that draws) given in its place."""
        if start_point_type not in ("noise", "cond"):
            raise ValueError(f"unknown start point {start_point_type!r}")
        clock = clock or StageClock(None, self.device)
        cldm = self.cldm
        bs, h0, w0, _ = cond_img.shape
        cond_img = pad_to_multiples_of(cond_img, 64)
        h1, w1 = cond_img.shape[1] // 8, cond_img.shape[2] // 8
        sampler = build_sampler(sampler_type, self.schedule, rescale_cfg, **sampler_kwargs)
        use_cfg = cfg_scale != 1.0
        cond = cldm.prepare_condition(cond_img, self.tokenize(pos_prompt, bs))
        uncond = None
        if use_cfg:
            # the condition image is the same, so only the text differs
            uncond = dict(c_txt=cldm.encode_text(self.tokenize(neg_prompt, bs)),
                          c_img=cond["c_img"])
        clock.lap("condition")
        shape = tuple(cond["c_img"].shape)
        start = self._normal(shape, generator if x_T is None else None, x_T, "x_T")
        if start_point_type == "cond":
            t_last = torch.full((bs,), self.schedule.num_timesteps - 1, dtype=torch.long,
                                device=self.device)
            start = self.schedule.q_sample(cond["c_img"].float(), t_last, start)
        if noise_aug > 0:
            t_aug = torch.full((bs,), noise_aug, dtype=torch.long, device=self.device)
            z = self._normal(shape, generator if aug_noise is None else None, aug_noise,
                             "aug_noise")
            c_img = self.schedule.q_sample(cond["c_img"].float(), t_aug, z)
            cond = {**cond, "c_img": c_img}
            if uncond is not None:
                uncond = {**uncond, "c_img": c_img}
        tables = None
        if self.hoist:
            ctx_full = (cond["c_txt"] if uncond is None
                        else torch.cat([cond["c_txt"], uncond["c_txt"]], dim=0))
            tables = cldm.make_hoist_tables(ctx_full, sampler.model_ts(steps))
        clock.lap("hoist")
        z = sampler.sample(model_function(cldm, strength, tables), start, cond, uncond,
                           cfg_scale, steps,
                           generator=None if noise_table is not None else generator,
                           noise_table=noise_table)
        clock.lap("denoise")
        x = cldm.vae_decode(z[:, :h1, :w1, :])
        clock.lap("decode")
        return x[:, :h0, :w0, :]

    @torch.no_grad()
    def run(
        self,
        lq: np.ndarray,
        steps: int = 50,
        strength: float = 1.0,
        pos_prompt: str = "",
        neg_prompt: str = "low quality, blurry, low-resolution, noisy, unsharp, weird textures",
        cfg_scale: float = 4.0,
        start_point_type: str = "noise",
        sampler_type: str = "spaced",
        noise_aug: int = 0,
        rescale_cfg: bool = False,
        cleaner_tiled: bool = False,
        seed: int = 231,
        size_bucket: int = 0,
        eta: float = 0.0,
        s_churn: float = 0.0,
        s_tmin: float = 0.0,
        s_tmax: float = 300.0,
        s_noise: float = 1.0,
        order: int = 1,
        x_T: Optional[torch.Tensor] = None,
        aug_noise: Optional[torch.Tensor] = None,
        noise_table: Optional[torch.Tensor] = None,
        timings: Optional[Dict[str, float]] = None,
        **unported,
    ) -> np.ndarray:
        """lq: uint8 [B, H, W, 3] -> restored uint8 [B, *output_size, 3].

        ``timings``: when a dict is given, seconds per stage (cleaner,
        condition, hoist, denoise, decode, colour_fix) are added to it, each
        stage ended by a device sync."""
        if cleaner_tiled:
            raise NotImplementedError("cleaner_tiled: tiling is not ported yet")
        if unported:
            raise NotImplementedError(
                f"not ported yet (tiling, turbo, guidance): {sorted(unported)}")
        clock = StageClock(timings, self.device)
        lq = np.asarray(lq)
        orig_hw = lq.shape[1:3]
        if size_bucket:
            ph, pw = (-lq.shape[1]) % 64, (-lq.shape[2]) % 64
            if ph or pw:
                lq = np.pad(lq, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
        lq_t = torch.as_tensor(lq, device=self.device).float().div(255.0).clamp(0, 1)
        self.set_output_size(tuple(lq_t.shape[1:3]))
        cond_img = self.apply_cleaner(lq_t)
        if any(s < self.min_cond_size for s in cond_img.shape[1:3]):
            raise ValueError(f"stage-1 output must be >= {self.min_cond_size}")
        ch, cw = cond_img.shape[1:3]
        if size_bucket:
            pch, pcw = (-ch) % size_bucket, (-cw) % size_bucket
            if pch or pcw:
                mode = "reflect" if (pch < ch and pcw < cw) else "replicate"
                cond_img = _pad_nhwc(cond_img, pch, pcw, mode)
        clock.lap("cleaner")
        generator = None
        if x_T is None or (noise_aug > 0 and aug_noise is None) or noise_table is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        sample = self.apply_cldm(
            cond_img, steps, strength, pos_prompt, neg_prompt, cfg_scale,
            start_point_type=start_point_type, sampler_type=sampler_type, noise_aug=noise_aug,
            rescale_cfg=rescale_cfg, generator=generator, x_T=x_T, aug_noise=aug_noise,
            noise_table=noise_table, clock=clock, eta=eta, s_churn=s_churn, s_tmin=s_tmin,
            s_tmax=s_tmax, s_noise=s_noise, order=order)
        if size_bucket and (ch, cw) != tuple(sample.shape[1:3]):
            sample, cond_img = sample[:, :ch, :cw], cond_img[:, :ch, :cw]
        sample = wavelet_reconstruction((sample + 1) / 2, cond_img)
        sample = bicubic_resize(sample, self.output_size)
        out = (sample * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        if size_bucket and tuple(orig_hw) != tuple(lq.shape[1:3]):
            oh = round(orig_hw[0] * self.output_size[0] / lq.shape[1])
            ow = round(orig_hw[1] * self.output_size[1] / lq.shape[2])
            out = out[:, :oh, :ow]
        clock.lap("colour_fix")
        return out


class IdentityCleanerPipeline(Pipeline):
    """Bicubic-only stage 1."""

    def apply_cleaner(self, lq: torch.Tensor) -> torch.Tensor:
        if min(lq.shape[1:3]) < self.min_cond_size:
            lq = resize_short_edge_to(lq, self.min_cond_size)
        return lq


class SwinIRPipeline(Pipeline):
    """x1 SwinIR cleaner on a pre-upscaled input, output clipped to [0, 1]."""

    def __init__(self, cleaner: SwinIR, cldm: ControlLDM, schedule: Schedule,
                 device: torch.device, min_cond_size: int = 512,
                 tokenizer: Optional[Callable[[List[str]], np.ndarray]] = None,
                 hoist: bool = True):
        super().__init__(cldm, schedule, device, min_cond_size, tokenizer, hoist)
        self.cleaner = cleaner

    def apply_cleaner(self, lq: torch.Tensor) -> torch.Tensor:
        if min(lq.shape[1:3]) < self.min_cond_size:
            lq = resize_short_edge_to(lq, self.min_cond_size)
        h0, w0 = lq.shape[1:3]
        out = self.cleaner(pad_to_multiples_of(lq, 64)).clamp(0.0, 1.0)
        return out[:, :h0, :w0, :]
