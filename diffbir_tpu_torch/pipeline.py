"""Two-stage restoration pipeline: cleaner -> ControlLDM -> colour fix.

Counterpart of ``diffbir_tpu/pipeline.py`` on its untiled, unchunked branch
with the spaced sampler. Public arrays are NHWC: uint8 LQ in, uint8 out, with
[0, 1] images and [-1, 1] VAE images in between. Randomness is a
``torch.Generator`` on the device seeded per request (x_T, then the per-step
noise); a caller may instead hand in x_T and the per-step noise table.

Prompts: a pipeline takes a ``tokenizer``, a callable from a list of strings
to int token ids [n, 77], and encodes the prompt text with it, as the JAX
pipeline does. The CLIP BPE tokenizer itself is not ported (its vocabulary is
not in the repository). Without a tokenizer the empty prompt is the
empty-prompt ids (SOT, EOT, zeros) and any other text raises ValueError; the
JAX pipeline encodes every prompt as the empty prompt then, which drops the
text silently.

Not ported yet, and refused with NotImplementedError: samplers other than
``spaced``, tiling, turbo control caching, restoration guidance,
``size_bucket``, noise augmentation and the ``cond`` start point.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.cldm import ControlLDM
from .models.swinir import SwinIR
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


def build_sampler(sampler_type: str, schedule: Schedule, rescale_cfg: bool) -> SpacedSampler:
    if sampler_type != "spaced":
        raise NotImplementedError(f"sampler {sampler_type!r} is not ported yet")
    return SpacedSampler(schedule.betas, schedule.parameterization, rescale_cfg)


class Pipeline:
    """Base pipeline; subclasses override ``apply_cleaner``."""

    def __init__(self, cldm: ControlLDM, schedule: Schedule, device: torch.device,
                 min_cond_size: int = 512,
                 tokenizer: Optional[Callable[[List[str]], np.ndarray]] = None):
        self.cldm = cldm
        self.schedule = schedule
        self.device = torch.device(device)
        self.min_cond_size = min_cond_size
        self.tokenizer = tokenizer
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

    @torch.no_grad()
    def apply_cldm(
        self,
        cond_img: torch.Tensor,
        steps: int,
        strength: float,
        pos_prompt: str,
        neg_prompt: str,
        cfg_scale: float,
        sampler_type: str = "spaced",
        rescale_cfg: bool = False,
        generator: Optional[torch.Generator] = None,
        x_T: Optional[torch.Tensor] = None,
        noise_table: Optional[torch.Tensor] = None,
        clock: Optional[StageClock] = None,
    ) -> torch.Tensor:
        """Stage 2 on a [0, 1] NHWC condition image -> [-1, 1] NHWC fp32.

        Noise comes from ``generator`` (x_T first, then one draw per step) or
        from ``x_T`` and ``noise_table`` together."""
        clock = clock or StageClock(None, self.device)
        cldm = self.cldm
        bs, h0, w0, _ = cond_img.shape
        cond_img = pad_to_multiples_of(cond_img, 64)
        h1, w1 = cond_img.shape[1] // 8, cond_img.shape[2] // 8
        sampler = build_sampler(sampler_type, self.schedule, rescale_cfg)
        cond = cldm.prepare_condition(cond_img, self.tokenize(pos_prompt, bs))
        uncond = None
        if cfg_scale != 1.0:
            # the condition image is the same, so only the text differs
            uncond = dict(c_txt=cldm.encode_text(self.tokenize(neg_prompt, bs)),
                          c_img=cond["c_img"])
        clock.lap("condition")
        shape = (bs, h1, w1, 4)
        if x_T is None:
            if generator is None or noise_table is not None:
                raise ValueError("pass a generator, or x_T with a noise_table")
            x_T = torch.randn(shape, generator=generator, dtype=torch.float32,
                              device=self.device)
        elif tuple(x_T.shape) != shape:
            raise ValueError(f"x_T shape {tuple(x_T.shape)} != {shape}")

        def model_fn(x, t, c):
            return cldm(x, t, c, control_scales=strength)

        z = sampler.sample(model_fn, x_T.to(self.device), cond, uncond, cfg_scale, steps,
                           generator=None if noise_table is not None else generator,
                           noise_table=noise_table)
        clock.lap("denoise")
        x = cldm.vae_decode(z)
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
        x_T: Optional[torch.Tensor] = None,
        noise_table: Optional[torch.Tensor] = None,
        timings: Optional[Dict[str, float]] = None,
        **sampler_kwargs,
    ) -> np.ndarray:
        """lq: uint8 [B, H, W, 3] -> restored uint8 [B, *output_size, 3].

        ``timings``: when a dict is given, seconds per stage (cleaner,
        condition, denoise, decode, colour_fix) are added to it, each stage
        ended by a device sync."""
        if start_point_type != "noise" or noise_aug:
            raise NotImplementedError("the cond start point and noise_aug are not ported yet")
        if cleaner_tiled or size_bucket:
            raise NotImplementedError("tiling and size_bucket are not ported yet")
        if sampler_kwargs:
            raise NotImplementedError(
                f"not ported yet (tiling, turbo, other samplers): {sorted(sampler_kwargs)}")
        clock = StageClock(timings, self.device)
        lq_t = torch.as_tensor(np.asarray(lq), device=self.device).float().div(255.0).clamp(0, 1)
        self.set_output_size(tuple(lq_t.shape[1:3]))
        cond_img = self.apply_cleaner(lq_t)
        if any(s < self.min_cond_size for s in cond_img.shape[1:3]):
            raise ValueError(f"stage-1 output must be >= {self.min_cond_size}")
        clock.lap("cleaner")
        generator = None
        if x_T is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        sample = self.apply_cldm(cond_img, steps, strength, pos_prompt, neg_prompt,
                                 cfg_scale, sampler_type, rescale_cfg, generator=generator, x_T=x_T,
                                 noise_table=noise_table, clock=clock)
        sample = wavelet_reconstruction((sample + 1) / 2, cond_img)
        sample = bicubic_resize(sample, self.output_size)
        out = (sample * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
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
                 tokenizer: Optional[Callable[[List[str]], np.ndarray]] = None):
        super().__init__(cldm, schedule, device, min_cond_size, tokenizer)
        self.cleaner = cleaner

    def apply_cleaner(self, lq: torch.Tensor) -> torch.Tensor:
        if min(lq.shape[1:3]) < self.min_cond_size:
            lq = resize_short_edge_to(lq, self.min_cond_size)
        h0, w0 = lq.shape[1:3]
        out = self.cleaner(pad_to_multiples_of(lq, 64)).clamp(0.0, 1.0)
        return out[:, :h0, :w0, :]
