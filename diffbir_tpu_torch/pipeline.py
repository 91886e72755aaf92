"""Two-stage restoration pipeline: cleaner -> ControlLDM -> colour fix.

Counterpart of ``diffbir_tpu/pipeline.py`` without its chunked dispatch.
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

Tiling (the JAX size and tile policy): the condition pads to x64 untiled,
to x8 when the VAE encoder or the diffusion is tiled; each tiling is
switched off for an input smaller than its tile (decided on the padded
size); the VAE encoder's tile must be a multiple of 8 and the diffusion's
and the cleaner's of 64 (ValueError). The VAE tiles in "blend" or "sync_gn"
mode (``cldm.vae_encode``/``vae_decode``); sync_gn falls back to blend at
batch > 1. The tiled diffusion (``tiled_model_function``) runs each step's
model call over latent tiles in groups of ``cldm_tiles_per_batch``,
slicing the condition latent at each tile and repeating the text context
per tile; hoisting is off there, as in JAX (the call batch changes per
group). The cleaner pipelines tile their cleaner with ``make_tiled_fn``:
SwinIR and SCUNet at x1, BSRNet at x4.

Cleaners (``CleanerPipeline``, the JAX pipelines' ``cleaner_apply``
clipped to [0, 1]): ``SwinIRPipeline`` (x1 on a pre-upscaled input, padded
to x64), ``BSRNetPipeline`` (x4 on the LQ, then bicubic to lq x
``upscale``) and ``SCUNetPipeline`` (x1 on a pre-upscaled input).

Turbo (``control_interval`` k > 1, the JAX order of checks): the ControlNet
runs on every k-th model call only (``cldm.make_cached_control_model``),
with ``turbo_encoder`` the UNet's encoder too; the hoisted rows apply on
refreshed and cached calls alike. Only the samplers that call the model
once a step take it (``TURBO_SAMPLERS``), and not the tiled diffusion
(ValueError); a request makes a fresh cache.

Restoration guidance: a pipeline holds a ``cond_fn`` (``utils.cond_fn``, set
as the JAX loop sets it) and hands it to spaced, ddim and the ``edm_*``
samplers; the others raise ValueError. Latent guidance pulls x0 toward the
condition latent as encoded (x8-padded, before ``noise_aug``); RGB guidance
toward ``cond_img * 2 - 1``, through ``cldm.vae_decode`` inside the
gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .models.cldm import ControlLDM, HoistTables
from .models.denoiser_graph import DenoiserCall
from .sampler.base import ModelFn, Sampler, timestep_vector
from .sampler.ddim import DDIMSampler
from .sampler.dpms import DPMSolverSampler
from .sampler.edm import EDMSampler
from .sampler.spaced import SpacedSampler
from .schedule import Schedule
from .tiling import make_tiled_fn
from .utils.cond_fn import RGBSpaceGuidance
from .utils.common import (
    StageClock,
    bicubic_resize,
    host_to_device,
    pad_to_multiples_of,
    resize_short_edge_to,
    wavelet_reconstruction,
)

SOT, EOT = 49406, 49407
# the samplers that take a stateful (turbo) model function: one model call a
# step, in order
TURBO_SAMPLERS = ("spaced", "ddim", "edm_dpm++_3m_sde", "edm_dpm++_2m_sde", "edm_euler_a")

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
    rows of ``tables`` when hoisting (the pipeline's and profile_step's),
    replayed as a CUDA graph where the call shows that to be safe
    (``models.denoiser_graph``)."""
    return DenoiserCall(cldm, strength, tables)


def tile_model_function(cldm: ControlLDM, strength: float, lat_tile: int):
    """The model function of one group of latent tiles: ``x_tiles`` [k B,
    lat_tile, lat_tile, 4] (tile-major) at the latent corners
    ``tile_coords``; each tile's condition latent sliced there, the text
    context and the timestep repeated k times."""
    def model_tile(x_tiles, t, c, tile_coords=()):
        k = len(tile_coords)
        c_img = torch.cat([c["c_img"][:, hi: hi + lat_tile, wi: wi + lat_tile]
                           for hi, wi in tile_coords], dim=0)
        c_txt = c["c_txt"].repeat(k, 1, 1)
        return cldm(x_tiles, timestep_vector(t, x_tiles), {"c_txt": c_txt, "c_img": c_img},
                    control_scales=strength)

    return model_tile


def tiled_model_function(cldm: ControlLDM, strength: float, tile_size: int, tile_stride: int,
                         tiles_per_batch: int = 1) -> ModelFn:
    """The tiled diffusion's ``model_fn``: each step's call over latent
    tiles of ``tile_size`` / 8 at ``tile_stride`` / 8, ``tiles_per_batch``
    tiles per model call, Gaussian-blended (``tiling.make_tiled_fn``)."""
    lat_tile = tile_size // 8
    return make_tiled_fn(tile_model_function(cldm, strength, lat_tile), lat_tile,
                         tile_stride // 8, channel=4, tiles_per_batch=tiles_per_batch)


def _pad_nhwc(x: torch.Tensor, ph: int, pw: int, mode: str) -> torch.Tensor:
    """Pad an NHWC batch at the bottom and right ("reflect" or "replicate")."""
    return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode).permute(0, 2, 3, 1)


class Pipeline:
    """Base pipeline; subclasses override ``apply_cleaner``."""

    def __init__(self, cldm: ControlLDM, schedule: Schedule, device: torch.device,
                 min_cond_size: int = 512,
                 tokenizer: Optional[Callable[[List[str]], np.ndarray]] = None,
                 hoist: bool = True, cond_fn=None):
        self.cldm = cldm
        self.schedule = schedule
        self.device = torch.device(device)
        self.min_cond_size = min_cond_size
        self.tokenizer = tokenizer
        self.hoist = hoist
        self.cond_fn = cond_fn
        self.output_size: Tuple[int, int] = None

    def set_output_size(self, lq_hw: Tuple[int, int]) -> None:
        self.output_size = lq_hw

    def apply_cleaner(self, lq: torch.Tensor, tiled: bool = False, tile_size: int = 512,
                      tile_stride: int = 256) -> torch.Tensor:
        raise NotImplementedError

    def tokenize(self, prompt: str, bs: int) -> torch.Tensor:
        """The tokenizer's ids of ``prompt`` repeated ``bs`` times; without a
        tokenizer the empty-prompt ids (SOT, EOT, padding) for "", and
        ValueError for any other text."""
        if self.tokenizer is not None:
            ids = torch.as_tensor(np.asarray(self.tokenizer([prompt])), dtype=torch.long)
            return host_to_device(ids.repeat(bs, 1), self.device)
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
        vae_encoder_tiled: bool = False,
        vae_encoder_tile_size: int = 256,
        vae_decoder_tiled: bool = False,
        vae_decoder_tile_size: int = 256,
        vae_tile_mode: str = "blend",
        cldm_tiled: bool = False,
        cldm_tile_size: int = 512,
        cldm_tile_stride: int = 256,
        cldm_tiles_per_batch: int = 1,
        control_interval: int = 1,
        turbo_encoder: bool = False,
        **sampler_kwargs,
    ) -> torch.Tensor:
        """Stage 2 on a [0, 1] NHWC condition image -> [-1, 1] NHWC fp32.

        Noise comes from ``generator`` (start, augmentation, then the
        sampler's draws) or from ``x_T``, ``aug_noise`` (with ``noise_aug``)
        and ``noise_table`` (for a sampler that draws) given in its place.
        The tiling arguments follow the JAX ``apply_cldm`` (see the module's
        notes); x_T and the noise then have the padded latent's shape."""
        if start_point_type not in ("noise", "cond"):
            raise ValueError(f"unknown start point {start_point_type!r}")
        cond_fn = self.cond_fn
        if cond_fn is not None and not (
                sampler_type in ("spaced", "ddim") or sampler_type.startswith("edm")):
            raise ValueError(f"restoration guidance is not supported with sampler "
                             f"{sampler_type!r}; use spaced, ddim, or an edm_* sampler")
        own_clock = clock is None
        clock = clock or StageClock(None, self.device)
        cldm = self.cldm
        bs, h0, w0, _ = cond_img.shape
        # pad by the requested tiling, then decide the tiny-input disables
        # on the padded size (the JAX order)
        cond_img = pad_to_multiples_of(cond_img, 8 if vae_encoder_tiled or cldm_tiled else 64)
        if vae_encoder_tiled and min(cond_img.shape[1:3]) < vae_encoder_tile_size:
            vae_encoder_tiled = False
        if vae_encoder_tiled and vae_encoder_tile_size % 8 != 0:
            raise ValueError("VAE encoder tile size must be a multiple of 8")
        h1, w1 = cond_img.shape[1] // 8, cond_img.shape[2] // 8
        if cldm_tiled and (h1 < cldm_tile_size // 8 or w1 < cldm_tile_size // 8):
            cldm_tiled = False
        if cldm_tiled and cldm_tile_size % 64 != 0:
            raise ValueError("Diffusion tile size must be a multiple of 64")
        if vae_decoder_tiled and min(h1, w1) < vae_decoder_tile_size // 8:
            vae_decoder_tiled = False
        if control_interval > 1 and cldm_tiled:
            raise ValueError(
                "control_interval > 1 (turbo) is not supported with cldm_tiled — the per-tile "
                "ControlNet calls cannot share one residual cache; drop one of the two flags")
        turbo = control_interval > 1
        if turbo and sampler_type not in TURBO_SAMPLERS:
            raise ValueError("control_interval > 1 requires a stateful-scan sampler "
                             f"(one of {', '.join(TURBO_SAMPLERS)})")
        # sync_gn tiling is batch 1 only: blend for larger batches (encoder and decoder)
        tile_mode = vae_tile_mode if bs == 1 else "blend"
        sampler = build_sampler(sampler_type, self.schedule, rescale_cfg, **sampler_kwargs)
        use_cfg = cfg_scale != 1.0
        cond = cldm.prepare_condition(cond_img, self.tokenize(pos_prompt, bs),
                                      tiled=vae_encoder_tiled, tile_size=vae_encoder_tile_size,
                                      tile_mode=tile_mode)
        if not cldm_tiled:
            # the untiled UNet needs a latent of x8 (three downsamples)
            cond["c_img"] = pad_to_multiples_of(cond["c_img"], 8)
        clean_c_img = cond["c_img"]  # the latent guidance target: before noise_aug
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
        if cldm_tiled:
            model_fn = tiled_model_function(cldm, strength, cldm_tile_size, cldm_tile_stride,
                                            cldm_tiles_per_batch)
        else:
            tables = None
            if self.hoist:
                ctx_full = (cond["c_txt"] if uncond is None
                            else torch.cat([cond["c_txt"], uncond["c_txt"]], dim=0))
                tables = cldm.make_hoist_tables(ctx_full, sampler.model_ts(steps))
            if turbo:
                model_fn = cldm.make_cached_control_model(strength, control_interval,
                                                          turbo_encoder, tables)
            else:
                model_fn = model_function(cldm, strength, tables)
        clock.lap("hoist")
        guidance = {}
        if cond_fn is not None:
            if cond_fn.space == "rgb":
                guidance = dict(cond_fn=RGBSpaceGuidance(cond_fn, cldm.vae_decode),
                                guidance_target=cond_img * 2.0 - 1.0)
            else:
                guidance = dict(cond_fn=cond_fn, guidance_target=clean_c_img)
        z = sampler.sample(model_fn, start, cond, uncond, cfg_scale, steps,
                           generator=None if noise_table is not None else generator,
                           noise_table=noise_table, **guidance)
        model_fn = tables = None   # the hoisted tables go before the decode
        clock.lap("denoise")
        x = cldm.vae_decode(z[:, :h1, :w1, :], tiled=vae_decoder_tiled,
                            tile_size=vae_decoder_tile_size // 8, tile_mode=tile_mode)
        clock.lap("decode")
        if own_clock:
            clock.finish()
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
        cleaner_tile_size: int = 512,
        cleaner_tile_stride: int = 256,
        seed: int = 231,
        size_bucket: int = 0,
        x_T: Optional[torch.Tensor] = None,
        aug_noise: Optional[torch.Tensor] = None,
        noise_table: Optional[torch.Tensor] = None,
        timings: Optional[Dict[str, float]] = None,
        **kwargs,
    ) -> np.ndarray:
        """lq: uint8 [B, H, W, 3] -> restored uint8 [B, *output_size, 3].

        ``kwargs``: ``apply_cldm``'s tiling arguments and the sampler's
        (``eta``, ``s_churn``, ``s_tmin``, ``s_tmax``, ``s_noise``,
        ``order``). ``timings``: when a dict is given, seconds per stage
        (cleaner, condition, hoist, denoise, decode, colour_fix) are added
        to it: each stage's device time between the CUDA events of its
        ``pipeline.<stage>`` span (``StageClock``), read after the copy of
        the result to the host; no stage waits for the device."""
        clock = StageClock(timings, self.device)
        lq = np.asarray(lq)
        orig_hw = lq.shape[1:3]
        if size_bucket:
            ph, pw = (-lq.shape[1]) % 64, (-lq.shape[2]) % 64
            if ph or pw:
                lq = np.pad(lq, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
        lq_t = host_to_device(lq, self.device).float().div(255.0).clamp(0, 1)
        self.set_output_size(tuple(lq_t.shape[1:3]))
        cond_img = self.apply_cleaner(lq_t, cleaner_tiled, cleaner_tile_size, cleaner_tile_stride)
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
            noise_table=noise_table, clock=clock, **kwargs)
        if size_bucket and (ch, cw) != tuple(sample.shape[1:3]):
            sample, cond_img = sample[:, :ch, :cw], cond_img[:, :ch, :cw]
        sample = wavelet_reconstruction((sample + 1) / 2, cond_img)
        sample = bicubic_resize(sample, self.output_size)
        out = (sample * 255.0).clamp(0, 255).to(torch.uint8)
        clock.lap("colour_fix")
        out = out.cpu().numpy()
        clock.finish()
        if size_bucket and tuple(orig_hw) != tuple(lq.shape[1:3]):
            oh = round(orig_hw[0] * self.output_size[0] / lq.shape[1])
            ow = round(orig_hw[1] * self.output_size[1] / lq.shape[2])
            out = out[:, :oh, :ow]
        return out


class IdentityCleanerPipeline(Pipeline):
    """Bicubic-only stage 1 (the tiling arguments have nothing to tile)."""

    def apply_cleaner(self, lq: torch.Tensor, tiled: bool = False, tile_size: int = 512,
                      tile_stride: int = 256) -> torch.Tensor:
        if min(lq.shape[1:3]) < self.min_cond_size:
            lq = resize_short_edge_to(lq, self.min_cond_size)
        return lq


class CleanerPipeline(Pipeline):
    """A pipeline whose stage 1 is a network (NHWC [0, 1] in), its output
    clipped to [0, 1]."""

    def __init__(self, cleaner: torch.nn.Module, cldm: ControlLDM, schedule: Schedule,
                 device: torch.device, min_cond_size: int = 512,
                 tokenizer: Optional[Callable[[List[str]], np.ndarray]] = None,
                 hoist: bool = True, cond_fn=None):
        super().__init__(cldm, schedule, device, min_cond_size, tokenizer, hoist, cond_fn)
        self.cleaner = cleaner

    def _clean(self, x: torch.Tensor) -> torch.Tensor:
        return self.cleaner(x).clamp(0.0, 1.0)


class SwinIRPipeline(CleanerPipeline):
    """x1 SwinIR cleaner on a pre-upscaled input."""

    def apply_cleaner(self, lq: torch.Tensor, tiled: bool = False, tile_size: int = 512,
                      tile_stride: int = 256) -> torch.Tensor:
        """Untiled: the LQ (its short edge resized to ``min_cond_size`` if
        below it) padded to x64; tiled (when the LQ is at least a tile):
        ``tile_size`` tiles at ``tile_stride``, each clipped, blended."""
        if tiled and min(lq.shape[1:3]) >= tile_size:
            if tile_size % 64 != 0:
                raise ValueError("SwinIR tile size must be a multiple of 64")
            out = make_tiled_fn(self._clean, tile_size, tile_stride)(lq)
            if min(out.shape[1:3]) < self.min_cond_size:
                out = resize_short_edge_to(out, self.min_cond_size)
            return out
        if min(lq.shape[1:3]) < self.min_cond_size:
            lq = resize_short_edge_to(lq, self.min_cond_size)
        h0, w0 = lq.shape[1:3]
        return self._clean(pad_to_multiples_of(lq, 64))[:, :h0, :w0, :]


class BSRNetPipeline(CleanerPipeline):
    """x4 BSRNet cleaner on the LQ itself; the output is lq x ``upscale``."""

    def __init__(self, *args, upscale: float = 4.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.upscale = upscale

    def set_output_size(self, lq_hw: Tuple[int, int]) -> None:
        self.output_size = (int(lq_hw[0] * self.upscale), int(lq_hw[1] * self.upscale))

    def apply_cleaner(self, lq: torch.Tensor, tiled: bool = False, tile_size: int = 512,
                      tile_stride: int = 256) -> torch.Tensor:
        """The x4 cleaner (tiled when the LQ is at least a tile: x4 tiles
        blended), then resized: its short edge to ``min_cond_size`` when
        the output size is below it, else bicubic to the output size."""
        fn = self._clean
        if tiled and min(lq.shape[1:3]) >= tile_size:
            fn = make_tiled_fn(fn, tile_size, tile_stride, scale_type="up", scale=4)
        out = fn(lq)
        if min(self.output_size) < self.min_cond_size:
            return resize_short_edge_to(out, self.min_cond_size)
        return bicubic_resize(out, self.output_size)


class SCUNetPipeline(CleanerPipeline):
    """x1 SCUNet denoiser on a pre-upscaled input."""

    def apply_cleaner(self, lq: torch.Tensor, tiled: bool = False, tile_size: int = 512,
                      tile_stride: int = 256) -> torch.Tensor:
        """The cleaner (tiled when the LQ is at least a tile), its short
        edge resized to ``min_cond_size`` if below it."""
        fn = self._clean
        if tiled and min(lq.shape[1:3]) >= tile_size:
            fn = make_tiled_fn(fn, tile_size, tile_stride)
        out = fn(lq)
        if min(out.shape[1:3]) < self.min_cond_size:
            out = resize_short_edge_to(out, self.min_cond_size)
        return out
