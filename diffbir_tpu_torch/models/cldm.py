"""ControlLDM: the stage-2 generation module {UNet, VAE, CLIP, ControlNet}.

Counterpart of the core of ``diffbir_tpu/models/cldm.py``: the sd21()/tiny()
sizes, the ControlNet -> scaled residuals -> controlled UNet forward,
``prepare_condition`` and the untiled VAE encode/decode. Images and latents
enter and leave these methods NHWC, as in the JAX package; the modules run
NCHW inside. Not ported yet: the denoise-loop hoisting of the cross-attention
k/v and timestep tables (exact-math speed work), tiled VAE, posterior
sampling, the turbo control cache and the quantised serving modes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import torch
from torch import nn

from .clip import CLIPTextEncoder
from .unet import ControlNet, UNetModel
from .vae import AutoencoderKL


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ControlLDM(nn.Module):
    def __init__(self, unet: UNetModel, vae: AutoencoderKL, clip: CLIPTextEncoder,
                 controlnet: ControlNet, scale_factor: float = 0.18215):
        super().__init__()
        self.unet = unet
        self.vae = vae
        self.clip = clip
        self.controlnet = controlnet
        self.scale_factor = scale_factor

    @classmethod
    def sd21(cls, dtype: torch.dtype = torch.bfloat16, device=None) -> "ControlLDM":
        """SD2.1-base + IRControlNet sizes (configs/inference/cldm.yaml)."""
        return cls(
            unet=UNetModel(dtype=dtype, device=device),
            vae=AutoencoderKL(dtype=dtype, device=device),
            clip=CLIPTextEncoder(dtype=dtype, device=device),
            controlnet=ControlNet(dtype=dtype, device=device),
        )

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32, device=None) -> "ControlLDM":
        """The JAX package's small test config (still a true f8 VAE)."""
        kw = dict(model_channels=32, num_head_channels=16, channel_mult=(1, 2),
                  attention_resolutions=(2, 1), context_dim=64, dtype=dtype, device=device)
        return cls(
            unet=UNetModel(**kw),
            vae=AutoencoderKL(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1, dtype=dtype,
                              device=device),
            clip=CLIPTextEncoder(width=64, heads=4, layers=3, dtype=dtype, device=device),
            controlnet=ControlNet(hint_channels=4, **kw),
        )

    def set_attention_impl(self, impl: str) -> None:
        """"auto" (flash kernel where a call qualifies) or "plain" for every
        attention site of the model."""
        if impl not in ("auto", "plain"):
            raise ValueError(f"unknown attention impl {impl!r}")
        for m in self.modules():
            if hasattr(m, "attn_impl"):
                m.attn_impl = impl

    # ------------------------------------------------------------------ #
    def forward(
        self,
        x_noisy: torch.Tensor,
        t: torch.Tensor,
        cond: Mapping[str, torch.Tensor],
        control_scales: Union[float, Sequence[float]] = 1.0,
    ) -> torch.Tensor:
        """ControlNet -> scaled residuals -> controlled UNet. x_noisy and
        cond["c_img"] NHWC latents, cond["c_txt"] [B, 77, width]; returns the
        fp32 NHWC model output."""
        x = _nchw(x_noisy)
        control = self.controlnet(x, _nchw(cond["c_img"]), t, cond["c_txt"])
        if isinstance(control_scales, (int, float)):
            control_scales = (float(control_scales),) * len(control)
        control = tuple(c * s for c, s in zip(control, control_scales))
        return _nhwc(self.unet(x, t, cond["c_txt"], control=control))

    def vae_encode(self, image: torch.Tensor) -> torch.Tensor:
        """image in [-1, 1] NHWC -> scaled latent NHWC: the posterior mean
        (``sample=False`` in JAX; sampling is not ported yet)."""
        mean, _ = self.vae.encode_moments(_nchw(image))
        return _nhwc(mean) * self.scale_factor

    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent NHWC -> image in [-1, 1] NHWC (fp32)."""
        return _nhwc(self.vae.decode(_nchw(z) / self.scale_factor))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.clip(tokens)

    def prepare_condition(self, cond_img: torch.Tensor, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """cond_img in [0, 1] NHWC; tokens [B, 77] int."""
        return dict(c_txt=self.encode_text(tokens),
                    c_img=self.vae_encode(cond_img * 2 - 1))
