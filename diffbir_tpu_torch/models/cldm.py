"""ControlLDM: the stage-2 generation module {UNet, VAE, CLIP, ControlNet}.

Counterpart of the core of ``diffbir_tpu/models/cldm.py``: the sd21()/tiny()
sizes (with gradient checkpointing for training), the ControlNet -> scaled
residuals -> controlled UNet forward, ``prepare_condition``, the untiled VAE
encode (posterior mean or sample) and decode, and the ControlNet's
initialisation from the UNet. Images and latents enter and leave these
methods NHWC, as in the JAX package; the modules run NCHW inside.

The opt-in serving modes of the JAX CLI (``--fused_resblock``,
``--quant_conv``, ``--quant_dense``, ``--fused_ffn`` and
``DIFFBIR_TPU_FLASH_LAYOUT=packed``) are constructor flags of ``sd21()`` and
``tiny()``; ``quantize_dense_params`` and ``quantize_conv_params`` turn a
float model's UNet and ControlNet into the int8 layout in place, after the
cast to the compute dtype, in the order of the JAX loop
(``inference/loop.py``). Not ported yet: the denoise-loop hoisting of the
cross-attention k/v and timestep tables (exact-math speed work), tiled VAE
and the turbo control cache.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import torch
from torch import nn

from ..ops.fused_resblock import quantize_conv_weight
from ..ops.quant_matmul import QuantLinear
from .clip import CLIPTextEncoder
from .layers import Linear, QuantConv
from .unet import ControlNet, CrossAttention, FeedForward, ResBlock, UNetModel
from .vae import AutoencoderKL

# the JAX _QUANT_DENSE_TAILS: the dense sites of the int8 serving mode
QUANT_DENSE_TAILS = ("to_q", "to_k", "to_v", "to_out.0", "proj", "net.2", "proj_in",
                     "proj_out", "emb_layers.1")


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
    def sd21(cls, dtype: torch.dtype = torch.bfloat16, use_checkpoint: bool = False,
             device=None, quant_dense: bool = False, fused_resblock: bool = False,
             quant_conv: bool = False, fused_ffn: bool = False,
             flash_layout: str = "folded") -> "ControlLDM":
        """SD2.1-base + IRControlNet sizes (configs/inference/cldm.yaml);
        ``use_checkpoint`` recomputes the UNet's and ControlNet's ResBlocks and
        transformers in the backward (the training config's setting). The
        other flags are the serving modes (see the module's notes); the int8
        ones build empty int8 holders, filled by loading a quantised state
        dict."""
        modes = dict(quant_dense=quant_dense, fused_resblock=fused_resblock,
                     quant_conv=quant_conv, fused_ffn=fused_ffn)
        model = cls(
            unet=UNetModel(dtype=dtype, use_checkpoint=use_checkpoint, device=device, **modes),
            vae=AutoencoderKL(dtype=dtype, device=device),
            clip=CLIPTextEncoder(dtype=dtype, device=device),
            controlnet=ControlNet(dtype=dtype, use_checkpoint=use_checkpoint, device=device,
                                  **modes),
        )
        model.set_flash_layout(flash_layout)
        return model

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32, device=None, quant_dense: bool = False,
             fused_resblock: bool = False, quant_conv: bool = False, fused_ffn: bool = False,
             flash_layout: str = "folded") -> "ControlLDM":
        """The JAX package's small test config (still a true f8 VAE), with
        the serving modes of ``sd21``."""
        kw = dict(model_channels=32, num_head_channels=16, channel_mult=(1, 2),
                  attention_resolutions=(2, 1), context_dim=64, dtype=dtype, device=device,
                  quant_dense=quant_dense, fused_resblock=fused_resblock,
                  quant_conv=quant_conv, fused_ffn=fused_ffn)
        model = cls(
            unet=UNetModel(**kw),
            vae=AutoencoderKL(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1, dtype=dtype,
                              device=device),
            clip=CLIPTextEncoder(width=64, heads=4, layers=3, dtype=dtype, device=device),
            controlnet=ControlNet(hint_channels=4, **kw),
        )
        model.set_flash_layout(flash_layout)
        return model

    def _denoisers(self):
        """The modules of the UNet and the ControlNet (the serving modes'
        scope; the VAE and CLIP stay as they are)."""
        for root in (self.unet, self.controlnet):
            yield from root.modules()

    def set_flash_layout(self, layout: str) -> None:
        """"folded" (K1) or "packed" (K3 where it applies) at every UNet and
        ControlNet attention site."""
        if layout not in ("folded", "packed"):
            raise ValueError(f"unknown flash layout {layout!r}")
        for m in self._denoisers():
            if isinstance(m, CrossAttention):
                m.flash_layout = layout

    def set_fused(self, resblock: bool, ffn: bool) -> None:
        """Switch the fused ResBlock (K6) and fused FFN (K7) modes on or off
        without touching a weight (the same tensors serve both). The FFN
        stays unfused where its dense sites are int8, as in JAX; int8 conv
        weights need the fused ResBlock."""
        for m in self._denoisers():
            if isinstance(m, ResBlock):
                if m.quant_conv and not resblock:
                    raise ValueError("quant_conv requires the fused ResBlock path")
                m.fused = resblock
            elif isinstance(m, FeedForward):
                m.fused = ffn and not isinstance(m.net[2], QuantLinear)

    def set_mode(self, mode: str) -> "ControlLDM":
        """The CLI's serving mode: "default" (unfused, folded flash layout),
        "fused" (the fused ResBlock and FFN, packed flash layout) or "int8"
        (the dense sites and the ResBlock convs quantised in place from the
        current weights, which nothing undoes; the ResBlock fused, packed
        flash layout)."""
        if mode == "int8":
            quantize_dense_params(self)
            self.set_fused(resblock=True, ffn=False)
            quantize_conv_params(self)
        elif mode in ("default", "fused"):
            self.set_fused(resblock=mode == "fused", ffn=mode == "fused")
        else:
            raise ValueError(f"unknown serving mode {mode!r}")
        self.set_flash_layout("folded" if mode == "default" else "packed")
        return self

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

    def vae_encode(self, image: torch.Tensor, sample: bool = True,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image in [-1, 1] NHWC -> scaled latent NHWC. With ``sample`` a
        posterior sample z = mean + exp(logvar / 2) * eps, eps standard normal
        NHWC, passed in or drawn from ``generator`` in fp32, and cast to the
        mean's dtype as the JAX package draws it; else the posterior mean."""
        mean, logvar = self.vae.encode_moments(_nchw(image))
        mean, logvar = _nhwc(mean), _nhwc(logvar)
        if sample:
            if eps is None:
                if generator is None:
                    raise ValueError("sampling the posterior needs a generator or eps")
                eps = torch.randn(mean.shape, generator=generator, device=mean.device)
            if eps.shape != mean.shape:
                raise ValueError(f"eps {tuple(eps.shape)} != latent {tuple(mean.shape)}")
            mean = mean + torch.exp(0.5 * logvar) * eps.to(mean.device, mean.dtype)
        return mean * self.scale_factor

    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent NHWC -> image in [-1, 1] NHWC (fp32)."""
        return _nhwc(self.vae.decode(_nchw(z) / self.scale_factor))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.clip(tokens)

    def prepare_condition(self, cond_img: torch.Tensor, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """cond_img in [0, 1] NHWC; tokens [B, 77] int."""
        return dict(c_txt=self.encode_text(tokens),
                    c_img=self.vae_encode(cond_img * 2 - 1, sample=False))

    @torch.no_grad()
    def load_controlnet_from_unet(self) -> None:
        """Initialise the ControlNet from the (loaded) UNet: every ControlNet
        key the UNet has is copied, the input conv's extra hint input channels
        are zero, and the zero convs keep their init."""
        unet = self.unet.state_dict()
        for key, p in self.controlnet.state_dict().items():
            src = unet.get(key)
            if src is None:
                continue
            if src.shape == p.shape:
                p.copy_(src)
            else:  # input conv, OIHW: pad the input-channel axis with zeros
                p.zero_()
                p[:, :src.shape[1]].copy_(src)


def _replace(root: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, child = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, child, new)


@torch.no_grad()
def quantize_dense_params(cldm: ControlLDM) -> ControlLDM:
    """Turn the UNet's and ControlNet's dense sites (``QUANT_DENSE_TAILS``)
    into int8 ``QuantLinear`` layers in place, quantised from their current
    weights per output channel (``ops.quant_matmul.quantize_weight``), and
    the FFNs unfused (the JAX FeedForward runs the fused kernel in float mode
    only). Biases, norms and convs stay float; the VAE and CLIP are left as
    they are. The counterpart of the JAX ``quantize_dense_params``: the
    result loads the state dict of ``sd21(quant_dense=True)``."""
    for root in (cldm.unet, cldm.controlnet):
        for name, mod in list(root.named_modules()):
            if isinstance(mod, Linear) and any(
                    name == t or name.endswith("." + t) for t in QUANT_DENSE_TAILS):
                _replace(root, name, QuantLinear.from_linear(mod))
            elif isinstance(mod, FeedForward):
                mod.fused = False
    return cldm


@torch.no_grad()
def quantize_conv_params(cldm: ControlLDM) -> ControlLDM:
    """Turn every UNet and ControlNet ResBlock conv (``in_layers.2``,
    ``out_layers.3``, ``skip_connection``) into an int8 ``QuantConv`` in
    place, quantised per output channel over taps and Cin
    (``ops.fused_resblock.quantize_conv_weight``), in the JAX HWIO layout.
    The ResBlocks must be fused (int8 convs exist only inside K6). The
    counterpart of the JAX ``quantize_conv_params``; composes with
    ``quantize_dense_params``."""
    for root in (cldm.unet, cldm.controlnet):
        for name, block in list(root.named_modules()):
            if not isinstance(block, ResBlock) or block.quant_conv:
                continue
            if not block.fused:
                raise ValueError("quant_conv requires the fused ResBlock path")
            for attr in ("in_layers.2", "out_layers.3", "skip_connection"):
                c = block.get_submodule(attr)
                if isinstance(c, nn.Identity):
                    continue
                out_ch, in_ch, k, _ = c.weight.shape
                holder = QuantConv(in_ch, out_ch, k, dtype=c.weight.dtype,
                                   device=c.weight.device)
                holder.weight_q, holder.weight_scale = quantize_conv_weight(
                    c.weight.permute(2, 3, 1, 0))  # OIHW -> HWIO
                holder.bias.copy_(c.bias)
                _replace(block, attr, holder)
            block.quant_conv = True
    return cldm
