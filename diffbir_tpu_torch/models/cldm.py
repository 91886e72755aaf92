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
(``inference/loop.py``); ``set_serving`` composes the CLI's four flags and
``--fast_gelu`` (the tanh GELU in every unfused GEGLU), ``set_mode`` its
two named modes.

Denoise-loop hoisting (``make_hoist_tables``, the JAX ``hoist_context_kv``,
``hoist_emb_tables`` and ``make_hoist_lookup``): every cross-attention
site's k/v of the prompt context once per request, and every ResBlock's
timestep projection once per model timestep of the sampler's grid, by the
same module math as the loop; ``HoistTables.lookup(t)`` hands a step its
rows by the host value of its model timestep.

The tiled VAE (``vae_encode``/``vae_decode`` with ``tiled``, as the JAX
methods): "blend" runs the encoder or decoder on overlapping tiles at stride
tile/2 and blends them (``tiling.make_tiled_fn``; the encoder blends the
concatenated posterior mean and logvar); "sync_gn" cuts non-overlapping
tiles with an edge-replicated halo (32 image pixels for the encoder, 11
latent pixels for the decoder), streams them through ``vae_stream`` with
every GroupNorm over all tiles, and keeps each tile's centre (batch 1 only).

Turbo (``make_cached_control_model``, the JAX method of the same name): a
model function that runs the ControlNet only on every ``interval``-th call
and reuses its 13 residuals in between (arXiv:2312.03209); with
``cache_unet_encoder`` the UNet's encoder and middle block too, so a cached
call runs only the UNet's decoder (arXiv:2312.09608). Its state (the call
count and the cache) lives in the object; a request makes a fresh one.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_resblock import quantize_conv_weight
from ..ops.quant_matmul import QuantLinear
from ..sampler.base import timestep_vector
from ..tiling import make_tiled_fn
from ..utils.common import host_to_device
from .clip import CLIPTextEncoder
from .layers import Linear, QuantConv
from .unet import (
    GEGLU,
    BasicTransformerBlock,
    ControlNet,
    CrossAttention,
    FeedForward,
    ResBlock,
    UNetModel,
)
from .vae import AutoencoderKL
from .vae_stream import decode_sync, encode_sync_moments

# the JAX _QUANT_DENSE_TAILS: the dense sites of the int8 serving mode
QUANT_DENSE_TAILS = ("to_q", "to_k", "to_v", "to_out.0", "proj", "net.2", "proj_in",
                     "proj_out", "emb_layers.1")
# the named serving modes as the CLI's flags
SERVING_MODES = {
    "default": {},
    "fused": dict(fused_resblock=True, fused_ffn=True),
    "int8": dict(quant_dense=True, fused_resblock=True, quant_conv=True),
}


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
        # bumped by every method that replaces the denoisers' modules or
        # parameters or changes how they run (a CUDA graph of the denoiser
        # call holds what it was captured on: ``models.denoiser_graph``)
        self.version = 0

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
        self.version += 1
        for m in self._denoisers():
            if isinstance(m, CrossAttention):
                m.flash_layout = layout

    def set_fused(self, resblock: bool, ffn: bool) -> None:
        """Switch the fused ResBlock (K6) and fused FFN (K7) modes on or off
        without touching a weight (the same tensors serve both). The FFN
        stays unfused where its dense sites are int8, as in JAX; int8 conv
        weights need the fused ResBlock."""
        self.version += 1
        for m in self._denoisers():
            if isinstance(m, ResBlock):
                if m.quant_conv and not resblock:
                    raise ValueError("quant_conv requires the fused ResBlock path")
                m.fused = resblock
                if not resblock:
                    m._tap_major.clear()
            elif isinstance(m, FeedForward):
                m.fused = ffn and not isinstance(m.net[2], QuantLinear)

    def set_serving(self, quant_dense: bool = False, fused_resblock: bool = False,
                    quant_conv: bool = False, fused_ffn: bool = False,
                    fast_gelu: bool = False) -> "ControlLDM":
        """The CLI's serving flags on a float model: ``quant_dense`` and
        ``quant_conv`` quantise in place from the current weights (nothing
        undoes them); the packed flash layout under any of the four, else
        folded; ``fast_gelu`` the tanh GELU in every GEGLU that is not fused
        (K7 keeps erf, as the JAX fused kernel does), else exact erf."""
        if quant_conv and not fused_resblock:
            raise ValueError("quant_conv requires the fused ResBlock path (--fused_resblock)")
        if quant_dense:
            quantize_dense_params(self)
        self.set_fused(resblock=fused_resblock, ffn=fused_ffn)
        if quant_conv:
            quantize_conv_params(self)
        self.set_flash_layout(
            "packed" if quant_dense or fused_resblock or fused_ffn else "folded")
        for m in self._denoisers():
            if isinstance(m, GEGLU):
                m.approximate = "tanh" if fast_gelu else "none"
        return self

    def set_mode(self, mode: str) -> "ControlLDM":
        """The CLI's serving mode: "default" (unfused, folded flash layout),
        "fused" (the fused ResBlock and FFN, packed flash layout) or "int8"
        (the dense sites and the ResBlock convs quantised in place, the
        ResBlock fused, packed flash layout): ``set_serving`` of its flags."""
        if mode not in SERVING_MODES:
            raise ValueError(f"unknown serving mode {mode!r}")
        return self.set_serving(**SERVING_MODES[mode])

    def set_attention_impl(self, impl: str) -> None:
        """"auto" (flash kernel where a call qualifies) or "plain" for every
        attention site of the model."""
        if impl not in ("auto", "plain"):
            raise ValueError(f"unknown attention impl {impl!r}")
        self.version += 1
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
        hoisted: Optional[Mapping[nn.Module, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """ControlNet -> scaled residuals -> controlled UNet. x_noisy and
        cond["c_img"] NHWC latents, cond["c_txt"] [B, 77, width]; returns the
        fp32 NHWC model output. ``hoisted``: a step's rows of
        ``HoistTables.lookup`` (exact math, less work per step)."""
        x = _nchw(x_noisy)
        control = self.controlnet(x, _nchw(cond["c_img"]), t, cond["c_txt"], hoisted)
        if isinstance(control_scales, (int, float)):
            control_scales = (float(control_scales),) * len(control)
        control = tuple(c * s for c, s in zip(control, control_scales))
        return _nhwc(self.unet(x, t, cond["c_txt"], control=control, hoisted=hoisted))

    def make_cached_control_model(self, strength: float, interval: int,
                                  cache_unet_encoder: bool = False,
                                  tables: Optional["HoistTables"] = None
                                  ) -> "CachedControlModel":
        """Turbo: a sampler ``model_fn`` that refreshes the ControlNet's
        residuals (and with ``cache_unet_encoder`` the UNet's encoder) on
        every ``interval``-th call only; ``tables``: the request's hoisted
        rows, on refreshed and cached calls alike."""
        return CachedControlModel(self, strength, interval, cache_unet_encoder, tables)

    # ------------------------------------------------------------------ #
    # denoise-loop hoisting (exact math: the loop's own module calls)
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def hoist_context_kv(self, ctx_full: torch.Tensor) -> Dict[nn.Module, torch.Tensor]:
        """Every cross-attention site's k/v of ``ctx_full``, which must be the
        context the model sees each step (cond then uncond under batched
        CFG): {attn2 module: [B, 77, 2 inner]}."""
        out = {}
        for root in (self.unet, self.controlnet):
            ctx = ctx_full.to(root.dtype)  # as the UNet and ControlNet cast it
            for m in root.modules():
                if isinstance(m, BasicTransformerBlock):
                    out[m.attn2] = m.attn2.context_kv(ctx)
        return out

    @torch.no_grad()
    def hoist_emb_tables(self, ts_asc: Sequence[float], batch: int
                         ) -> Tuple[torch.Tensor, Dict[nn.Module, torch.Tensor]]:
        """Every ResBlock's ``emb_layers(embed(t))`` for all the model
        timesteps ``ts_asc`` at once: (packed [T, batch x sum Cout],
        {ResBlock: [T, batch, Cout]}), each row repeated over the call batch
        once here, so that no step copies a broadcast row (K6 reads ``e`` as
        [B, Cout]). The tables are views of ``packed``: a step's rows of
        every ResBlock lie side by side in its row of ``packed``, each
        block's [batch, Cout] contiguous, in module order."""
        rows = []
        for root in (self.unet, self.controlnet):
            device = root.time_embed[0].weight.device
            emb = root.embed(host_to_device(np.asarray(ts_asc, np.float32), device))
            rows += [(m, m.emb_layers(emb)) for m in root.modules() if isinstance(m, ResBlock)]
        t = len(ts_asc)
        packed = torch.cat([e[:, None, :].expand(-1, batch, -1).reshape(t, -1) for _, e in rows],
                           dim=1)
        out, at = {}, 0
        for m, e in rows:
            width = batch * e.shape[1]
            out[m] = packed[:, at: at + width].view(t, batch, e.shape[1])
            at += width
        return packed, out

    def make_hoist_tables(self, ctx_full: torch.Tensor,
                          model_ts: Optional[Sequence[float]] = None) -> "HoistTables":
        """The denoise loop's invariants: the context k/v always, the
        timestep tables when the sampler publishes its grid (``model_ts``,
        any order, duplicates allowed)."""
        kv = self.hoist_context_kv(ctx_full)
        if model_ts is None:
            return HoistTables(kv, None, ())
        ts_asc = np.unique(np.asarray(model_ts, np.float32))
        packed, emb = self.hoist_emb_tables(ts_asc, ctx_full.shape[0])
        return HoistTables(kv, emb, tuple(float(t) for t in ts_asc), packed)

    def vae_encode(self, image: torch.Tensor, sample: bool = True,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None, tiled: bool = False,
                   tile_size: int = 256, tile_mode: str = "blend") -> torch.Tensor:
        """image in [-1, 1] NHWC -> scaled latent NHWC. With ``sample`` a
        posterior sample z = mean + exp(logvar / 2) * eps, eps standard normal
        NHWC, passed in or drawn from ``generator`` in fp32, and cast to the
        mean's dtype as the JAX package draws it; else the posterior mean.
        ``tiled``: ``tile_size`` image pixels, "blend" or "sync_gn" (see the
        module's notes)."""
        if tiled and tile_mode == "sync_gn":
            mean, logvar = self._vae_encode_sync(image, tile_size)
        elif tiled:
            def enc_moments(x):
                m, lv = self.vae.encode_moments(_nchw(x))
                return _nhwc(torch.cat([m, lv], dim=1))

            moments = make_tiled_fn(enc_moments, tile_size, tile_size // 2, scale_type="down",
                                    scale=8, channel=self.vae.quant_conv.out_channels)(image)
            mean, logvar = moments.chunk(2, dim=-1)
        else:
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

    @torch.no_grad()
    def _vae_encode_sync(self, image: torch.Tensor, tile_size: int, halo: int = 32,
                         chunk: int = 8):
        """Cross-tile-GroupNorm tiled encode of a batch-1 image: posterior
        (mean, logvar) NHWC. ``tile_size`` and ``halo`` in image pixels,
        multiples of 8."""
        if image.shape[0] != 1:
            raise ValueError("sync_gn tiling supports batch 1")
        if tile_size % 8 or halo % 8:
            raise ValueError("sync_gn tile size and halo must be multiples of 8")
        tiles, coords, (h, w) = _halo_tiles(image, tile_size, halo)
        mean_t, logvar_t = encode_sync_moments(self.vae, tiles, chunk=chunk)
        mom = _stitch(torch.cat([mean_t, logvar_t], dim=-1),
                      [(i // 8, j // 8) for i, j in coords], tile_size // 8, halo // 8)
        return mom[:, : h // 8, : w // 8].chunk(2, dim=-1)

    def vae_decode(self, z: torch.Tensor, tiled: bool = False, tile_size: int = 256,
                   tile_mode: str = "blend") -> torch.Tensor:
        """Scaled latent NHWC -> image in [-1, 1] NHWC (fp32). ``tiled``:
        ``tile_size`` latent pixels, "blend" or "sync_gn" (see the module's
        notes)."""
        if tiled and tile_mode == "sync_gn":
            return self._vae_decode_sync(z, tile_size)
        if tiled:
            def dec(zt):
                return _nhwc(self.vae.decode(_nchw(zt) / self.scale_factor))

            return make_tiled_fn(dec, tile_size, tile_size // 2, scale_type="up", scale=8,
                                 channel=3)(z)
        return _nhwc(self.vae.decode(_nchw(z) / self.scale_factor))

    @torch.no_grad()
    def _vae_decode_sync(self, z: torch.Tensor, tile_size: int, halo: int = 11,
                         chunk: int = 8) -> torch.Tensor:
        """Cross-tile-GroupNorm tiled decode of a batch-1 latent
        (``tile_size`` and ``halo`` in latent pixels), streamed ``chunk``
        tiles at a time."""
        if z.shape[0] != 1:
            raise ValueError("sync_gn tiling supports batch 1")
        tiles, coords, (h, w) = _halo_tiles(z, tile_size, halo)
        out_t = decode_sync(self.vae, tiles / self.scale_factor, chunk=chunk)
        return _stitch(out_t, [(i * 8, j * 8) for i, j in coords], tile_size * 8,
                       halo * 8)[:, : h * 8, : w * 8]

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.clip(tokens)

    def prepare_condition(self, cond_img: torch.Tensor, tokens: torch.Tensor,
                          tiled: bool = False, tile_size: int = 256,
                          tile_mode: str = "blend") -> Dict[str, torch.Tensor]:
        """cond_img in [0, 1] NHWC; tokens [B, 77] int; the VAE encode tiled
        as ``vae_encode`` tiles it."""
        return dict(c_txt=self.encode_text(tokens),
                    c_img=self.vae_encode(cond_img * 2 - 1, sample=False, tiled=tiled,
                                          tile_size=tile_size, tile_mode=tile_mode))

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


def _halo_tiles(x: torch.Tensor, ts: int, halo: int):
    """Non-overlapping ``ts`` tiles of a batch-1 NHWC ``x`` (padded at the
    bottom and right to whole tiles), each with a ``halo`` of neighbours,
    edge-replicated beyond the border: ([T, ts + 2 halo, ts + 2 halo, C],
    the tiles' corners in the padded frame, the original (h, w))."""
    _, h, w, _ = x.shape
    ph, pw = (ts - h % ts) % ts, (ts - w % ts) % ts
    xp = _nhwc(F.pad(_nchw(x), (halo, halo + pw, halo, halo + ph), mode="replicate"))
    coords = [(i, j) for i in range(0, h + ph, ts) for j in range(0, w + pw, ts)]
    span = ts + 2 * halo
    return torch.cat([xp[:, i: i + span, j: j + span] for i, j in coords], dim=0), coords, (h, w)


def _stitch(tiles: torch.Tensor, corners, ts: int, halo: int) -> torch.Tensor:
    """The centres (``ts`` pixels past ``halo``) of [T, ., ., C] tiles,
    placed at ``corners`` into one [1, H, W, C] canvas."""
    h = max(i for i, _ in corners) + ts
    w = max(j for _, j in corners) + ts
    out = tiles.new_empty((1, h, w, tiles.shape[-1]))
    for t, (i, j) in enumerate(corners):
        out[:, i: i + ts, j: j + ts] = tiles[t: t + 1, halo: halo + ts, halo: halo + ts]
    return out


class CachedControlModel:
    """The turbo model function (``ControlLDM.make_cached_control_model``):
    ``model_fn(x, t, cond)`` as ``pipeline.model_function``'s, which on call
    i runs the ControlNet where i % interval == 0 and otherwise reuses the
    unscaled residuals of the last such call, scaling them by ``strength``
    every call; with ``cache_unet_encoder`` it caches the UNet's encoder
    output (``phase="encode"``) the same way and runs only the decoder
    (``phase="decode"``). ``calls``, ``control`` and ``encoded`` are its
    state; at interval 1 it is the plain model call, op for op."""

    def __init__(self, cldm: ControlLDM, strength: float, interval: int,
                 cache_unet_encoder: bool = False, tables: Optional[HoistTables] = None):
        if interval < 1:
            raise ValueError(f"control interval must be >= 1, got {interval}")
        self.cldm, self.strength, self.interval = cldm, float(strength), interval
        self.cache_unet_encoder, self.tables = cache_unet_encoder, tables
        self.calls, self.control, self.encoded = 0, None, None

    def __call__(self, x: torch.Tensor, t: float, cond: Mapping[str, torch.Tensor]
                 ) -> torch.Tensor:
        cldm = self.cldm
        hoisted = None if self.tables is None else self.tables.lookup(t)
        xn, tv, ctx = _nchw(x), timestep_vector(t, x), cond["c_txt"]
        if self.calls % self.interval == 0:
            self.control = cldm.controlnet(xn, _nchw(cond["c_img"]), tv, ctx, hoisted)
            if self.cache_unet_encoder:
                self.encoded = cldm.unet(xn, tv, ctx, hoisted=hoisted, phase="encode")
        self.calls += 1
        control = tuple(c * self.strength for c in self.control)
        if self.cache_unet_encoder:
            out = cldm.unet(None, tv, ctx, control=control, hoisted=hoisted, phase="decode",
                            cached=self.encoded)
        else:
            out = cldm.unet(xn, tv, ctx, control=control, hoisted=hoisted)
        return _nhwc(out)


class HoistTables:
    """A request's hoisted invariants (``ControlLDM.make_hoist_tables``):
    ``kv`` {attn2: [B, 77, 2 inner]}, ``emb`` {ResBlock: [T, B, Cout]} or
    None (views of ``packed`` [T, B x sum Cout], see ``hoist_emb_tables``),
    ``ts`` the T model timesteps in ascending order. ``lookup(t)`` gives a
    step's ``hoisted`` mapping by the host value of its model timestep (no
    search on the device, nothing read back); ``row(t)`` its row of the
    timestep tables. ``move_kv`` hands the k/v over to other storage (a
    CUDA graph's static inputs), so that one copy of them stays alive."""

    def __init__(self, kv, emb, ts, packed=None):
        self.emb, self.ts, self.packed = emb, ts, packed
        self.row_of = {t: i for i, t in enumerate(ts)}
        self.move_kv(kv)

    def move_kv(self, kv) -> None:
        """``kv`` in place of the k/v tables held so far, which are dropped."""
        self.kv = kv
        # one mapping per row, built once: a step only picks its dict
        self._rows = [] if self.emb is None else [
            {**kv, **{m: tab[i] for m, tab in self.emb.items()}} for i in range(len(self.ts))]

    def row(self, t: float) -> int:
        key = float(np.float32(t))
        if key not in self.row_of:
            raise KeyError(f"model timestep {t} is not on the hoisted grid {self.ts}")
        return self.row_of[key]

    def lookup(self, t: float) -> Mapping[nn.Module, torch.Tensor]:
        if self.emb is None:
            return self.kv
        return self._rows[self.row(t)]


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
    cldm.version += 1
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
    cldm.version += 1
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
            block._tap_major.clear()  # the float weights' copies: gone with them
    return cldm
