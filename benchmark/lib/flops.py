"""Operations and bytes, counted from shapes.

- ``attention_sites``: the self-attention calls of one UNet + ControlNet
  call, from the configuration's sizes (the ones the port sends to K1 and,
  under a gradient, to K2a/K2b).
- ``attn_fwd`` / ``attn_bwd``: the FLOPs and bytes such a call needs: the
  forward 2 products of 2 B H Sq Skv d each; the backward the 5 products of
  the algorithm (S recomputed once, dP, dV, dQ, dK), whatever a kernel
  recomputes. Bytes: each bf16 input read once and each output written once
  (the backward's lse and delta in fp32).
- ``least_us``: the larger of the FLOPs at the bf16 peak and the bytes at
  the HBM rate.
- ``serve_flops`` / ``train_flops``: the whole request's or step's FLOPs,
  counted by ``torch.utils.flop_counter.FlopCounterMode`` on the plain
  reference on meta tensors at the cell's shapes (matmuls, convolutions and
  the attention products; elementwise work is not counted), so that they
  do not depend on what implements the work.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Tuple

from . import peaks

Site = Tuple[int, int, int]  # (tokens, heads, head_dim) of one image


def attention_sites(unet: dict, latent_hw: Tuple[int, int]) -> Dict[str, List[Site]]:
    """Per image of one denoiser call, the self-attention sites in the
    order they run: {"unet_in", "unet_mid", "unet_out", "cn_in", "cn_mid"}
    -> [(tokens, heads, d)]."""
    mc, mult, nrb = unet["model_channels"], unet["channel_mult"], unet["num_res_blocks"]
    att, dh, depth = (unet["attention_resolutions"], unet["num_head_channels"],
                      unet["transformer_depth"])
    h, w = latent_hw
    enc, dec = [], []
    for level, m in enumerate(mult):
        ds = 2 ** level
        site = ((h // ds) * (w // ds), m * mc // dh, dh)
        if ds in att:
            enc += [site] * (nrb * depth)
            dec = [site] * ((nrb + 1) * depth) + dec
    ds = 2 ** (len(mult) - 1)
    mid = [((h // ds) * (w // ds), mult[-1] * mc // dh, dh)] * depth
    return {"unet_in": enc, "unet_mid": mid, "unet_out": dec, "cn_in": list(enc),
            "cn_mid": list(mid)}


def attn_fwd(b: int, site: Site) -> Tuple[float, float]:
    s, h, d = site
    return 4.0 * b * h * s * s * d, 2.0 * b * h * d * 4 * s


def attn_bwd(b: int, site: Site) -> Tuple[float, float]:
    s, h, d = site
    flops = 10.0 * b * h * s * s * d
    # read q, k, v, o, dO and lse, delta; write dq, dk, dv
    nbytes = 2.0 * b * h * d * 8 * s + 8.0 * b * h * s
    return flops, nbytes


def least_us(flops: float, nbytes: float) -> float:
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES) * 1e6


def _meta_models(sizes_json: str):
    import torch

    from ..reference.models import build

    sizes = json.loads(sizes_json)
    with torch.device("meta"):
        return build("cldm", sizes["cldm"]), build("swinir", sizes["swinir"])


@functools.lru_cache(maxsize=8)
def serve_flops(sizes_json: str, side: int, steps: int) -> float:
    """FLOPs of one served restoration of a ``side`` x ``side`` image
    (per image: every part of it is per row), by the reference on meta."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.restore import restore_rows

    cldm, swinir = _meta_models(sizes_json)
    ctx = cldm.clip.context_length
    images = np.zeros((1, side, side, 3), np.uint8)
    with FlopCounterMode(display=False) as fc:
        restore_rows(cldm, swinir, images, torch.zeros(1, ctx, dtype=torch.long, device="meta"),
                     torch.zeros(1, ctx, dtype=torch.long, device="meta"),
                     torch.empty(1, side // 8, side // 8, 4, device="meta"), steps, 6.0)
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=8)
def train_flops(sizes_json: str, side: int) -> float:
    """FLOPs of one image of a stage-2 training step at ``side`` x ``side``
    (the frozen encoders, the ControlNet and UNet forward and the backward
    to the ControlNet), by the reference on meta."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.train import row_loss

    cldm, swinir = _meta_models(sizes_json)
    cldm.requires_grad_(False)
    cldm.controlnet.requires_grad_(True)
    swinir.requires_grad_(False)
    lat = side // 8
    row = {"gt": torch.empty(1, side, side, 3, device="meta"),
           "lq": torch.empty(1, side, side, 3, device="meta"),
           "tokens": torch.zeros(1, cldm.clip.context_length, dtype=torch.long, device="meta")}
    draws = {"posterior": torch.empty(1, lat, lat, 4, device="meta"),
             "aug": torch.empty(1, lat, lat, 4, device="meta"),
             "t": torch.zeros(1, dtype=torch.long, device="meta"),
             "noise": torch.empty(1, lat, lat, 4, device="meta")}
    with FlopCounterMode(display=False) as fc:
        row_loss(cldm, swinir, row, draws, 200).backward()
    return float(fc.get_total_flops())
