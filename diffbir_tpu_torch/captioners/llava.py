"""The LLaVA-1.5 captioner: CLIP preprocessing, vision tower, projector and
greedy decoding, on token ids.

Counterpart of ``diffbir_tpu/captioners/llava_tpu.py`` (the JAX package's
LLaVA captioner; its module name says TPU, this one's does not).
``LLaVACaptioner`` lays the prompt out as the JAX captioner does: the
embeddings of ``pre_ids`` (BOS first), the image's 576 projected patch
embeddings, the embeddings of ``post_ids``; then ``greedy_decode``. It works
on ids: turning the caption ids into text waits for the Llama SentencePiece
tokenizer file, which the repository does not hold.

``clip_preprocess`` is HF's CLIPImageProcessor as the JAX captioner runs it
through PIL (bicubic resize of the short edge, centre crop, /255, CLIP mean
and std), in torch and without PIL: the resize reproduces Pillow's
fixed-point resampler (a = -0.5 bicubic widened by the downscale factor,
coefficients in 22-bit fixed point, a horizontal pass then a vertical one,
each rounded and clipped to uint8; ``utils.common.pil_resample``), so the
uint8 crop is PIL's, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.llava import Llava
from ..utils.common import StageClock, pil_coeffs, pil_resample

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
def clip_preprocess(image, size: int, device=None) -> torch.Tensor:
    """HWC uint8 image (numpy array or tensor) -> [size, size, 3] fp32,
    CLIP-normalised: the short edge resized to ``size`` (bicubic, as PIL),
    the centre crop, /255, (x - mean) / std."""
    img = image if torch.is_tensor(image) else torch.from_numpy(np.asarray(image))
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected an HWC uint8 RGB image, got {tuple(img.shape)} {img.dtype}")
    img = img.to(device) if device is not None else img
    h, w = img.shape[:2]
    scale = size / min(w, h)
    out_w, out_h = max(size, round(w * scale)), max(size, round(h * scale))
    if out_w != w:
        img = pil_resample(img, pil_coeffs(w, out_w, "bicubic"), axis=1)
    if out_h != h:
        img = pil_resample(img, pil_coeffs(h, out_h, "bicubic"), axis=0)
    left, top = (out_w - size) // 2, (out_h - size) // 2
    x = img[top:top + size, left:left + size].float() / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


class LLaVACaptioner:
    """Caption ids of one image with a LLaVA-1.5 model (float, or quantised
    in place by ``models.llava.quantize_llama_``).

    ``pre_ids`` (BOS first) and ``post_ids`` are the prompt's token ids
    before and after the image. The model runs on CUDA unless ``device``
    says otherwise; it is moved there."""

    def __init__(self, model: Llava, pre_ids: Sequence[int], post_ids: Sequence[int],
                 max_new_tokens: int = 60, eos_id: int = 2,
                 device: Optional[torch.device] = None):
        self.device = torch.device("cuda") if device is None else torch.device(device)
        self.model = model.to(self.device).eval()
        self.pre = torch.as_tensor(pre_ids, dtype=torch.long, device=self.device)
        self.post = torch.as_tensor(post_ids, dtype=torch.long, device=self.device)
        self.max_new_tokens, self.eos_id = max_new_tokens, eos_id

    @torch.no_grad()
    def prompt_embeds(self, image) -> torch.Tensor:
        """[1, len(pre) + patches + len(post), D]: the prompt around the
        image's projected patch embeddings (``llava_tpu.py`` caption_fn)."""
        x = clip_preprocess(image, self.model.vcfg.image_size, self.device)
        img = self.model.image_embeds(x[None])
        embed = self.model.language_model.model.embed_tokens
        return torch.cat([embed(self.pre)[None], img.to(embed.weight.dtype),
                          embed(self.post)[None]], dim=1)

    @torch.no_grad()
    def generate(self, image, timings: Optional[Dict[str, float]] = None,
                 step_logits: Optional[list] = None) -> torch.Tensor:
        """[1, max_new_tokens] ids, EOS-padded after the first EOS.
        ``timings`` gets the seconds of "vision" (preprocessing, tower and
        projector), "prefill" and "decode" (see ``greedy_decode``, which also
        fills ``step_logits``)."""
        clock = StageClock(timings, self.device, "caption")
        embeds = self.prompt_embeds(image)
        clock.lap("vision")
        out = self.model.language_model.greedy_decode(
            embeds, self.max_new_tokens, self.eos_id, timings, step_logits)
        clock.finish()
        return out

    def __call__(self, image) -> list:
        """The caption's token ids, cut at the first EOS."""
        tokens = self.generate(image)[0].tolist()
        return tokens[:tokens.index(self.eos_id)] if self.eos_id in tokens else tokens
