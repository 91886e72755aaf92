"""Blind SR task loop.

Counterpart of ``diffbir_tpu/inference/bsr_loop.py``: v1 SwinIR (general)
and v2.1 SwinIR (realesrgan), each pre-upscaling the LQ by Pillow's bicubic
(``utils.common.pil_bicubic_resize``, bit for bit) before the x1 cleaner.
v2's BSRNet cleaner is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.layers import random_init_
from ..models.swinir import SwinIR
from ..pipeline import SwinIRPipeline
from ..utils.common import pil_bicubic_resize
from ..weights.convert import load_into, load_torch_state_dict
from .loop import InferenceLoop, build_on, random_init_requested
from .pretrained_models import resolve_model


class BSRInferenceLoop(InferenceLoop):
    def load_cleaner(self) -> None:
        if self.args.version == "v2":
            raise NotImplementedError("--version v2 (the BSRNet cleaner) is not ported yet")
        cleaner = build_on(SwinIR, self.device, dtype=self._dtype())
        if random_init_requested():
            random_init_(cleaner, self._generator(0))
        else:
            path = resolve_model(
                "swinir_general" if self.args.version == "v1" else "swinir_realesrgan")
            load_into(cleaner, load_torch_state_dict(path), path=path)
        self.cleaner = cleaner.eval()

    def load_pipeline(self) -> None:
        self.pipeline = SwinIRPipeline(self.cleaner, self.cldm, self.schedule, self.device,
                                       tokenizer=self._tokenizer(), cond_fn=self.cond_fn)

    def after_load_lq(self, lq: np.ndarray) -> np.ndarray:
        h, w = lq.shape[:2]
        up = self.args.upscale
        return pil_bicubic_resize(torch.from_numpy(lq), (int(h * up), int(w * up))).numpy()
