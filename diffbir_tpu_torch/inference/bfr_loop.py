"""Blind face restoration task loop (``--task face``: aligned faces).

Counterpart of ``diffbir_tpu/inference/bfr_loop.py``: the face SwinIR
(``swinir_face``) for every version, x1 on the LQ pre-upscaled by Pillow's
bicubic (``InferenceLoop.pre_upscale``); the ControlNet and schedule by
version (v1: ``v1_face``).
"""

from __future__ import annotations

import numpy as np

from ..models.swinir import SwinIR
from ..pipeline import SwinIRPipeline
from .loop import InferenceLoop


class BFRInferenceLoop(InferenceLoop):
    def load_cleaner(self) -> None:
        self.cleaner = self._load_cleaner(SwinIR, "swinir_face")

    def load_pipeline(self) -> None:
        self.pipeline = SwinIRPipeline(self.cleaner, self.cldm, self.schedule, self.device,
                                       tokenizer=self._tokenizer(), cond_fn=self.cond_fn)

    def after_load_lq(self, lq: np.ndarray) -> np.ndarray:
        return self.pre_upscale(lq)
