"""Blind SR task loop (``--task sr``).

Counterpart of ``diffbir_tpu/inference/bsr_loop.py``: v1 SwinIR (general)
and v2.1 SwinIR (realesrgan), each pre-upscaling the LQ by Pillow's bicubic
(``InferenceLoop.pre_upscale``, bit for bit) before the x1 cleaner; v2
BSRNet (``RRDBNet``, x4) on the LQ itself, its output resized to lq x
``--upscale`` by ``BSRNetPipeline``.
"""

from __future__ import annotations

import numpy as np

from ..models.bsrnet import RRDBNet
from ..models.swinir import SwinIR
from ..pipeline import BSRNetPipeline, SwinIRPipeline
from .loop import InferenceLoop


class BSRInferenceLoop(InferenceLoop):
    def load_cleaner(self) -> None:
        if self.args.version == "v2":
            self.cleaner = self._load_cleaner(RRDBNet, "bsrnet")
        else:
            self.cleaner = self._load_cleaner(
                SwinIR, "swinir_general" if self.args.version == "v1" else "swinir_realesrgan")

    def load_pipeline(self) -> None:
        kw = dict(tokenizer=self._tokenizer(), cond_fn=self.cond_fn)
        if self.args.version == "v2":
            self.pipeline = BSRNetPipeline(self.cleaner, self.cldm, self.schedule, self.device,
                                           upscale=self.args.upscale, **kw)
        else:
            self.pipeline = SwinIRPipeline(self.cleaner, self.cldm, self.schedule, self.device,
                                           **kw)

    def after_load_lq(self, lq: np.ndarray) -> np.ndarray:
        return lq if self.args.version == "v2" else self.pre_upscale(lq)
