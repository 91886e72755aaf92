"""Blind image denoising task loop (``--task denoise``).

Counterpart of ``diffbir_tpu/inference/bid_loop.py``: v1 SwinIR (general),
v2 SCUNet (``scunet_psnr``), v2.1 SwinIR (realesrgan), each x1 on the LQ
pre-upscaled by Pillow's bicubic (``InferenceLoop.pre_upscale``).
"""

from __future__ import annotations

import numpy as np

from ..models.scunet import SCUNet
from ..models.swinir import SwinIR
from ..pipeline import SCUNetPipeline, SwinIRPipeline
from .loop import InferenceLoop


class BIDInferenceLoop(InferenceLoop):
    def load_cleaner(self) -> None:
        if self.args.version == "v2":
            self.cleaner = self._load_cleaner(SCUNet, "scunet_psnr")
        else:
            self.cleaner = self._load_cleaner(
                SwinIR, "swinir_general" if self.args.version == "v1" else "swinir_realesrgan")

    def load_pipeline(self) -> None:
        cls = SCUNetPipeline if self.args.version == "v2" else SwinIRPipeline
        self.pipeline = cls(self.cleaner, self.cldm, self.schedule, self.device,
                            tokenizer=self._tokenizer(), cond_fn=self.cond_fn)

    def after_load_lq(self, lq: np.ndarray) -> np.ndarray:
        return self.pre_upscale(lq)
