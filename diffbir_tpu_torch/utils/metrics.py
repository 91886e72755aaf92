"""Validation metrics.

Counterpart of ``diffbir_tpu/utils/metrics.py``: ``psnr`` (the stage-1
trainer's val metric) lives in ``utils/common.py`` as in JAX and is named
here. Left out: ``lpips_alex`` (it needs the ``lpips`` package and its
AlexNet weights, neither installed beside the port) and ``log_txt_as_img``
(it draws prompts with PIL, and nothing calls it).
"""

from .common import psnr  # noqa: F401

__all__ = ["psnr"]
