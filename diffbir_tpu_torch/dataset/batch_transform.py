"""Two-stage Real-ESRGAN batch degradation and the training-pair queue.

Counterpart of ``diffbir_tpu/dataset/batch_transform.py``: USM-sharpen the
GT -> [blur -> a random up/down/keep resize -> Gaussian or Poisson noise ->
JPEG] -> [an optional second blur -> a resize toward gt / stage2_scale ->
noise -> (resize + sinc | JPEG) in random order] -> resize back -> round to
8 bits; then the shuffled pool of training pairs (``queue_size``).

The draws are JAX's, in JAX's order: the up/down/keep choices and the
resize modes from Python's ``random``, every other draw from the
transform's numpy generator ``_rng`` (unseeded, as in JAX; a test sets
it). The image math runs as torch ops on the CPU, in the prefetch worker,
as JAX runs it on the host: OpenCV's ``filter2D``, ``GaussianBlur`` and
``resize`` (INTER_AREA, INTER_LINEAR, INTER_CUBIC) on fp32 are
``utils.warp``'s counterparts, the JPEG round trip ``dataset/jpeg.py``'s
(``degradation.jpeg_compress_np``). The noise stays
numpy on the same generator: the Poisson draws depend on the image's
values, so they cannot move to another generator or device without
changing the stream.
"""

from __future__ import annotations

import random
from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..config import register
from ..utils.warp import filter2d, gaussian_blur, resize
from .degradation import jpeg_compress_np

MODES = ("area", "bilinear", "bicubic")  # JAX's names, in its order
_WARP = {"area": "area", "bilinear": "linear", "bicubic": "cubic"}
USM_RADIUS = 51


def usm_sharp(imgs: torch.Tensor, weight: float = 0.5, radius: int = USM_RADIUS,
              threshold: float = 10) -> torch.Tensor:
    """Unsharp masking of [B, H, W, C] fp32 in [0, 1] (JAX's ``_usm_sharp``)."""
    if radius % 2 == 0:
        radius += 1
    residual = imgs - gaussian_blur(imgs, radius)
    mask = (residual.abs() * 255 > threshold).float()
    soft_mask = gaussian_blur(mask, radius)
    sharp = (imgs + weight * residual).clamp(0, 1)
    return soft_mask * sharp + (1 - soft_mask) * imgs


def add_noise(rng: np.random.Generator, img: np.ndarray, sigma_range, poisson_range,
              gaussian_prob: float, gray_prob: float) -> np.ndarray:
    """Per-image Gaussian-or-Poisson noise, gray with ``gray_prob``, on
    [B, H, W, 3] fp32 in [0, 1]: JAX's ``_add_noise``, the same numpy
    draws in the same order."""
    out = np.empty_like(img)
    for i in range(img.shape[0]):
        gray = rng.uniform() < gray_prob
        if rng.uniform() < gaussian_prob:
            sigma = rng.uniform(*sigma_range) / 255.0
            shape = img.shape[1:3] + ((1,) if gray else (3,))
            noise = rng.standard_normal(shape).astype(np.float32) * sigma
            out[i] = img[i] + noise
        else:
            scale = rng.uniform(*poisson_range)
            src = img[i].mean(-1, keepdims=True) if gray else img[i]
            rounded = np.round(np.clip(src, 0, 1) * 255.0) / 255.0
            vals = 2 ** np.ceil(np.log2(len(np.unique((rounded * 255).astype(np.uint8)))))
            noisy = rng.poisson(rounded * vals).astype(np.float32) / vals
            out[i] = img[i] + (noisy - rounded) * scale
    return np.clip(out, 0, 1)


def resize_batch(imgs: torch.Tensor, out_hw, mode: str) -> torch.Tensor:
    return torch.stack([resize(im, (out_hw[1], out_hw[0]), _WARP[mode]) for im in imgs])


@register("realesrgan_batch_transform")
class RealESRGANBatchTransform:
    def __init__(
        self,
        use_sharpener: bool,
        queue_size: int,
        resize_prob: Sequence[float],
        resize_range: Sequence[float],
        gray_noise_prob: float,
        gaussian_noise_prob: float,
        noise_range: Sequence[float],
        poisson_scale_range: Sequence[float],
        jpeg_range: Sequence[int],
        second_blur_prob: float,
        stage2_scale: Union[float, Sequence[float]],
        resize_prob2: Sequence[float],
        resize_range2: Sequence[float],
        gray_noise_prob2: float,
        gaussian_noise_prob2: float,
        noise_range2: Sequence[float],
        poisson_scale_range2: Sequence[float],
        jpeg_range2: Sequence[int],
    ):
        self.__dict__.update(locals())
        del self.self
        self._queue = None
        self._rng = np.random.default_rng()

    def _noise(self, img: torch.Tensor, sigma, poisson, gaussian_prob, gray_prob):
        return torch.from_numpy(add_noise(self._rng, img.numpy(), sigma, poisson,
                                          gaussian_prob, gray_prob))

    def _jpeg(self, img: torch.Tensor, q_range) -> torch.Tensor:
        return torch.from_numpy(np.stack([
            jpeg_compress_np(im.numpy(), int(self._rng.uniform(*q_range)))
            for im in img.clamp(0, 1)]))

    def _dequeue_and_enqueue(self, gt, lq, txt):
        """The shuffled pool of training pairs: filled first, then each batch
        swaps in for the first ``b`` of a permuted pool."""
        b = lq.shape[0]
        if self._queue is None:
            if self.queue_size % b:
                raise ValueError(f"queue_size {self.queue_size} is not a multiple of the "
                                 f"batch {b}")
            self._queue = {
                "lq": np.zeros((self.queue_size,) + lq.shape[1:], np.float32),
                "gt": np.zeros((self.queue_size,) + gt.shape[1:], np.float32),
                "txt": [""] * self.queue_size,
                "ptr": 0,
            }
        q = self._queue
        if q["ptr"] == self.queue_size:
            idx = self._rng.permutation(self.queue_size)
            q["lq"], q["gt"] = q["lq"][idx], q["gt"][idx]
            q["txt"] = [q["txt"][j] for j in idx]
            lq_out, gt_out = q["lq"][:b].copy(), q["gt"][:b].copy()
            txt_out = q["txt"][:b]
            q["lq"][:b], q["gt"][:b] = lq, gt
            q["txt"][:b] = list(txt)
            return gt_out, lq_out, txt_out
        q["lq"][q["ptr"]: q["ptr"] + b] = lq
        q["gt"][q["ptr"]: q["ptr"] + b] = gt
        q["txt"][q["ptr"]: q["ptr"] + b] = list(txt)
        q["ptr"] += b
        return gt, lq, txt

    def _updown(self, probs, scale_range) -> float:
        updown = random.choices(["up", "down", "keep"], probs)[0]
        if updown == "up":
            return self._rng.uniform(1, scale_range[1])
        if updown == "down":
            return self._rng.uniform(scale_range[0], 1)
        return 1.0

    @torch.no_grad()
    def __call__(self, batch: Dict) -> Dict:
        rng = self._rng
        hq = torch.as_tensor(np.asarray(batch["hq"], np.float32))  # [B, H, W, 3] in [0, 1]
        if self.use_sharpener:
            hq = usm_sharp(hq)
        ori_h, ori_w = hq.shape[1:3]

        # the first degradation
        out = filter2d(hq, torch.as_tensor(batch["kernel1"]))
        scale = self._updown(self.resize_prob, self.resize_range)
        if scale != 1.0:
            mode = random.choice(MODES)
            out = resize_batch(out, (int(ori_h * scale), int(ori_w * scale)), mode)
        out = self._noise(out, self.noise_range, self.poisson_scale_range,
                          self.gaussian_noise_prob, self.gray_noise_prob)
        out = self._jpeg(out, self.jpeg_range)

        # the second degradation
        if rng.uniform() < self.second_blur_prob:
            out = filter2d(out, torch.as_tensor(batch["kernel2"]))
        if isinstance(self.stage2_scale, (list, tuple)):
            stage2_scale = rng.uniform(*self.stage2_scale)
        else:
            stage2_scale = float(self.stage2_scale)
        s2h, s2w = int(ori_h / stage2_scale), int(ori_w / stage2_scale)
        scale = self._updown(self.resize_prob2, self.resize_range2)
        mode = random.choice(MODES)
        out = resize_batch(out, (int(s2h * scale), int(s2w * scale)), mode)
        out = self._noise(out, self.noise_range2, self.poisson_scale_range2,
                          self.gaussian_noise_prob2, self.gray_noise_prob2)
        sinc = torch.as_tensor(batch["sinc_kernel"])
        # [resize + sinc] and JPEG in random order
        if rng.uniform() < 0.5:
            out = resize_batch(out, (s2h, s2w), random.choice(MODES))
            out = self._jpeg(filter2d(out, sinc), self.jpeg_range2)
        else:
            out = self._jpeg(out, self.jpeg_range2)
            out = filter2d(resize_batch(out, (s2h, s2w), random.choice(MODES)), sinc)
        if stage2_scale != 1:
            out = resize_batch(out, (ori_h, ori_w), "bicubic")
        lq = torch.round(out.clamp(0, 1) * 255.0).clamp(0, 255) / 255.0

        gt, lq, txt = self._dequeue_and_enqueue(hq.numpy(), lq.numpy().astype(np.float32),
                                                batch["txt"])
        return {
            "gt": (gt * 2 - 1).astype(np.float32),  # [-1, 1]
            "lq": lq.astype(np.float32),            # [0, 1]
            "txt": txt,
        }


@register("identity_batch_transform")
class IdentityBatchTransform:
    """Pass-through for datasets that degrade on the host (codeformer)."""

    def __call__(self, batch):
        return batch
