"""Restoration guidance: a gradient step on the sampler's x0 prediction.

Counterpart of ``diffbir_tpu/utils/cond_fn.py``: ``MSEGuidance`` and
``WeightedMSEGuidance`` (the MSE weighted by 1 - tanh of the 2x2-block sums
of the Sobel magnitude of the target's BT.601 gray, edge-padded, under
stop-gradient), the scale times 3000, the [t_stop, t_start] window and
``repeat`` rounds (applied by ``sampler.base.apply_guidance``), and
``RGBSpaceGuidance``, which decodes a latent x0 with the VAE, crops it to
the target's size and takes the loss in fp32 there, so the gradient runs
back through the decoder.

Inputs are NHWC in [-1, 1]. ``__call__(target, pred)`` returns (-grad *
scale, loss), the gradient from ``torch.autograd.grad`` on a detached copy
of ``pred`` under ``torch.enable_grad()``: the samplers and the pipeline run
under ``no_grad``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

_GRAY = (0.2989, 0.5870, 0.1140)
_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def _value_and_grad(loss_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_fn(x), d loss / dx), with a graph built even under no_grad."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_()
        loss = loss_fn(leaf)
        (grad,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), grad


class Guidance:
    def __init__(self, scale: float, t_start: int, t_stop: int, space: str, repeat: int):
        self.scale = scale * 3000.0
        self.t_start = t_start
        self.t_stop = t_stop
        self.space = space  # "latent" or "rgb"
        self.repeat = repeat

    def loss(self, pred_x0: torch.Tensor, target_x0: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, target_x0: torch.Tensor, pred_x0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the gradient step g, the scalar loss)."""
        loss, grad = _value_and_grad(lambda p: self.loss(p, target_x0), pred_x0)
        return -grad * self.scale, loss


class RGBSpaceGuidance:
    """``--g_space rgb``: ``inner``'s loss between the decoded latent x0
    (``decode_fn``, NHWC in [-1, 1], cropped to the target's size, fp32) and
    the RGB target; the gradient reaches the latent through the decoder."""

    def __init__(self, inner: Guidance, decode_fn: Callable[[torch.Tensor], torch.Tensor]):
        self.inner = inner
        self.decode_fn = decode_fn
        self.t_start, self.t_stop = inner.t_start, inner.t_stop
        self.repeat, self.scale = inner.repeat, inner.scale
        self.space = "rgb"

    def __call__(self, target_rgb: torch.Tensor, pred_z0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, w = target_rgb.shape[1:3]

        def loss_fn(z):
            return self.inner.loss(self.decode_fn(z)[:, :h, :w, :].float(), target_rgb)

        loss, grad = _value_and_grad(loss_fn, pred_z0)
        return -grad * self.scale, loss


class MSEGuidance(Guidance):
    def loss(self, pred_x0, target_x0):
        return ((pred_x0 - target_x0) ** 2).mean(dim=(1, 2, 3)).sum()


class WeightedMSEGuidance(Guidance):
    @staticmethod
    def weight(target01: torch.Tensor) -> torch.Tensor:
        """1 - tanh(2x2-block sums of the Sobel magnitude), NHWC [N, H, W, 1]
        of a [0, 1] NHWC RGB image; H and W must be even. (A 4-channel
        latent has no gray: the JAX package fails there too, so w_mse
        guidance needs ``space="rgb"``.)"""
        n, h, w, c = target01.shape
        if c != 3:
            raise ValueError(f"w_mse guidance weighs an RGB target, got {c} channels: use "
                             "--g_space rgb, or --g_loss mse in the latent space")
        if h % 2 or w % 2:
            raise ValueError(f"the 2x2-block weight needs an even size, got {h}x{w}")
        gray = (target01 * target01.new_tensor(_GRAY)).sum(dim=-1)[:, None]  # [N, 1, H, W]
        kernel = target01.new_tensor((_SOBEL_X, _SOBEL_Y))[:, None]  # [2, 1, 3, 3]
        grad = F.conv2d(F.pad(gray, (1, 1, 1, 1), mode="replicate"), kernel)
        mag = grad.pow(2).sum(dim=1).sqrt()  # [N, H, W]
        blocks = torch.tanh(mag.reshape(n, h // 2, 2, w // 2, 2).sum(dim=(2, 4)))
        return 1.0 - blocks.repeat_interleave(2, 1).repeat_interleave(2, 2)[..., None]

    def loss(self, pred_x0, target_x0):
        w = self.weight((target_x0 + 1) / 2).detach()
        return ((pred_x0 - target_x0) ** 2 * w).mean(dim=(1, 2, 3)).sum()

