"""Stage-1 trainer core: SwinIR regression from lq to gt.

Counterpart of ``diffbir_tpu/train/stage1.py`` (``make_optimizer``,
``init_state``, ``make_train_step``, ``make_val_step``):

- the loss is ``sum((pred - gt)^2)`` in fp32, reduction **sum** (the
  reference's MSE with reduction='sum');
- the optimiser is optax.adamw's default: AdamW at ``learning_rate`` with
  weight decay **1e-4** on every leaf (betas 0.9/0.999, eps 1e-8), here
  ``MasterAdamW`` over fp32 masters of every SwinIR parameter (bf16 weights
  on the card, fp32 on the CPU);
- the val step: the batch mean of ``psnr(clamp(pred, 0, 1), gt)`` (float64
  MSE) and the MSE.

Across processes (``parallel.DataParallel`` with reduce "sum") the loss is
the sum over the global batch, so the gradients and the loss are summed,
as JAX's ``jnp.sum`` over the batch sharded across its mesh is.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from ..parallel.mesh import DataParallel
from ..utils import spans
from ..utils.common import psnr
from .optim import MasterAdamW

WEIGHT_DECAY = 1e-4  # optax.adamw's default


def make_optimizer(model: torch.nn.Module, learning_rate: float = 1e-4,
                   weight_decay: float = WEIGHT_DECAY,
                   parallel: Optional[DataParallel] = None) -> MasterAdamW:
    """AdamW on fp32 masters of every parameter of ``model``."""
    return MasterAdamW(model.parameters(), learning_rate, weight_decay=weight_decay,
                       parallel=parallel)


def init_train_state(model: torch.nn.Module, learning_rate: float = 1e-4,
                     weight_decay: float = WEIGHT_DECAY,
                     parallel: Optional[DataParallel] = None) -> MasterAdamW:
    """Make every parameter of ``model`` trainable and return its optimiser."""
    model.requires_grad_(True)
    return make_optimizer(model, learning_rate, weight_decay, parallel)


def make_train_step(model: torch.nn.Module, optimizer: MasterAdamW,
                    step_spans: Optional[List[spans.Span]] = None):
    """Returns train_step(batch) -> {"loss"} (a 0-dim fp32 tensor on the
    device, not synchronised). batch: {"gt": [0, 1] NHWC, "lq": [0, 1]
    NHWC} on the model's device. The spans and ``step_spans`` are stage
    2's (``train.step`` over ``train.forward``, ``train.backward``,
    ``train.optimizer``)."""

    def train_step(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        dev = batch["lq"].device
        with spans.span("train.step", dev, into=step_spans):
            with spans.span("train.forward", dev):
                pred = model(batch["lq"])
                loss = torch.sum((pred.float() - batch["gt"].float()) ** 2)
            with spans.span("train.backward", dev):
                loss.backward()
            with spans.span("train.optimizer", dev):
                optimizer.step(optimizer.gradients())
            return {"loss": optimizer.reduce_metric(loss.detach())}

    return train_step


def make_val_step(model: torch.nn.Module, parallel: Optional[DataParallel] = None):
    """Returns val_step(batch) -> {"psnr", "mse"}: batch means (over the
    processes' batches too, with ``parallel``)."""

    @torch.no_grad()
    def val_step(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        pred = model(batch["lq"]).float().clamp(0.0, 1.0)
        gt = batch["gt"].float()
        out = {"psnr": psnr(pred, gt).mean(), "mse": torch.mean((pred - gt) ** 2)}
        if parallel is not None:
            out = {k: parallel.reduce_metric(v, mean=True) for k, v in out.items()}
        return out

    return val_step
