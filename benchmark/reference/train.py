"""Plain reference of the DiffBIR v2.1 stage-2 (IRControlNet) training
step, in float32.

One step (DiffBIR ``train_stage2.py`` with ``train_stage2_v2.1.yaml``): the
frozen VAE's posterior sample of the ground truth, the frozen SwinIR
cleaner on the LQ, the condition (CLIP features of the prompt ids, the VAE
posterior mean of the cleaned image, noise-augmented to ``noise_aug``),
x_t = q_sample(z_0, t, eps) on the v2.1 schedule, the ControlNet-steered
UNet's v prediction against the v target, the mean squared error; the
backward to the ControlNet alone and AdamW (betas 0.9/0.999, eps 1e-8, no
weight decay) on float32 masters of its parameters. As the configuration
states, the weights the forward and backward see are the masters rounded to
bf16 (``weight_dtype``), the norms' scales and biases kept in float32; all
arithmetic is float32. The step's draws (posterior eps,
augmentation eps, t, q_sample eps) are given, as the benchmark hands them to
the program. A batch runs in blocks of rows whose gradients add up to the
batch mean's. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .models import ControlLDM, SwinIR
from .restore import v21_alphas_cumprod


def _coef(table: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.float32, device=t.device)[t.long()][:, None, None,
                                                                                  None]


def q_sample(x0, t, eps):
    ac = v21_alphas_cumprod()
    return _coef(np.sqrt(ac), t) * x0 + _coef(np.sqrt(1.0 - ac), t) * eps


def v_target(x0, eps, t):
    ac = v21_alphas_cumprod()
    return _coef(np.sqrt(ac), t) * eps - _coef(np.sqrt(1.0 - ac), t) * x0


def row_loss(cldm: ControlLDM, swinir: SwinIR, rows: Mapping[str, torch.Tensor],
             draws: Mapping[str, torch.Tensor], noise_aug: int) -> torch.Tensor:
    """The mean squared v error of a block of rows (differentiable in the
    ControlNet's parameters)."""
    with torch.no_grad():
        z0 = cldm.encode(rows["gt"], eps=draws["posterior"])
        clean = swinir(rows["lq"]).clamp(0.0, 1.0)
        c_txt = cldm.clip(rows["tokens"])
        c_img = cldm.encode(clean * 2 - 1)
        n = z0.shape[0]
        t_aug = torch.full((n,), noise_aug, dtype=torch.long, device=z0.device)
        c_img = q_sample(c_img, t_aug, draws["aug"])
        t = draws["t"]
        x_t = q_sample(z0, t, draws["noise"])
        target = v_target(z0, draws["noise"], t)
    pred = cldm(x_t, t.float(), c_txt, c_img)
    return ((pred - target) ** 2).mean()


def train_steps(cldm: ControlLDM, swinir: SwinIR, batches: Sequence[Mapping[str, torch.Tensor]],
                draws: Sequence[Mapping[str, torch.Tensor]], lr: float, noise_aug: int,
                block: int, weight_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Run one AdamW step per batch on ``cldm.controlnet``; returns
    {"loss": [per step], "grad": {leaf: the first step's gradient norm},
    "change": {leaf: the norm of its master's change after the last step}}."""
    names, params = zip(*cldm.controlnet.named_parameters())
    norms = {id(p) for m in cldm.controlnet.modules()
             if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)) for p in m.parameters()}
    masters = [p.detach().clone() for p in params]
    before = [m.clone() for m in masters]
    opt = torch.optim.AdamW(masters, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    out = {"loss": [], "grad": None, "change": None}
    for batch, dr in zip(batches, draws):
        with torch.no_grad():
            for p, m in zip(params, masters):
                p.copy_(m if id(p) in norms else m.to(weight_dtype))
        n = batch["gt"].shape[0]
        total = 0.0
        for s in range(0, n, block):
            sl = slice(s, min(n, s + block))
            part = row_loss(cldm, swinir, {k: v[sl] for k, v in batch.items()},
                            {k: v[sl] for k, v in dr.items()}, noise_aug)
            part = part * ((sl.stop - sl.start) / n)
            part.backward()
            total += float(part.detach())
        out["loss"].append(total)
        for p, m in zip(params, masters):
            m.grad = torch.zeros_like(m) if p.grad is None else p.grad
            p.grad = None
        if out["grad"] is None:
            out["grad"] = {n: float(m.grad.norm()) for n, m in zip(names, masters)}
        opt.step()
        opt.zero_grad(set_to_none=True)
    out["change"] = {n: float((m - b).norm()) for n, m, b in zip(names, masters, before)}
    return out
