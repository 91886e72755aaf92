"""Stage-2 trainer core: the IRControlNet train step on one device.

Counterpart of ``diffbir_tpu/train/stage2.py`` (``make_optimizer``,
``init_train_state``, ``make_train_step``): the SD2.1 UNet, VAE and CLIP and
the cleaner are frozen; only the ControlNet is trained, by AdamW. One step:

- frozen: z_0 = posterior sample of vae_encode(gt), clean = cleaner(lq),
  cond = prepare_condition(clean, tokens), c_img noise-augmented to
  ``noise_aug_timestep``;
- t ~ U[0, T), x_t = q_sample(z_0, t, eps), the model call, the fp32 loss
  against ``schedule.target``;
- backward, the global norm of this micro-batch's gradients, and the AdamW
  step (taken every ``accum_steps`` micro-batches, on their mean gradient, as
  ``optax.MultiSteps`` does).

Mixed precision: the modules keep their weights in the compute dtype (bf16
on the card), as serving does, and the optimizer keeps fp32 master copies of
the ControlNet's parameters. Gradients of the bf16 weights are taken to fp32,
the master is updated in fp32 and rounded back into the module after each
update. That is the JAX package's arithmetic (fp32 parameters cast to bf16 at
every use) without adding casts to the serving path, and it keeps updates
that bf16 would lose: at lr 1e-5 an AdamW update is far below bf16's 2^-7
spacing near 1.0.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

from ..models.cldm import ControlLDM
from ..schedule import Schedule

Cleaner = Callable[[torch.Tensor], torch.Tensor]


class MasterAdamW:
    """AdamW over fp32 master copies of ``params`` (betas 0.9/0.999, eps
    1e-8 and weight decay 0, as the JAX trainer calls optax.adamw; torch's
    own default decay is 0.01), with gradient accumulation over
    ``accum_steps`` micro-batches by a running mean (optax.MultiSteps)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float,
                 accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.params = list(params)
        self.masters = [p.detach().to(torch.float32, copy=True) for p in self.params]
        self.optimizer = torch.optim.AdamW(self.masters, lr=learning_rate, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=0.0)
        self.accum_steps = accum_steps
        self.micro_step = 0  # micro-batches accumulated since the last update
        self.updates = 0     # AdamW updates taken

    @torch.no_grad()
    def step(self) -> bool:
        """Fold this micro-batch's ``.grad`` (None counts as zero) into the
        masters' mean gradient and clear it; on the last micro-batch of an
        accumulation, update the masters and copy them into the module.
        Returns whether the module's parameters changed."""
        n = self.micro_step
        for p, m in zip(self.params, self.masters):
            g = torch.zeros_like(m) if p.grad is None else p.grad.to(torch.float32)
            if n == 0:
                m.grad = g
            else:
                m.grad += (g - m.grad) / (n + 1)
            p.grad = None
        self.micro_step += 1
        if self.micro_step < self.accum_steps:
            return False
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.micro_step = 0
        self.updates += 1
        for p, m in zip(self.params, self.masters):
            p.copy_(m)
        return True


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-4,
                   accum_steps: int = 1) -> MasterAdamW:
    """AdamW on fp32 masters; ``accum_steps > 1`` averages that many
    micro-batch gradients into one update."""
    return MasterAdamW(params, learning_rate, accum_steps)


def init_train_state(cldm: ControlLDM, learning_rate: float = 1e-4,
                     accum_steps: int = 1) -> MasterAdamW:
    """Freeze the UNet, VAE and CLIP, make the ControlNet trainable, and
    return the optimizer over the ControlNet's parameters only."""
    for frozen in (cldm.unet, cldm.vae, cldm.clip):
        frozen.requires_grad_(False)
    cldm.controlnet.requires_grad_(True)
    return make_optimizer(cldm.controlnet.parameters(), learning_rate, accum_steps)


def make_loss_fn(cldm: ControlLDM, schedule: Schedule, cleaner: Optional[Cleaner] = None,
                 noise_aug_timestep: int = 0):
    """Returns loss_fn(batch, generator=None, draws=None) -> the fp32 loss of
    one micro-batch, differentiable in the ControlNet's parameters only.

    batch: {"gt": [-1, 1] NHWC, "lq": [0, 1] NHWC, "tokens": [B, 77] int} on
    the model's device. The step's randomness is ``draws`` when given —
    {"posterior": eps of the posterior sample, NHWC latent; "aug": eps of
    the c_img noise augmentation, NHWC latent; "t": int [B]; "noise": eps of
    q_sample, NHWC latent} — else it is drawn from ``generator`` in that
    order (the JAX trainer splits its key in the same order)."""

    def loss_fn(batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                draws: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        if draws is None and generator is None:
            raise ValueError("a train step needs a generator or draws")
        gt, lq, tokens = batch["gt"], batch["lq"], batch["tokens"]
        bs = gt.shape[0]
        with torch.no_grad():
            z_0 = cldm.vae_encode(gt, sample=True, generator=generator,
                                  eps=None if draws is None else draws["posterior"])

            def draw(key, shape):
                if draws is not None:
                    return draws[key].to(z_0.device, torch.float32)
                return torch.randn(shape, generator=generator, device=z_0.device)

            clean = cleaner(lq) if cleaner is not None else lq
            cond = cldm.prepare_condition(clean, tokens)
            if noise_aug_timestep > 0:
                t_aug = torch.full((bs,), noise_aug_timestep, dtype=torch.long,
                                   device=z_0.device)
                cond["c_img"] = schedule.q_sample(cond["c_img"], t_aug,
                                                  draw("aug", cond["c_img"].shape))
            if draws is not None:
                t = draws["t"].to(z_0.device, torch.long)
            else:
                t = torch.randint(0, schedule.num_timesteps, (bs,), generator=generator,
                                  device=z_0.device)
            noise = draw("noise", z_0.shape)
            x_noisy = schedule.q_sample(z_0, t, noise)
            target = schedule.target(z_0, noise, t)
        pred = cldm(x_noisy, t.float(), cond)
        return schedule.loss(pred.float(), target)

    return loss_fn


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm)."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


def make_train_step(cldm: ControlLDM, schedule: Schedule, optimizer: MasterAdamW,
                    cleaner: Optional[Cleaner] = None, noise_aug_timestep: int = 0):
    """Returns train_step(batch, generator=None, draws=None) -> {"loss",
    "grad_norm"} (0-dim fp32 tensors on the device, not synchronised); see
    ``make_loss_fn`` for batch and draws. ``optimizer`` comes from
    ``init_train_state``."""
    loss_fn = make_loss_fn(cldm, schedule, cleaner, noise_aug_timestep)

    def train_step(batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        loss = loss_fn(batch, generator, draws)
        loss.backward()
        gnorm = global_norm(p.grad for p in optimizer.params if p.grad is not None)
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
