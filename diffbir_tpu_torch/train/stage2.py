"""Stage-2 trainer core: the IRControlNet train step.

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

Mixed precision and processes: ``train/optim.py``'s ``MasterAdamW`` (fp32
masters of the ControlNet, bf16 weights on the card; with a
``parallel.DataParallel`` the gradients and the loss averaged over the data
group, as the loss is a batch mean).

The two-axis step of the JAX package's ``dryrun_multichip``: a
``DataParallel`` over ``parallel.make_mesh(n_data, n_tensor)``'s grid
(``DataParallel("mean", fsdp=True, grid=grid)``). ``init_train_state``
then tensor-shards the frozen UNet and CLIP and the trained ControlNet by
the same ``tp_plan`` over the grid's tensor group (the VAE has no sharded
unit: JAX's ``tp_spec`` replicates it too), and the optimiser keeps the
ControlNet's masters and moments as tensor slices, data-sharded on top.
Every process of a tensor group takes the same rows and draws (seed them
with ``parallel.process_seed(seed, grid)``) and computes the same loss;
the data group averages it. The frozen VAE encode and CLIP run their
tensor-parallel forwards under ``no_grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

from ..models.cldm import ControlLDM
from ..parallel.mesh import DataParallel
from ..parallel.tp import tp_shard_
from ..schedule import Schedule
from .optim import MasterAdamW

Cleaner = Callable[[torch.Tensor], torch.Tensor]


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-4,
                   accum_steps: int = 1, parallel: Optional[DataParallel] = None) -> MasterAdamW:
    """AdamW on fp32 masters with no weight decay (the JAX trainer passes
    0.0; torch's own default is 0.01); ``accum_steps > 1`` averages that
    many micro-batch gradients into one update. ``parallel`` (reduce
    "mean": the loss is a batch mean) spreads it over processes."""
    return MasterAdamW(params, learning_rate, accum_steps, weight_decay=0.0, parallel=parallel)


def init_train_state(cldm: ControlLDM, learning_rate: float = 1e-4, accum_steps: int = 1,
                     parallel: Optional[DataParallel] = None) -> MasterAdamW:
    """Freeze the UNet, VAE and CLIP, make the ControlNet trainable,
    tensor-shard the model over ``parallel``'s grid (n_tensor > 1; every
    process calls this together), and return the optimizer over the
    ControlNet's parameters only."""
    for frozen in (cldm.unet, cldm.vae, cldm.clip):
        frozen.requires_grad_(False)
    cldm.controlnet.requires_grad_(True)
    if parallel is not None and parallel.grid.n_tensor > 1:
        tp_shard_(cldm, parallel.grid.tensor_group)
    return make_optimizer(cldm.controlnet.parameters(), learning_rate, accum_steps, parallel)


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
        grads = optimizer.gradients()
        gnorm = optimizer.grad_norm(grads)
        optimizer.step(grads)
        return {"loss": optimizer.reduce_metric(loss.detach()), "grad_norm": gnorm}

    return train_step
