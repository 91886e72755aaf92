"""The stage-2 IRControlNet trainer:

    python -m diffbir_tpu_torch.train_stage2 --config <train yaml> [--device cuda|cpu]

Counterpart of the JAX repository's ``train_stage2.py``:

- Models: ``ControlLDM.sd21`` (``model.cldm.use_checkpoint`` and
  ``fused_resblock``), the SD base from ``train.sd_path`` and the frozen
  cleaner ``model.swinir`` from ``train.swinir_path`` (registry names or
  paths, ``inference.pretrained_models.resolve_model``; both loaded
  strictly), the ControlNet initialised from the UNet with every other
  ControlNet tensor zero (JAX's zero-initialised tree); the schedule from
  ``model.parameterization`` and ``model.zero_snr``.
- Optimiser and step: ``train.stage2.init_train_state(lr, accum_steps)``
  (AdamW over fp32 masters of the ControlNet) and ``make_train_step``
  with ``noise_aug_timestep``; the step's draws from a generator seeded
  with ``train.seed``.
- Data: ``dataset.train`` -> ``batch_transform`` -> ``PrefetchIterator``
  (the transform in its worker thread, the batch staged on the card); the
  prompts through the port's CLIP tokenizer.
- Logs: every ``log_every`` steps JAX's line ``step N: loss=... grad=...
  images/s=...``; tensorboardX's writer under ``exp_dir/tb`` when the
  package imports, as in JAX, and then every ``image_every`` steps the
  preview (``preview``: 50 spaced steps at CFG 1.0 on the batch's first four
  conditions, decoded).
- Checkpoints (``train/loop.py``): every ``ckpt_every`` steps the full
  training state (``exp_dir/checkpoints/<step>.pt``: the ControlNet's fp32
  masters, the AdamW moments, the accumulation state, the step; the three
  newest kept) and the deployable ``exp_dir/controlnet_<step>.pth``, the
  ControlNet's ``state_dict`` (fp32, DiffBIR's keys) that ``--version
  custom --ckpt`` reads. A truthy ``train.resume: <step>`` restores the
  full state; a loop that ends between checkpoints saves a last full
  state.
- Precision: bf16 weights on the card, fp32 on the CPU (the tests' tiny
  runs).
- Processes (``train/loop.py``, ``parallel/``): one a card under the
  DIFFBIR_* (or torchrun's) environment, each with ``batch_size //
  processes`` rows and its data and the step's draws from
  ``process_seed(seed)``; the ControlNet's gradients and the loss averaged
  (the loss is a batch mean); ``train.fsdp: true`` shards the masters and
  AdamW moments; rank 0 writes the files. The preview runs in a single
  process only, as in JAX. ``train.native_loader: true`` reads through the
  C++ loader where it builds.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from . import config as cfglib
from .inference.loop import build_on
from .inference.pretrained_models import resolve_model
from .models.cldm import ControlLDM
from .pipeline import model_function
from .sampler.spaced import SpacedSampler
from .schedule import Schedule
from .train import stage2
from .parallel.distributed import process_seed
from .train.loop import DEFAULT_SEED, TrainerBase, run_trainer, tensorboard
from .utils import spans
from .weights.convert import load_into, load_stable_diffusion, load_torch_state_dict

PREVIEW_STEPS = 50
PREVIEW_IMAGES = 4
@torch.no_grad()
def preview(cldm: ControlLDM, schedule: Schedule, clean: torch.Tensor, tokens: torch.Tensor,
            generator: torch.Generator, steps: int = PREVIEW_STEPS) -> torch.Tensor:
    """JAX's preview: the condition of ``clean`` (NHWC in [0, 1]) and
    ``tokens``, ``steps`` spaced steps from noise at CFG 1.0, decoded:
    NHWC fp32 in [0, 1]."""
    sampler = SpacedSampler(schedule.betas, schedule.parameterization, False)
    cond = cldm.prepare_condition(clean, tokens)
    x_t = torch.randn(cond["c_img"].shape, generator=generator, device=clean.device)
    z = sampler.sample(model_function(cldm), x_t, cond, None, 1.0, steps, generator=generator)
    return ((cldm.vae_decode(z).float() + 1) / 2).clamp(0.0, 1.0)


class Stage2Trainer(TrainerBase):
    """The trainer's state and loop; ``main`` builds one and runs it.
    ``cldm_factory`` builds the ControlLDM (``ControlLDM.sd21``; the
    tests pass the tiny config)."""

    REDUCE = "mean"

    def __init__(self, cfg: Dict, device="cuda",
                 cldm_factory: Callable[..., ControlLDM] = ControlLDM.sd21):
        super().__init__(cfg, device)
        self._build_models(cldm_factory)
        self.replicate_(self.cldm.controlnet)
        self.optimizer = stage2.init_train_state(self.cldm, float(self.tcfg["learning_rate"]),
                                                 int(self.tcfg.get("accum_steps", 1)),
                                                 self.parallel)
        self.train_step = stage2.make_train_step(
            self.cldm, self.schedule, self.optimizer, self.cleaner,
            noise_aug_timestep=int(self.tcfg.get("noise_aug_timestep", 0)),
            step_spans=self.step_spans)
        self.maybe_resume()

    def _build_models(self, cldm_factory) -> None:
        mcfg, tcfg = self.cfg["model"], self.tcfg
        ccfg = mcfg.get("cldm") or {}
        cldm = build_on(cldm_factory, self.device, dtype=self.dtype,
                        use_checkpoint=bool(ccfg.get("use_checkpoint")),
                        fused_resblock=bool(ccfg.get("fused_resblock")))
        sd_path = resolve_model(tcfg["sd_path"])
        load_stable_diffusion(cldm, load_torch_state_dict(sd_path), sd_path)
        with torch.no_grad():
            for p in cldm.controlnet.parameters():
                p.zero_()
        cldm.load_controlnet_from_unet()
        self.cldm = cldm
        self.schedule = Schedule.create(
            1000, linear_start=0.00085, linear_end=0.0120,
            zero_snr=bool(mcfg.get("zero_snr", False)),
            parameterization=mcfg.get("parameterization", "eps"))
        swinir = cfglib.instantiate(mcfg["swinir"], dtype=self.dtype, device="meta")
        swinir = swinir.to_empty(device=self.device)
        swin_path = resolve_model(tcfg["swinir_path"])
        load_into(swinir, load_torch_state_dict(swin_path), path=swin_path)
        self.swinir = swinir.eval().requires_grad_(False)

    def cleaner(self, lq: torch.Tensor) -> torch.Tensor:
        return self.swinir(lq).clamp(0.0, 1.0)

    # ------------------------------------------------------------------ #
    def save_deployable(self) -> str:
        """``controlnet_<step>.pth``: the ControlNet's state_dict with its
        parameters from the fp32 masters (every process gathers, rank 0
        writes)."""
        masters = self.optimizer.full_masters()
        path = os.path.join(self.exp_dir, f"controlnet_{self.step}.pth")
        if self.main:
            sd = {k: v.detach().cpu() for k, v in self.cldm.controlnet.state_dict().items()}
            for (name, _), m in zip(self.cldm.controlnet.named_parameters(), masters):
                sd[name] = m.detach().cpu()
            torch.save(sd, path)
        return path

    # ------------------------------------------------------------------ #
    def data(self):
        """The prefetching iterator of transformed batches on the device."""
        from . import dataset  # noqa: F401  (the registry names)

        ds = cfglib.instantiate(self.cfg["dataset"]["train"])
        bt = cfglib.instantiate(self.cfg["batch_transform"])
        return self.batches(ds, transform=bt)

    def tokens(self, batch) -> torch.Tensor:
        from .models.tokenizer import get_tokenizer

        texts = batch["txt"] if "txt" in batch else batch["prompt"]
        return torch.from_numpy(get_tokenizer()(list(texts))).long().to(self.device)

    def run(self) -> "Stage2Trainer":
        tcfg = self.tcfg
        bs, log_every = self.batch_size, int(tcfg["log_every"])
        writer = tensorboard(self.exp_dir) if self.main else None
        # the step's draws (posterior, t, noise) for this process's rows:
        # per process, as its data, so the processes' rows differ
        gen = torch.Generator(device=self.device).manual_seed(
            process_seed(int(tcfg.get("seed", DEFAULT_SEED))))
        it = self.data()
        try:
            t0 = time.perf_counter()
            while self.step < int(tcfg["train_steps"]):
                batch = self.next_batch(it)
                dev_batch = {"gt": batch["gt"], "lq": batch["lq"], "tokens": self.tokens(batch)}
                metrics = self.train_step(dev_batch, gen)
                self.step += 1
                if self.step % log_every == 0:
                    loss = float(metrics["loss"])
                    self.losses.append(loss)
                    ips = log_every * bs / (time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    self.log(f"step {self.step}: loss={loss:.4f} "
                             f"grad={float(metrics['grad_norm']):.3f} images/s={ips:.1f}")
                    if writer:
                        writer.add_scalar("train/loss", loss, self.step)
                if (writer and self.n_data == 1
                        and self.step % int(tcfg.get("image_every", 1000)) == 0):
                    n = min(PREVIEW_IMAGES, bs)
                    lq = dev_batch["lq"][:n]
                    grid = preview(self.cldm, self.schedule, self.cleaner(lq),
                                   dev_batch["tokens"][:n], gen)
                    writer.add_images("train/preview",
                                      grid.permute(0, 3, 1, 2).cpu().numpy(), self.step)
                    writer.add_images("train/lq", lq.permute(0, 3, 1, 2).float().cpu().numpy(),
                                      self.step)
                if self.step % int(tcfg["ckpt_every"]) == 0:
                    with spans.span("train.save", into=self.save_spans):
                        self.save()
                        self.save_deployable()
                    self.log(f"saved checkpoints @ {self.step}")
        finally:
            it.close()
            if writer:
                writer.close()
        self.save_last()
        return self


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Stage-2 IRControlNet training")
    p.add_argument("--config", required=True, help="a stage-2 train config (YAML)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         cldm_factory: Callable[..., ControlLDM] = ControlLDM.sd21) -> Stage2Trainer:
    args = parse_args(argv)
    cfg = cfglib.load_yaml(args.config)
    return run_trainer(lambda: Stage2Trainer(cfg, args.device, cldm_factory), args.device)


if __name__ == "__main__":
    main()
