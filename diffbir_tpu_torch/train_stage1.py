"""The stage-1 SwinIR trainer:

    python -m diffbir_tpu_torch.train_stage1 --config <train yaml> [--device cuda|cpu]

Counterpart of the JAX repository's ``train_stage1.py``, on its config
(``configs/train/train_stage1.yaml``):

- Model: ``model.swinir`` (the JAX target resolves to the port's SwinIR),
  trained from scratch: ``random_init_`` from ``train.seed`` on the host,
  the same on every process (and broadcast from rank 0). bf16 weights with
  fp32 masters on the card, fp32 on the CPU. SwinIR's ``drop_path_rate`` is
  accepted and unused, as in JAX's step (``deterministic=True``).
- Step: ``train.stage1`` (the fp32 sum of squared errors, AdamW with weight
  decay 1e-4); ``gt`` mapped from [-1, 1] to [0, 1], ``lq`` already there.
- Data: ``dataset.train`` (the codeformer dataset: it raises on fewer items
  than the batch) through ``PrefetchIterator``, the mapping in its worker
  thread (``train/loop.py``: the per-process batch and seed,
  ``train.native_loader``).
- Logs: every ``log_every`` steps JAX's line ``step N: loss=...
  images/s=...``; every ``val_every`` steps ``step N: val psnr=... (k
  batches)`` over up to ``val_batches`` (default 8) batches of
  ``dataset.val`` read in order; tensorboardX scalars (``train/loss``,
  ``val/psnr``) when the package imports. No image grids and no deployable
  file, as in JAX.
- Checkpoints and resume (``train/loop.py``): every ``ckpt_every`` steps the
  full state under ``exp_dir/checkpoints/<step>.pt``, three kept; a loop
  that ends between checkpoints saves a last one; a truthy ``train.resume``
  restores one.
- Processes: one a card under the DIFFBIR_* (or torchrun's) environment;
  the loss is a sum over the global batch, so gradients and loss are summed
  over the processes; ``train.fsdp: true`` shards the masters and moments.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import config as cfglib
from .models.layers import random_init_
from .train import stage1
from .train.loop import DEFAULT_SEED, TrainerBase, run_trainer, tensorboard
from .utils import spans

VAL_BATCHES = 8


def to_unit_range(batch: Dict) -> Dict:
    """The codeformer batch for regression: gt from [-1, 1] to [0, 1]."""
    return {"gt": (batch["gt"] + 1) / 2, "lq": batch["lq"]}


class Stage1Trainer(TrainerBase):
    """The trainer's state and loop; ``main`` builds one and runs it."""

    REDUCE = "sum"

    def __init__(self, cfg: Dict, device="cuda"):
        super().__init__(cfg, device)
        swinir = cfglib.instantiate(cfg["model"]["swinir"], dtype=self.dtype, device="meta")
        self.model = swinir.to_empty(device=torch.device("cpu"))
        random_init_(self.model, torch.Generator().manual_seed(
            int(self.tcfg.get("seed", DEFAULT_SEED))))
        self.model = self.model.to(self.device).train()
        self.replicate_(self.model)
        self.optimizer = stage1.init_train_state(self.model, float(self.tcfg["learning_rate"]),
                                                 parallel=self.parallel)
        self.train_step = stage1.make_train_step(self.model, self.optimizer,
                                                 step_spans=self.step_spans)
        self.val_step = stage1.make_val_step(self.model, self.parallel)
        self.val_psnr: List[float] = []
        self.maybe_resume()

    def data(self):
        from . import dataset  # noqa: F401  (the registry names)

        return self.batches(cfglib.instantiate(self.cfg["dataset"]["train"]),
                            transform=to_unit_range)

    def validate(self) -> Tuple[float, int]:
        """The mean PSNR over up to ``val_batches`` batches of ``dataset.val``
        (each process reads the same batches, in order), and their count."""
        from .dataset.prefetch import to_device

        val_ds = cfglib.instantiate(self.cfg["dataset"]["val"])
        vit = val_ds.as_iterator(self.batch_size // self.n_data, shuffle=False)
        put = to_device(self.device)
        psnrs = []
        for _ in range(int(self.tcfg.get("val_batches", VAL_BATCHES))):
            try:
                vbatch = next(vit)
            except StopIteration:
                break
            psnrs.append(float(self.val_step(put(to_unit_range(vbatch)))["psnr"]))
        return float(np.mean(psnrs)) if psnrs else float("nan"), len(psnrs)

    def run(self) -> "Stage1Trainer":
        tcfg = self.tcfg
        bs, log_every = self.batch_size, int(tcfg["log_every"])
        has_val = "val" in self.cfg["dataset"]
        writer = tensorboard(self.exp_dir) if self.main else None
        it = self.data()
        try:
            t0 = time.perf_counter()
            while self.step < int(tcfg["train_steps"]):
                batch = self.next_batch(it)
                metrics = self.train_step(batch)
                self.step += 1
                if self.step % log_every == 0:
                    loss = float(metrics["loss"])
                    self.losses.append(loss)
                    ips = log_every * bs / (time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    self.log(f"step {self.step}: loss={loss:.1f} images/s={ips:.1f}")
                    if writer:
                        writer.add_scalar("train/loss", loss, self.step)
                if has_val and self.step % int(tcfg["val_every"]) == 0:
                    vpsnr, n = self.validate()
                    self.val_psnr.append(vpsnr)
                    self.log(f"step {self.step}: val psnr={vpsnr:.2f} ({n} batches)")
                    if writer:
                        writer.add_scalar("val/psnr", vpsnr, self.step)
                if self.step % int(tcfg["ckpt_every"]) == 0:
                    with spans.span("train.save", into=self.save_spans):
                        self.save()
                    self.log(f"saved checkpoint @ {self.step}")
        finally:
            it.close()
            if writer:
                writer.close()
        self.save_last()
        return self


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Stage-1 SwinIR training")
    p.add_argument("--config", required=True, help="a stage-1 train config (YAML)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Stage1Trainer:
    args = parse_args(argv)
    cfg = cfglib.load_yaml(args.config)
    return run_trainer(lambda: Stage1Trainer(cfg, args.device), args.device)


if __name__ == "__main__":
    main()
