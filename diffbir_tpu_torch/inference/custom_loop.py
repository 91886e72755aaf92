"""Custom-model loop (``--version custom --train_cfg <yaml> --ckpt <file>``).

Counterpart of ``diffbir_tpu/inference/custom_loop.py``: the settings come
from a stage-2 train config (``config.load_yaml``) instead of the version
table, whatever the task:

- the cleaner is ``model.swinir`` instantiated (its ``diffbir_tpu.*``
  target read as this package's class, ``config.resolve``), loaded from
  ``train.swinir_path`` (else the entry's ``ckpt``) as every cleaner is
  (``InferenceLoop._load_cleaner``: random under
  ``DIFFBIR_TPU_RANDOM_INIT``);
- the SD base from ``train.sd_path`` (a registry name or a path) and the
  ControlNet from ``--ckpt``, a torch file (a ``state_dict`` of the
  ControlNet); both are always read, as in JAX;
- the schedule from the config's explicit ``model.parameterization`` (eps
  by default) and ``model.zero_snr``;
- the serving flags as in every loop, and the LQ pre-upscaled by Pillow's
  bicubic before the x1 SwinIR.

An orbax directory (the JAX trainer's checkpoint) as ``--ckpt`` raises
ValueError naming it: orbax is not installed beside the port.
"""

from __future__ import annotations

import os

import numpy as np

from .. import config as cfglib
from ..models.cldm import ControlLDM
from ..pipeline import SwinIRPipeline
from ..schedule import Schedule
from ..weights.convert import load_into, load_stable_diffusion, load_torch_state_dict
from .loop import InferenceLoop, build_on
from .pretrained_models import resolve_model


class CustomInferenceLoop(InferenceLoop):
    def __init__(self, args):
        for flag in ("train_cfg", "ckpt"):
            if not getattr(args, flag, ""):
                raise ValueError(f"--version custom needs --{flag}")
        if os.path.isdir(args.ckpt):
            raise ValueError(f"--ckpt {args.ckpt}: a directory (an orbax checkpoint) is not "
                             "read; pass a torch file of the ControlNet's state_dict")
        self.train_cfg = cfglib.load_yaml(args.train_cfg)
        super().__init__(args)

    def load_cleaner(self) -> None:
        cfg = self.train_cfg["model"]["swinir"]
        name = (self.train_cfg.get("train") or {}).get("swinir_path") or cfg.get("ckpt")
        self.cleaner = self._load_cleaner(lambda **kw: cfglib.instantiate(cfg, **kw), name)

    def load_cldm(self) -> None:
        cldm = build_on(ControlLDM.sd21, self.device, dtype=self._dtype())
        sd_path = resolve_model(self.train_cfg["train"]["sd_path"])
        load_stable_diffusion(cldm, load_torch_state_dict(sd_path), sd_path)
        load_into(cldm.controlnet, load_torch_state_dict(self.args.ckpt), path=self.args.ckpt)
        self.cldm = self._serving(cldm)
        # the config's explicit keys: zero_snr alone does not say the
        # parameterization (v with zero_snr false exists)
        mcfg = self.train_cfg["model"]
        self.schedule = Schedule.create(
            1000, linear_start=0.00085, linear_end=0.0120,
            zero_snr=bool(mcfg.get("zero_snr", False)),
            parameterization=mcfg.get("parameterization", "eps"))

    def load_pipeline(self) -> None:
        self.pipeline = SwinIRPipeline(self.cleaner, self.cldm, self.schedule, self.device,
                                       tokenizer=self._tokenizer(), cond_fn=self.cond_fn)

    def after_load_lq(self, lq: np.ndarray) -> np.ndarray:
        return self.pre_upscale(lq)
