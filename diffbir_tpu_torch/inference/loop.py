"""Base inference loop: model loading -> per-image restoration -> save.

Counterpart of ``diffbir_tpu/inference/loop.py``: the load order (cleaner,
ControlLDM, guidance, pipeline, captioner), the schedule per version, the
input scan (one file, or a folder's images in name order), the caption +
user prompt join, ``n_samples`` in chunks of ``batch_size`` with the seed
advanced per chunk (``seed + offset``), the tiling and turbo flags passed
to ``pipeline.run``, the output names, and ``prompt.csv``.

- Weights: the DiffBIR checkpoints by name (``pretrained_models``), loaded
  into the float model, then the CLI's serving flags applied
  (``ControlLDM.set_serving``, ``--fast_gelu`` too), as the JAX loop
  quantises after loading. The ControlNet by version and task: v1 face
  ``v1_face``, v1 sr or denoise ``v1_general``, v2 ``v2``, v2.1 ``v2.1``;
  the SD base ``sd_v2.1`` for v1 and v2 (eps schedule), ``sd_v2.1_zsnr``
  for v2.1 (zero SNR, v). With ``DIFFBIR_TPU_RANDOM_INIT=1`` random
  weights take their place (the JAX loop's switch): the ControlLDM's from
  ``--seed``, a cleaner's from seed 0 (``_load_cleaner``); the production
  path, no file read.
- Guidance (``--guidance``, ``--g_*``): ``load_cond_fn`` builds the
  ``utils.cond_fn`` loss the pipeline holds, as in JAX.
- ``--precision fp16`` runs in bf16, as in JAX.
- Images: PNG only (``utils.image_io``, no image library); outputs are
  PNGs, named ``<stem>.png`` or ``<stem>_<i>.png`` with ``n_samples`` > 1.
- ``prompt.csv`` (file_name, prompt, neg_prompt) gets one row appended per
  saved sample, with the header when the file is new, as the reference
  does; the JAX loop rewrites it instead.
- Runs on ``args.device`` ("cuda" unless the caller asks for "cpu").
  ``timings`` adds up seconds per stage: load, read, the pipeline's stages
  (each ended by a device sync), write.
"""

from __future__ import annotations

import csv
import os
import time
from argparse import Namespace
from typing import Dict, Iterator

import numpy as np
import torch

from ..models.cldm import ControlLDM
from ..models.layers import random_init_
from ..schedule import Schedule
from ..utils.caption import build_captioner
from ..utils.cond_fn import MSEGuidance, WeightedMSEGuidance
from ..utils.common import pil_bicubic_resize
from ..utils.image_io import read_rgb, write_png
from ..weights.convert import load_into, load_stable_diffusion, load_torch_state_dict
from .pretrained_models import resolve_model

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def random_init_requested() -> bool:
    """DIFFBIR_TPU_RANDOM_INIT=1: random weights instead of checkpoints."""
    return os.environ.get("DIFFBIR_TPU_RANDOM_INIT") == "1"


def make_schedule_for_version(version: str) -> Schedule:
    """diffusion.yaml (v1/v2: eps) vs diffusion_v2.1.yaml (zero SNR + v)."""
    if version in ("v1", "v2"):
        return Schedule.create(1000, linear_start=0.00085, linear_end=0.0120,
                               zero_snr=False, parameterization="eps")
    return Schedule.v21()


def build_on(factory, device: torch.device, **kw) -> torch.nn.Module:
    """A module built without memory (meta), then given empty storage on
    ``device``: its values come from a checkpoint or ``random_init_``."""
    return factory(device="meta", **kw).to_empty(device=device)


def controlnet_name(version: str, task: str) -> str:
    """The IRControlNet checkpoint of a version and task."""
    if version == "v1":
        name = {"sr": "v1_general", "denoise": "v1_general", "face": "v1_face"}.get(task)
        if name is None:
            raise ValueError(f"DiffBIR v1 doesn't support task: {task}")
        return name
    return version


class InferenceLoop:
    def __init__(self, args: Namespace):
        self.args = args
        self.device = torch.device(getattr(args, "device", "cuda"))
        self.loop_ctx: Dict[str, str] = {}
        self.timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        self.load_cleaner()
        self.load_cldm()
        self.load_cond_fn()
        self.load_pipeline()
        self.load_captioner()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["load"] = time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    def _dtype(self) -> torch.dtype:
        return torch.float32 if getattr(self.args, "precision", "bf16") == "fp32" \
            else torch.bfloat16

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def load_cleaner(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def _load_cleaner(self, factory, name: str) -> torch.nn.Module:
        """A stage-1 cleaner built by ``factory`` (keywords ``device``,
        ``dtype``): random weights from seed 0 under
        ``DIFFBIR_TPU_RANDOM_INIT``, else the checkpoint ``name`` (a
        registry name or a path) loaded strictly. The JAX
        ``load_cleaner_params``."""
        cleaner = build_on(factory, self.device, dtype=self._dtype())
        if random_init_requested():
            random_init_(cleaner, self._generator(0))
        else:
            path = resolve_model(name)
            load_into(cleaner, load_torch_state_dict(path), path=path)
        return cleaner.eval()

    def load_cldm(self) -> None:
        args = self.args
        cldm = build_on(ControlLDM.sd21, self.device, dtype=self._dtype())
        if random_init_requested():
            random_init_(cldm, self._generator(getattr(args, "seed", 0)))
        else:
            sd_path = resolve_model("sd_v2.1_zsnr" if args.version == "v2.1" else "sd_v2.1")
            load_stable_diffusion(cldm, load_torch_state_dict(sd_path), sd_path)
            cn_path = resolve_model(controlnet_name(args.version, args.task))
            load_into(cldm.controlnet, load_torch_state_dict(cn_path), path=cn_path)
        self.cldm = self._serving(cldm)
        self.schedule = make_schedule_for_version(args.version)

    def _serving(self, cldm: ControlLDM) -> ControlLDM:
        """The loaded float model in eval mode with the CLI's serving flags."""
        args = self.args
        return cldm.eval().set_serving(
            quant_dense=bool(getattr(args, "quant_dense", False)),
            fused_resblock=bool(getattr(args, "fused_resblock", False)),
            quant_conv=bool(getattr(args, "quant_conv", False)),
            fused_ffn=bool(getattr(args, "fused_ffn", False)),
            fast_gelu=bool(getattr(args, "fast_gelu", False)))

    def load_cond_fn(self) -> None:
        """The guidance loss of ``--g_loss`` with ``--g_*``, or None."""
        a = self.args
        if not getattr(a, "guidance", False):
            self.cond_fn = None
            return
        cls = {"mse": MSEGuidance, "w_mse": WeightedMSEGuidance}[a.g_loss]
        self.cond_fn = cls(a.g_scale, a.g_start, a.g_stop, a.g_space, a.g_repeat)

    def load_pipeline(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def load_captioner(self) -> None:
        self.captioner = build_captioner(getattr(self.args, "captioner", "none"),
                                         llava_bit=str(getattr(self.args, "llava_bit", "4")),
                                         device=self.device)

    def _tokenizer(self):
        """The CLIP tokenizer (``models.tokenizer``): a missing merges file
        raises FileNotFoundError naming it."""
        from ..models.tokenizer import get_tokenizer

        return get_tokenizer()

    # ------------------------------------------------------------------ #
    def input_files(self):
        inp = self.args.input
        if os.path.isfile(inp):
            return [inp]
        if not os.path.isdir(inp):
            raise FileNotFoundError(f"input {inp} is neither a file nor a folder")
        return sorted(os.path.join(inp, f) for f in os.listdir(inp)
                      if f.lower().endswith(IMG_EXTS))

    def load_lq(self) -> Iterator[np.ndarray]:
        skip = getattr(self.args, "skip_existing", False)
        for path in self.input_files():
            stem = os.path.splitext(os.path.basename(path))[0]
            if skip and self.args.n_samples == 1 and os.path.exists(
                    os.path.join(self.save_dir, f"{stem}.png")):
                print(f"[loop] skip {stem} (exists)", flush=True)
                continue
            self.loop_ctx["file_stem"] = stem
            t0 = time.perf_counter()
            img = read_rgb(path)
            self._add("read", time.perf_counter() - t0)
            yield img

    def after_load_lq(self, lq: np.ndarray) -> np.ndarray:
        return lq

    def pre_upscale(self, lq: np.ndarray) -> np.ndarray:
        """The LQ resized by ``--upscale`` with Pillow's bicubic (bit for
        bit), for the x1 cleaners."""
        h, w = lq.shape[:2]
        up = self.args.upscale
        return pil_bicubic_resize(torch.from_numpy(lq), (int(h * up), int(w * up))).numpy()

    def _add(self, stage: str, seconds: float) -> None:
        self.timings[stage] = self.timings.get(stage, 0.0) + seconds

    def setup(self) -> None:
        self.save_dir = self.args.output
        os.makedirs(self.save_dir, exist_ok=True)

    def run(self) -> None:
        self.setup()
        for idx, lq in enumerate(self.load_lq(), 1):
            caption = self.captioner(lq)
            pos_prompt = ", ".join(p for p in (caption, self.args.pos_prompt) if p)
            t0 = time.perf_counter()
            lq_arr = self.after_load_lq(lq)
            self._add("upscale", time.perf_counter() - t0)
            self.loop_ctx["prompt"] = pos_prompt
            n = self.args.n_samples
            bs = max(1, int(getattr(self.args, "batch_size", n) or n))
            print(f"[loop] #{idx} {self.loop_ctx['file_stem']} "
                  f"lq={lq_arr.shape[0]}x{lq_arr.shape[1]}", flush=True)
            t0 = time.perf_counter()
            chunks = [self._run_pipeline(np.stack([lq_arr] * min(bs, n - off)), pos_prompt, off)
                      for off in range(0, n, bs)]
            samples = np.concatenate(chunks, axis=0)
            print(f"[loop] #{idx} {self.loop_ctx['file_stem']} done "
                  f"out={samples.shape[1]}x{samples.shape[2]} "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            t0 = time.perf_counter()
            for i in range(samples.shape[0]):
                self.save(samples[i], i)
            self._add("write", time.perf_counter() - t0)

    def _run_pipeline(self, batch: np.ndarray, pos_prompt: str, seed_offset: int = 0):
        a = self.args
        return self.pipeline.run(
            batch, steps=a.steps, strength=a.strength, pos_prompt=pos_prompt,
            neg_prompt=a.neg_prompt, cfg_scale=a.cfg_scale,
            start_point_type=a.start_point_type, sampler_type=a.sampler,
            noise_aug=a.noise_aug, rescale_cfg=a.rescale_cfg,
            cleaner_tiled=a.cleaner_tiled, cleaner_tile_size=a.cleaner_tile_size,
            cleaner_tile_stride=a.cleaner_tile_stride, vae_encoder_tiled=a.vae_encoder_tiled,
            vae_encoder_tile_size=a.vae_encoder_tile_size,
            vae_decoder_tiled=a.vae_decoder_tiled,
            vae_decoder_tile_size=a.vae_decoder_tile_size, vae_tile_mode=a.vae_tile_mode,
            cldm_tiled=a.cldm_tiled, cldm_tile_size=a.cldm_tile_size,
            cldm_tile_stride=a.cldm_tile_stride, cldm_tiles_per_batch=a.cldm_tiles_per_batch,
            control_interval=getattr(a, "control_interval", 1),
            turbo_encoder=getattr(a, "turbo_encoder", False),
            size_bucket=getattr(a, "size_bucket", 0),
            # distinct chunks of n_samples get distinct seeds
            seed=a.seed + seed_offset,
            eta=getattr(a, "eta", 0.0), s_churn=getattr(a, "s_churn", 0.0),
            s_tmin=getattr(a, "s_tmin", 0.0), s_tmax=getattr(a, "s_tmax", 300.0),
            s_noise=getattr(a, "s_noise", 1.0), order=getattr(a, "order", 1),
            timings=self.timings)

    def output_name(self, sample_idx: int) -> str:
        stem = self.loop_ctx["file_stem"]
        return f"{stem}_{sample_idx}.png" if self.args.n_samples > 1 else f"{stem}.png"

    def save(self, img: np.ndarray, sample_idx: int) -> None:
        name = self.output_name(sample_idx)
        write_png(os.path.join(self.save_dir, name), img)
        self.log_prompt(name)

    def log_prompt(self, name: str) -> None:
        """Append ``name``'s row to ``prompt.csv`` (the header first when
        the file is new)."""
        csv_path = os.path.join(self.save_dir, "prompt.csv")
        new = not os.path.exists(csv_path)
        with open(csv_path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["file_name", "prompt", "neg_prompt"])
            w.writerow([name, self.loop_ctx.get("prompt", ""),
                        getattr(self.args, "neg_prompt", "")])
