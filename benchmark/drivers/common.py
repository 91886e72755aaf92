"""What both drivers share: the program's networks and the reference's,
built from a configuration file's sizes and filled with the benchmark's
weights; the run's context; the comparison's bookkeeping."""

from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from ..lib import weights


@dataclass
class Context:
    """One run: the configuration and traffic files' contents, the command
    line's seed, window and trace switch, the device, and ``faults``:
    {name: callable} a test plants into the timed path."""
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float
    faults: Dict[str, Callable] = field(default_factory=dict)
    check: bool = True                  # False: no comparison (the sweeps)


def sizes_json(config: dict) -> str:
    return json.dumps({"cldm": config["cldm"], "swinir": config["swinir"]}, sort_keys=True)


def program_networks(config: dict, device, seed: int, use_checkpoint: bool = False):
    """The port's ControlLDM and SwinIR at the configuration's sizes and
    dtype, on ``device``, holding the benchmark's weights of ``seed``."""
    from diffbir_tpu_torch.models.cldm import ControlLDM
    from diffbir_tpu_torch.models.clip import CLIPTextEncoder
    from diffbir_tpu_torch.models.swinir import SwinIR
    from diffbir_tpu_torch.models.unet import ControlNet, UNetModel
    from diffbir_tpu_torch.models.vae import AutoencoderKL

    dtype = getattr(torch, config["dtype"])
    s = config["cldm"]
    kw = dict(dtype=dtype, device="meta")
    cldm = ControlLDM(
        unet=UNetModel(use_checkpoint=use_checkpoint, **s["unet"], **kw),
        vae=AutoencoderKL(**s["vae"], **kw), clip=CLIPTextEncoder(**s["clip"], **kw),
        controlnet=ControlNet(use_checkpoint=use_checkpoint, **s["controlnet"], **kw))
    swinir = SwinIR(**config["swinir"], **kw)
    cldm, swinir = cldm.to_empty(device=device), swinir.to_empty(device=device)
    gen = weights.generator(seed, device)
    weights.fill_(cldm.named_parameters(), gen)
    weights.fill_(swinir.named_parameters(), gen)
    return cldm, swinir


def reference_networks(config: dict, device, seed: int):
    """The float32 reference networks holding the same weights."""
    from ..reference.models import build

    with torch.device("meta"):
        cldm, swinir = build("cldm", config["cldm"]), build("swinir", config["swinir"])
    cldm, swinir = cldm.to_empty(device=device), swinir.to_empty(device=device)
    gen = weights.generator(seed, device)
    weights.fill_(cldm.named_parameters(), gen)
    weights.fill_(swinir.named_parameters(), gen)
    return cldm.eval(), swinir.eval()


def release(device) -> None:
    """Free what the program held before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_precision() -> None:
    """float32 matmuls and convolutions without TF32 for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def checked(name: str, value: float, limit: float) -> dict:
    """One compared number beside its limit (correct while value <= limit)."""
    return {"name": name, "value": float(value), "limit": float(limit)}


def device_info(device, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak_bytes)}


def log(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)
