"""The port's inference CLI:

    python -m diffbir_tpu_torch.inference --task sr --input <png or folder> --output <folder>

Counterpart of the JAX package's ``inference.py``: the same flags and
defaults (10 steps of ``edm_dpm++_3m_sde`` at CFG 6.0, the long default
prompts, ``--captioner none``), except ``--device``: "cuda" (the default)
or "cpu", never chosen for the caller. The serving flags
(``--quant_dense --fused_resblock --quant_conv --fused_ffn``) compose on the
loaded model (``ControlLDM.set_serving``); the tiling flags (cleaner, VAE
encoder and decoder, diffusion, ``--vae_tile_mode``,
``--cldm_tiles_per_batch``) and the turbo flags (``--control_interval``,
``--turbo_encoder``) reach ``Pipeline.run``; ``--fast_gelu`` reaches
``set_serving``; restoration guidance (``--guidance`` with ``--g_loss``,
``--g_scale``, ``--g_start``, ``--g_stop``, ``--g_space``, ``--g_repeat``)
becomes the pipeline's ``cond_fn``.

Tasks: sr (``BSRInferenceLoop``), face (aligned faces,
``BFRInferenceLoop``) and denoise (``BIDInferenceLoop``), each in versions
v1, v2 and v2.1; unaligned_face (``UnAlignedBFRInferenceLoop``: RetinaFace
detection, a face request per aligned crop, the background request, the
paste back) in v2 and v2.1, v1 raising the ValueError of its ControlNet
matrix, as in JAX; ``--version custom`` takes ``CustomInferenceLoop`` (a
train config's cleaner and schedule, ``--ckpt``'s ControlNet) whatever the
task.
"""

from __future__ import annotations

from argparse import ArgumentParser, Namespace
from typing import Optional, Sequence

import torch

from ..pipeline import SAMPLER_CHOICES
from .loop import controlnet_name

DEFAULT_POS_PROMPT = (
    "Cinematic, High Contrast, highly detailed, taken using a Canon EOS R camera, "
    "hyper detailed photo - realistic maximum detail, 32k, Color Grading, ultra HD, "
    "extreme meticulous detailing, skin pore detailing, hyper sharpness, perfect "
    "without deformations."
)

DEFAULT_NEG_PROMPT = (
    "painting, oil painting, illustration, drawing, art, sketch, oil painting, "
    "cartoon, CG Style, 3D render, unreal engine, blurring, dirty, messy, worst "
    "quality, low quality, frames, watermark, signature, jpeg artifacts, deformed, "
    "lowres, over-smooth."
)


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="python -m diffbir_tpu_torch.inference")
    # model
    p.add_argument("--task", type=str, required=True,
                   choices=["sr", "face", "denoise", "unaligned_face"])
    p.add_argument("--upscale", type=float, default=1.0)
    p.add_argument("--version", type=str, default="v2.1", choices=["v1", "v2", "v2.1", "custom"])
    p.add_argument("--train_cfg", type=str, default="")
    p.add_argument("--ckpt", type=str, default="")
    # sampling
    p.add_argument("--sampler", type=str, default="edm_dpm++_3m_sde", choices=SAMPLER_CHOICES)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--start_point_type", type=str, default="noise", choices=["noise", "cond"])
    p.add_argument("--cleaner_tiled", action="store_true")
    p.add_argument("--cleaner_tile_size", type=int, default=512)
    p.add_argument("--cleaner_tile_stride", type=int, default=256)
    p.add_argument("--vae_encoder_tiled", action="store_true")
    p.add_argument("--vae_encoder_tile_size", type=int, default=256)
    p.add_argument("--vae_decoder_tiled", action="store_true")
    p.add_argument("--vae_decoder_tile_size", type=int, default=256)
    p.add_argument("--vae_tile_mode", type=str, default="blend", choices=["blend", "sync_gn"])
    p.add_argument("--cldm_tiled", action="store_true")
    p.add_argument("--cldm_tile_size", type=int, default=512)
    p.add_argument("--cldm_tile_stride", type=int, default=256)
    p.add_argument("--size_bucket", type=int, default=0,
                   help="pad the LQ (reflect) to x64 and the condition to multiples of this "
                        "many pixels, and crop the output back; 0: the exact x64 padding")
    p.add_argument("--cldm_tiles_per_batch", type=int, default=1)
    p.add_argument("--captioner", type=str, default="none", choices=["none", "llava", "ram"])
    p.add_argument("--pos_prompt", type=str, default=DEFAULT_POS_PROMPT)
    p.add_argument("--neg_prompt", type=str, default=DEFAULT_NEG_PROMPT)
    p.add_argument("--cfg_scale", type=float, default=6.0)
    p.add_argument("--rescale_cfg", action="store_true")
    p.add_argument("--noise_aug", type=int, default=0)
    p.add_argument("--s_churn", type=float, default=0.0)
    p.add_argument("--s_tmin", type=float, default=0.0)
    p.add_argument("--s_tmax", type=float, default=300.0)
    p.add_argument("--s_noise", type=float, default=1.0)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--order", type=int, default=4, help="order of the edm_lms solver")
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--turbo_encoder", action="store_true")
    p.add_argument("--control_interval", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    # guidance
    p.add_argument("--guidance", action="store_true")
    p.add_argument("--g_loss", type=str, default="w_mse", choices=["mse", "w_mse"])
    p.add_argument("--g_scale", type=float, default=0.0)
    p.add_argument("--g_start", type=int, default=1001)
    p.add_argument("--g_stop", type=int, default=-1)
    p.add_argument("--g_space", type=str, default="latent", choices=["latent", "rgb"])
    p.add_argument("--g_repeat", type=int, default=1)
    # io
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--seed", type=int, default=231)
    # device
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--precision", type=str, default="bf16", choices=["fp32", "fp16", "bf16"])
    p.add_argument("--quant_dense", action="store_true",
                   help="int8 weight-only UNet/ControlNet dense sites (K4)")
    p.add_argument("--fused_resblock", action="store_true",
                   help="each UNet/ControlNet ResBlock as one fused kernel (K6)")
    p.add_argument("--quant_conv", action="store_true",
                   help="int8 ResBlock conv weights inside the fused ResBlock "
                        "(requires --fused_resblock)")
    p.add_argument("--llava_bit", type=str, default="4", choices=["16", "8", "4"])
    p.add_argument("--fused_ffn", action="store_true",
                   help="each transformer FFN as one fused GEGLU kernel (K7)")
    p.add_argument("--fast_gelu", action="store_true")
    return p


def check_ported(args: Namespace) -> None:
    """ValueError for a version that lacks the task (v1 unaligned_face)
    and for flags that do not combine, before anything loads."""
    if args.version != "custom":
        controlnet_name(args.version, args.task)
    if args.quant_conv and not args.fused_resblock:
        raise ValueError("--quant_conv requires --fused_resblock")


def parse_args(argv: Optional[Sequence[str]] = None) -> Namespace:
    args = build_parser().parse_args(argv)
    check_ported(args)
    return args


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI; returns the loop (its ``timings`` hold seconds per
    stage)."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    from . import (BFRInferenceLoop, BIDInferenceLoop, BSRInferenceLoop, CustomInferenceLoop,
                   UnAlignedBFRInferenceLoop)

    if args.version == "custom":
        loop = CustomInferenceLoop(args)
    else:
        loop = {"sr": BSRInferenceLoop, "face": BFRInferenceLoop, "denoise": BIDInferenceLoop,
                "unaligned_face": UnAlignedBFRInferenceLoop}[args.task](args)
    loop.run()
    print(f"done! results saved to {args.output}")
    return loop


if __name__ == "__main__":
    main()
