"""The demo's request runner and its stdlib HTTP front end.

    python -m diffbir_tpu_torch.run_gradio [--port 7860] [--version v2.1] [--tasks sr,face]
        [--upscale 4] [--steps 10] [--device cuda]

Counterpart of the JAX repository's ``run_gradio.py`` without its gradio UI
(gradio is not installed beside the port): ``build_runner(args)`` loads the
task pipelines once and returns ``process(image, **knobs)`` with the demo's
whole knob surface (task, upscale, sampler and its EDM parameters, CFG,
prompts, seed, control strength, noise augmentation, start point, every
tiling, restoration guidance), one request at a time under a lock, the
guidance set on the pipeline per request, outputs capped at 2048 pixels a
side; ``main`` serves it as ``POST /restore`` {"image": <base64 PNG>,
knobs...} -> {"image": <base64 PNG>}, unknown keys ignored. PNG only; the
input is upscaled by Pillow's bicubic bit for bit; ``--device`` is "cuda"
(the default) or "cpu".
"""

from __future__ import annotations

import argparse
import base64
import inspect
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from .serve import MAX_SIZE, decode_request_image, json_reply, loop_args, upscale_image
from .utils.cond_fn import MSEGuidance, WeightedMSEGuidance
from .utils.image_io import encode_png

DEFAULT_NEG = "low quality, blurry, low-resolution, noisy, unsharp, weird textures"


def build_runner(args):
    """``process(image, **knobs)`` over the pipelines of ``args.tasks`` (sr,
    face) at ``args.version``; the face task is left out, with a message,
    where its weights are absent."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    from .inference import BFRInferenceLoop, BSRInferenceLoop

    wanted = [t.strip() for t in args.tasks.split(",") if t.strip()]
    unknown = [t for t in wanted if t not in ("sr", "face")]
    if unknown:
        raise ValueError(f"unknown --tasks entries {unknown}; valid: sr, face")
    pipelines = {}
    if "sr" in wanted:
        pipelines["sr"] = BSRInferenceLoop(loop_args(args, "sr", version=args.version)).pipeline
    if "face" in wanted:
        try:
            pipelines["face"] = BFRInferenceLoop(
                loop_args(args, "face", version=args.version)).pipeline
        except FileNotFoundError as e:  # the face weights are absent: sr alone
            print(f"face pipeline unavailable ({e})")
    if not pipelines:
        raise RuntimeError("no task pipeline could be loaded")
    lock = threading.Lock()

    def process(
        image: np.ndarray, task: str = "sr", upscale: float = None, steps: int = 10,
        cfg_scale: float = 6.0, pos_prompt: str = "", neg_prompt: str = DEFAULT_NEG,
        seed: int = 231, sampler: str = "edm_dpm++_3m_sde", strength: float = 1.0,
        noise_aug: int = 0, rescale_cfg: bool = False, start_point_type: str = "noise",
        cleaner_tiled: bool = False, cleaner_tile_size: int = 512,
        cleaner_tile_stride: int = 256, vae_encoder_tiled: bool = False,
        vae_encoder_tile_size: int = 256, vae_decoder_tiled: bool = False,
        vae_decoder_tile_size: int = 256, cldm_tiled: bool = False, cldm_tile_size: int = 512,
        cldm_tile_stride: int = 256, guidance: bool = False, g_loss: str = "w_mse",
        g_scale: float = 0.0, g_space: str = "latent", g_start: int = 1001, g_stop: int = -1,
        g_repeat: int = 1, s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = 300.0,
        s_noise: float = 1.0, order: int = 1, eta: float = 1.0,
    ) -> np.ndarray:
        pipe = pipelines.get(task)
        if pipe is None:
            raise ValueError(f"task {task!r} unavailable (weights not loaded)")
        up = args.upscale if upscale is None else float(upscale)
        if max(image.shape[:2]) * up > MAX_SIZE:
            raise ValueError(f"output larger than {MAX_SIZE}^2 not allowed in demo")
        batch = upscale_image(np.asarray(image), up)[None]
        # the pipelines are shared state (cond_fn below): one request at a time
        with lock:
            if guidance and g_scale > 0:
                cls = MSEGuidance if g_loss == "mse" else WeightedMSEGuidance
                pipe.cond_fn = cls(float(g_scale), int(g_start), int(g_stop), g_space,
                                   int(g_repeat))
            else:
                pipe.cond_fn = None
            out = pipe.run(
                batch, steps=int(steps), strength=float(strength), pos_prompt=pos_prompt,
                neg_prompt=neg_prompt, cfg_scale=float(cfg_scale), sampler_type=sampler,
                seed=int(seed), noise_aug=int(noise_aug), rescale_cfg=bool(rescale_cfg),
                start_point_type=start_point_type, cleaner_tiled=bool(cleaner_tiled),
                cleaner_tile_size=int(cleaner_tile_size),
                cleaner_tile_stride=int(cleaner_tile_stride),
                vae_encoder_tiled=bool(vae_encoder_tiled),
                vae_encoder_tile_size=int(vae_encoder_tile_size),
                vae_decoder_tiled=bool(vae_decoder_tiled),
                vae_decoder_tile_size=int(vae_decoder_tile_size), cldm_tiled=bool(cldm_tiled),
                cldm_tile_size=int(cldm_tile_size), cldm_tile_stride=int(cldm_tile_stride),
                s_churn=float(s_churn), s_tmin=float(s_tmin), s_tmax=float(s_tmax),
                s_noise=float(s_noise), order=int(order), eta=float(eta))
        return out[0]

    process.tasks = list(pipelines)
    return process


class _Handler(BaseHTTPRequestHandler):
    process = None

    def log_message(self, *a):  # quiet
        pass

    def do_POST(self):
        if self.path != "/restore":
            self.send_error(404)
            return
        try:
            req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            img = decode_request_image(req.pop("image"))
            # unknown keys are ignored (older clients send extra fields)
            known = set(inspect.signature(type(self).process).parameters) - {"image"}
            out = type(self).process(img, **{k: v for k, v in req.items() if k in known})
            json_reply(self, {"image": base64.b64encode(encode_png(out)).decode()})
        except Exception as e:  # noqa: BLE001 - the client gets the message
            self.send_error(500, str(e))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m diffbir_tpu_torch.run_gradio")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--upscale", type=float, default=4.0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--precision", default="bf16", choices=["fp32", "fp16", "bf16"])
    ap.add_argument("--version", default="v2.1", choices=["v1", "v2", "v2.1"])
    ap.add_argument("--tasks", default="sr,face", help="comma list: sr,face")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    process = build_runner(args)
    print(f"serving HTTP JSON on :{args.port} (POST /restore), tasks {process.tasks}, "
          f"{args.device}")
    _Handler.process = staticmethod(process)
    ThreadingHTTPServer(("0.0.0.0", args.port), _Handler).serve_forever()


if __name__ == "__main__":
    main()
