"""Profile one denoise step, one stage-2 training step, or one decode step
of the LLaVA-1.5-7B captioner, of the port on a CUDA device.

The denoise step is the model call a 512x512 request makes at each step: a
full-width SD2.1 ControlLDM (UNet + IRControlNet, random bf16 weights from
seed 0) at batch 2 on a 64x64 latent, classifier-free guidance folded into
the batch, cond and uncond on the CLI's default prompts through a seeded
stand-in tokenizer, through the model function the pipeline hands the
sampler (``pipeline.model_function``: the hoisted context k/v and timestep
tables of ``--sampler``'s grid for ``--steps`` steps, default 50 spaced;
``--no-hoist`` the loop's own), at the grid's first timestep; with
``--mode fused`` or ``--mode int8`` the same step in
the CLI's serving mode of that name ("fused": the fused ResBlock K6, the
fused GEGLU FFN K7 and the packed flash layout K3; "int8": int8 dense
weights on K4, the fused ResBlock on int8 convs, packed). With ``--train``
the step is instead one stage-2 training step of
``build_train_setup``, which ``chip_smoke.py`` drives too: gradient
checkpointing, the ControlNet initialised from the UNet, a frozen realesrgan
SwinIR cleaner, the v2.1 schedule with noise augmentation at 200, AdamW at
lr 1e-5, batch 8 at 512x512. With ``--caption BITS`` (4, 8 or 16) it is one
greedy decode step of LLaVA-1.5-7B (random bf16 weights from seed 0, the big
linears on K5 at 4 bits, on K4 at 8) after a 624-row prefill, as
``chip_smoke.py``'s captions run 59 of them. ``--request`` times whole
512x512 requests instead; ``--request --tiled`` times 1024x1024 requests
with the cleaner, the VAE and the diffusion tiled (the CLI's tile sizes:
cleaner 512/256, VAE 256, diffusion 512/256, ``--tiles_per_batch`` latent
tiles per model call), then times and profiles one tiled denoise step (the
9 latent tiles of a 128x128 latent, folded CFG, no hoisting). Prints

- host and device time per step, with the flash kernels (K1, and K2a/K2b in
  training) and with plain attention, in the order plain, kernel, kernel,
  plain: the medians over 10 calls (5 when training) of the host's enqueue
  time (call to return), of the wall time (call to device sync) and of the
  device span between two CUDA events;
  (a decode step and a serving mode's step are timed through the kernels
  only);
- a ``torch.profiler`` view of 3 steps through the kernels: device time by
  kernel, device kernels and ``aten::copy_`` calls per step, the device time
  of each of the port's kernels that ran, and the device's busy share of the
  profiled window.

Run from the repository root on a machine with a card:

    python3 -m diffbir_tpu_torch.profile_step [--train | --caption 4 | --mode int8 |
        --request [--tiled [--tiles_per_batch 3]]] [--sampler edm_dpm++_3m_sde --steps 10]
        [--no-hoist] [--trace step_trace.json]
"""

from __future__ import annotations

import argparse
import statistics
import time
import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.autograd import DeviceType

from .models.cldm import ControlLDM
from .models.layers import random_init_
from .models.swinir import SwinIR
from .inference.__main__ import DEFAULT_NEG_PROMPT as NEG_PROMPT
from .inference.__main__ import DEFAULT_POS_PROMPT as POS_PROMPT
from .pipeline import EOT, SOT, SwinIRPipeline
from .schedule import Schedule
from .train import stage2

LATENT, CFG, SEED = 64, 4.0, 0
# the tiled request: a 1024x1024 condition, every tiling at the CLI's sizes
TILED_SIZE = 1024
TILED = dict(cleaner_tiled=True, vae_encoder_tiled=True, vae_decoder_tiled=True, cldm_tiled=True)
TIMED_STEPS, TIMED_TRAIN_STEPS, PROFILED_STEPS = 10, 5, 3
TRAIN_BATCH, TRAIN_LR, NOISE_AUG = 8, 1e-5, 200
# the captioner's decode step: after a prompt of 35 + 576 + 13 rows
CAPTION_ROWS, CAPTION_NEW = 624, 60
# substrings of the device kernel names of the port's kernels: K1 (K3 is its
# PRESCALE instance; the VAE's d = 512 on its wide kernel), K2a and K2b (the
# tensor-core entries, and the CUDA-core ones that fp32 and d >= 256 take),
# K4 (the tile form, the GEMV form with its split reduction, the CUDA-core
# entry), K5 (the same three), K6 (the
# tensor-core entry's GroupNorm statistics and apply launches, convolutions
# and split reductions; the CUDA-core entry's launches) and K7 (the
# tensor-core launches, the CUDA-core ones)
KERNELS = {"K1/K3": "flash_fwd_tc_kernel", "K1 (d = 512)": "flash_fwd_wide_kernel",
           "K1/K3 (CUDA cores)": "flash_fwd_kernel",
           "K2a": "flash_bwd_dq_tc_kernel", "K2b": "flash_bwd_dkv_tc_kernel",
           "K2a (CUDA cores)": "flash_bwd_dq_kernel", "K2b (CUDA cores)": "flash_bwd_dkv_kernel",
           "K4": "quant_matmul_tc_kernel", "K4 GEMV": "gemv::",
           "K4 (CUDA cores)": "quant_matmul_kernel", "K5": "int4_tc_kernel",
           "K5 GEMV": "decode::", "K5 (CUDA cores)": "namespace)::int4_",
           "K6 GroupNorm": "tc::gn_", "K6 conv": "conv_tc_kernel",
           "K6 reduce": "conv_reduce_kernel",
           "K6 GroupNorm (CUDA cores)": "namespace)::gn_affine_kernel",
           "K6 conv (CUDA cores)": "namespace)::conv_kernel",
           "K7 geglu": "geglu_tc_kernel", "K7 down": "down_tc_kernel",
           "K7 (CUDA cores)": "namespace)::geglu_kernel",
           "K7 down (CUDA cores)": "namespace)::down_kernel"}


def stand_in_tokenizer(seed: int = SEED, context_length: int = 77):
    """A seeded stand-in for the CLIP tokenizer, whose vocabulary is not in
    the repository: each word of a text becomes an id in [0, SOT) from a hash
    of the seed and the word, between SOT and EOT, zero-padded to
    ``context_length`` (``Pipeline``'s ``tokenizer``: list of texts -> int
    ids [n, context_length]). The empty text gives the empty-prompt ids."""
    def tokenize(texts):
        out = np.zeros((len(texts), context_length), np.int64)
        for row, text in zip(out, texts):
            ids = [zlib.crc32(f"{seed}:{w}".encode()) % SOT
                   for w in text.split()[:context_length - 2]]
            row[:len(ids) + 2] = [SOT, *ids, EOT]
        return out
    return tokenize


def build_step(seed: int, device: torch.device, mode: str = "default",
               sampler: str = "spaced", steps: int = 50, hoist: bool = True):
    """A full-width bf16 ControlLDM in a serving mode
    (``ControlLDM.set_mode``) and one sampler step's folded-CFG call, cond
    and uncond on the default prompts' stand-in ids, through the pipeline's
    model function at the first timestep of the sampler's grid (the
    hoisted tables of that grid unless ``hoist`` is False)."""
    from .pipeline import build_sampler, model_function
    from .sampler.base import GuidedModel

    gen = torch.Generator(device=device).manual_seed(seed)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device=device)
    random_init_(cldm, gen).eval().set_mode(mode)
    tokenizer = stand_in_tokenizer(seed)
    pos, neg = (torch.as_tensor(tokenizer([text]), device=device)
                for text in (POS_PROMPT, NEG_PROMPT))
    size = 8 * LATENT
    with torch.no_grad():
        img = torch.rand(1, size, size, 3, generator=gen, device=device)
        cond = cldm.prepare_condition(img, pos)
        uncond = dict(c_txt=cldm.encode_text(neg), c_img=cond["c_img"])
    x = torch.randn(1, LATENT, LATENT, 4, generator=gen, device=device)
    grid = build_sampler(sampler, Schedule.v21(), False).model_ts(steps)
    tables = None
    if hoist:
        with torch.no_grad():
            tables = cldm.make_hoist_tables(torch.cat([cond["c_txt"], uncond["c_txt"]]), grid)
    model = GuidedModel(model_function(cldm, 1.0, tables), cond, uncond)
    t = float(np.max(grid))

    @torch.no_grad()
    def step():
        return model(x, t, CFG)

    return cldm, step


def build_tiled_step(seed: int, device: torch.device, sampler: str = "spaced",
                     steps: int = 50, tiles_per_batch: int = 1):
    """A full-width bf16 ControlLDM and one denoise step of the tiled
    1024x1024 request: the pipeline's ``tiled_model_function`` (latent tile
    64 at stride 32, ``tiles_per_batch`` tiles a model call) on a 128x128
    latent, folded CFG on the default prompts' stand-in ids, the condition
    encoded by the tiled VAE, at the first timestep of the sampler's grid;
    and the same step with the model function replaced by the identity
    (the tiling's own slicing, weighting and blending alone)."""
    from .pipeline import build_sampler, tiled_model_function
    from .sampler.base import GuidedModel
    from .tiling import make_tiled_fn

    gen = torch.Generator(device=device).manual_seed(seed)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device=device)
    random_init_(cldm, gen).eval()
    tokenizer = stand_in_tokenizer(seed)
    pos, neg = (torch.as_tensor(tokenizer([text]), device=device)
                for text in (POS_PROMPT, NEG_PROMPT))
    with torch.no_grad():
        img = torch.rand(1, TILED_SIZE, TILED_SIZE, 3, generator=gen, device=device)
        cond = cldm.prepare_condition(img, pos, tiled=True)
        uncond = dict(c_txt=cldm.encode_text(neg), c_img=cond["c_img"])
    x = torch.randn(1, TILED_SIZE // 8, TILED_SIZE // 8, 4, generator=gen, device=device)
    model = GuidedModel(tiled_model_function(cldm, 1.0, 512, 256, tiles_per_batch), cond, uncond)
    t = float(np.max(build_sampler(sampler, Schedule.v21(), False).model_ts(steps)))

    @torch.no_grad()
    def step():
        return model(x, t, CFG)

    blend = GuidedModel(make_tiled_fn(lambda x_tiles, t, c: x_tiles, 64, 32, channel=4,
                                      tiles_per_batch=tiles_per_batch), cond, uncond)

    @torch.no_grad()
    def blend_step():
        return blend(x, t, CFG)

    return step, blend_step


def time_requests(seed: int, device: torch.device, sampler: str, steps: int,
                  seeds=(1, 2, 3), tiles_per_batch=None) -> None:
    """Whole 512x512 requests (``SwinIRPipeline.run``) after one warm-up, or
    with ``tiles_per_batch`` tiled 1024x1024 ones: seconds per request and
    per stage."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device=device)
    random_init_(cldm, gen).eval()
    swinir = SwinIR(dtype=torch.bfloat16, device="meta").to_empty(device=device)
    random_init_(swinir, gen).eval()
    pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), device,
                          tokenizer=stand_in_tokenizer(seed))
    kw = dict(steps=steps, cfg_scale=CFG, pos_prompt=POS_PROMPT, neg_prompt=NEG_PROMPT)
    if sampler != "spaced":
        kw.update(sampler_type=sampler, eta=1.0)
    size = 8 * LATENT
    if tiles_per_batch is not None:
        size = TILED_SIZE
        kw.update(TILED, cldm_tiles_per_batch=tiles_per_batch)
    lq = np.random.default_rng(seed).integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    pipe.run(lq, seed=0, **kw)
    for s in seeds:
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run(lq, seed=s, timings=timings, **kw)
        dt = time.perf_counter() - t0
        split = ", ".join(f"{k} {v:.4f}" for k, v in timings.items())
        print(f"[request] {size}x{size}{' tiled' if tiles_per_batch else ''}, {sampler} x "
              f"{steps} steps, seed {s}: {dt:.4f} s ({split} s)")


@dataclass
class TrainSetup:
    """The full-width stage-2 training setup and one fixed batch."""
    cldm: ControlLDM
    swinir: SwinIR
    schedule: Schedule
    cleaner: Callable[[torch.Tensor], torch.Tensor]
    optimizer: stage2.MasterAdamW
    train_step: Callable[..., dict]
    batch: dict


def build_train_setup(seed: int, device: torch.device, batch_size: int = TRAIN_BATCH,
                      size: int = 8 * LATENT) -> TrainSetup:
    """SD2.1 + IRControlNet (random bf16 weights from ``seed``, gradient
    checkpointing, the ControlNet initialised from the UNet), the frozen
    realesrgan SwinIR cleaner, the v2.1 schedule with noise augmentation at
    200 and AdamW at lr 1e-5 over fp32 masters, as
    ``configs/train/train_stage2_v2.1.yaml``; the batch is gt in [-1, 1] and
    lq in [0, 1] from ``numpy.random.default_rng(seed)``, empty prompts."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, use_checkpoint=True,
                           device="meta").to_empty(device=device)
    random_init_(cldm, gen)
    cldm.load_controlnet_from_unet()
    swinir = SwinIR(dtype=torch.bfloat16, device="meta").to_empty(device=device)
    random_init_(swinir, gen).eval().requires_grad_(False)

    def cleaner(lq):
        return swinir(lq).clamp(0.0, 1.0)

    schedule = Schedule.v21()
    optimizer = stage2.init_train_state(cldm, TRAIN_LR)
    train_step = stage2.make_train_step(cldm, schedule, optimizer, cleaner, NOISE_AUG)
    rng = np.random.default_rng(seed)
    tokens = torch.zeros(batch_size, cldm.clip.context_length, dtype=torch.long,
                         device=device)
    tokens[:, 0], tokens[:, 1] = SOT, EOT
    batch = {"gt": torch.tensor(rng.uniform(-1, 1, (batch_size, size, size, 3)),
                                dtype=torch.float32, device=device),
             "lq": torch.tensor(rng.random((batch_size, size, size, 3)),
                                dtype=torch.float32, device=device),
             "tokens": tokens}
    return TrainSetup(cldm, swinir, schedule, cleaner, optimizer, train_step, batch)


def build_train_step(seed: int, device: torch.device):
    """``build_train_setup``'s ControlLDM and one train step on its batch."""
    setup = build_train_setup(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def step():
        return setup.train_step(setup.batch, gen)

    return setup.cldm, step


def build_decode_step(seed: int, device: torch.device, bits: int):
    """LLaVA-1.5-7B in bf16 (random from ``seed``, quantised in place at 4 or
    8 bits), its KV caches filled by a prefill of CAPTION_ROWS random rows,
    and one decode step at the next position."""
    from .models.llava import Llava, quantize_llama_

    gen = torch.Generator(device=device).manual_seed(seed)
    model = Llava.llava15_7b(dtype=torch.bfloat16, device="meta").to_empty(device=device)
    random_init_(model, gen).eval()
    if bits != 16:
        quantize_llama_(model, bits)
    lm = model.language_model
    embeds = torch.randn(1, CAPTION_ROWS, lm.cfg.dim, generator=gen, device=device)
    with torch.no_grad():
        _, cache = lm.prefill(embeds.to(torch.bfloat16), CAPTION_ROWS + CAPTION_NEW)
    token = torch.ones(1, dtype=torch.long, device=device)

    @torch.no_grad()
    def step():
        return lm.decode_step(token, CAPTION_ROWS, cache)

    return step


def time_steps(step, n: int) -> dict:
    """Medians over n calls, each started on an idle device."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    enq, wall, dev = [], [], []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        step()
        e1.record()
        t1 = time.perf_counter()
        e1.synchronize()
        t2 = time.perf_counter()
        enq.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
        dev.append(e0.elapsed_time(e1))
    return {k: statistics.median(v) for k, v in
            (("enqueue_ms", enq), ("wall_ms", wall), ("device_ms", dev))}


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_steps(step, n: int, trace: str | None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    ours = {name: [e.time_range.elapsed_us() for e in kernels if symbol in e.name]
            for name, symbol in KERNELS.items()}
    copies = sum(1 for e in events if e.name == "aten::copy_")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    return {"table": table, "steps": n, "window_ms": window / 1e3,
            "busy_ms_per_step": busy / 1e3 / n, "kernels_per_step": len(kernels) / n,
            "ms_per_step": {k: sum(v) / 1e3 / n for k, v in ours.items()},
            "launches_per_step": {k: len(v) / n for k, v in ours.items()},
            "copies_per_step": copies / n, "busy_share": busy / window}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile a stage-2 training step instead of a denoise step")
    ap.add_argument("--caption", type=int, choices=(4, 8, 16), default=None,
                    help="profile a decode step of the LLaVA-1.5-7B captioner at these bits")
    ap.add_argument("--mode", choices=("default", "fused", "int8"), default="default",
                    help="the serving mode of the denoise step")
    ap.add_argument("--request", action="store_true",
                    help="time whole 512x512 requests instead of a step")
    ap.add_argument("--tiled", action="store_true",
                    help="with --request: tiled 1024x1024 requests, then a tiled denoise step")
    ap.add_argument("--tiles_per_batch", type=int, default=1,
                    help="latent tiles per model call of the tiled request")
    ap.add_argument("--sampler", default="spaced",
                    help="the sampler whose grid the step's hoisted tables hold")
    ap.add_argument("--steps", type=int, default=50, help="the sampler's step count")
    ap.add_argument("--no-hoist", dest="hoist", action="store_false",
                    help="the denoise step without the hoisted tables")
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the profiled steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    if args.request:
        size = TILED_SIZE if args.tiled else 8 * LATENT
        print(f"[profile] {torch.cuda.get_device_name(0)}; SwinIR + ControlLDM sd21 bf16 "
              f"requests at {size}x{size}"
              + (f", tiled, {args.tiles_per_batch} latent tiles a call" if args.tiled else ""))
        time_requests(SEED, device, args.sampler, args.steps,
                      tiles_per_batch=args.tiles_per_batch if args.tiled else None)
        if not args.tiled:
            return 0
        step, blend_step = build_tiled_step(SEED, device, args.sampler, args.steps,
                                            args.tiles_per_batch)
        print(f"[profile] the tiled denoise step: 9 latent tiles of 64x64 over "
              f"{TILED_SIZE // 8}x{TILED_SIZE // 8}, {args.tiles_per_batch} a model call "
              f"(batch {2 * args.tiles_per_batch}, CFG {CFG} folded), not hoisted")
        through_the_kernels(step, "tiled steps", args.trace)
        p = profile_steps(blend_step, PROFILED_STEPS, None)
        print(f"[profile] the same step's tiling alone (an identity model function): device "
              f"busy {p['busy_ms_per_step']:.3f} ms per step in {p['kernels_per_step']:.0f} "
              f"device kernels")
        return 0
    step_kw = dict(sampler=args.sampler, steps=args.steps, hoist=args.hoist)
    grid = f"{args.sampler} x {args.steps} grid, {'hoisted' if args.hoist else 'not hoisted'}"
    if args.caption is not None:
        step = build_decode_step(SEED, device, args.caption)
        print(f"[profile] {torch.cuda.get_device_name(0)}; LLaVA-1.5-7B decode step at "
              f"{args.caption} bits after a {CAPTION_ROWS}-row prefill")
        return through_the_kernels(step, "decode steps", args.trace)
    if args.mode != "default":
        _, step = build_step(SEED, device, args.mode, **step_kw)
        print(f"[profile] {torch.cuda.get_device_name(0)}; ControlLDM sd21 bf16 in the "
              f"\"{args.mode}\" mode, batch 2 (CFG {CFG} folded), {LATENT}x{LATENT} latent, "
              f"{grid}")
        return through_the_kernels(step, "steps", args.trace)
    if args.train:
        cldm, step = build_train_step(SEED, device)
        timed = TIMED_TRAIN_STEPS
        what = (f"stage-2 train step, batch {TRAIN_BATCH} at {8 * LATENT}x{8 * LATENT}, "
                "checkpointing")
    else:
        cldm, step = build_step(SEED, device, **step_kw)
        timed = TIMED_STEPS
        what = f"batch 2 (CFG {CFG} folded), {LATENT}x{LATENT} latent, {grid}"
    print(f"[profile] {torch.cuda.get_device_name(0)}; ControlLDM sd21 bf16, {what}")
    for impl in ("plain", "auto", "auto", "plain"):
        cldm.set_attention_impl(impl)
        r = time_steps(step, timed)
        name = "kernels" if impl == "auto" else "plain"
        print(f"[step] attention {name}: median of {timed} steps: enqueue "
              f"{r['enqueue_ms']:.2f} ms, wall {r['wall_ms']:.2f} ms, "
              f"device span {r['device_ms']:.2f} ms")
    cldm.set_attention_impl("auto")
    report(profile_steps(step, PROFILED_STEPS, args.trace))
    return 0


def through_the_kernels(step, what: str, trace: str | None) -> int:
    """Time and profile a step that has no plain-attention twin."""
    r = time_steps(step, TIMED_STEPS)
    print(f"[step] median of {TIMED_STEPS} {what}: enqueue {r['enqueue_ms']:.2f} ms, "
          f"wall {r['wall_ms']:.2f} ms, device span {r['device_ms']:.2f} ms")
    report(profile_steps(step, PROFILED_STEPS, trace))
    return 0


def report(p: dict) -> None:
    print(p["table"])
    ours = ", ".join(
        f"{k} {ms:.2f} ms in {p['launches_per_step'][k]:.0f} launches "
        f"({ms / p['busy_ms_per_step']:.1%} of busy)" for k, ms in p["ms_per_step"].items()
        if p["launches_per_step"][k])
    print(f"[profile] {p['steps']} steps through the kernels: device busy "
          f"{p['busy_ms_per_step']:.2f} ms per step, {p['kernels_per_step']:.0f} device "
          f"kernels per step, {p['copies_per_step']:.0f} aten::copy_ per step; per step "
          f"{ours or 'none of the port kernels'}; busy share of the {p['window_ms']:.2f} ms "
          f"window {p['busy_share']:.3f}")


if __name__ == "__main__":
    raise SystemExit(main())
