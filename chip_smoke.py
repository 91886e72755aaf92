#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  0. device: the card's name and power limit; TF32 off for fp32 matmuls and
     convolutions, so fp32 comparisons are exact-math comparisons.
  1. build the flash-attention kernel (K1) from diffbir_tpu_torch/csrc.
  2. kernel: K1 against its plain PyTorch version on the card at the shapes
     the main path gives it, with median times of both.
  3. model call: one full-width SD2.1 ControlLDM forward (random bf16 weights)
     at batch 2 on a 64x64 latent, through K1 and through plain attention.
  4. slice: SwinIRPipeline.run on 512x512 uint8 LQs, 50 spaced steps, CFG 4.0,
     the v2.1 schedule, distinct seeds, then one seed again; K1's launch count
     per request, latency, stage split and peak memory.
The second-to-last line is a JSON list of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

STEPS, CFG, SIZE = 50, 4.0, 512
SEEDS = (1, 2, 3)
BF16_TOL, FP32_TOL, MODEL_REL_TOL = 2e-2, 1e-4, 5e-2
# self-attention sites per denoise step: UNet 6 in + 1 mid + 9 out,
# ControlNet 6 in + 1 mid, each called once at batch 2 under folded CFG;
# plus the VAE mid-block attention in the encode and in the decode
K1_SITES_PER_STEP, K1_VAE_SITES = 23, 2
K1_PER_REQUEST = K1_SITES_PER_STEP * STEPS + K1_VAE_SITES


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        print(line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] torch", torch.__version__, "cuda", torch.version.cuda,
          "| TF32 off for fp32 matmuls and cuDNN convolutions")


def phase_build(fa):
    t0 = time.perf_counter()
    fa.KERNEL.load()
    print(f"[build] flash_attention_fwd.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in fa.KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("[build]", line.strip())


def phase_kernel(fa):
    """K1 against its plain version; returns (max bf16 err, ms, plain_ms at
    the largest UNet shape)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [((2, 4096, 5, 64), torch.bfloat16), ((2, 1024, 10, 64), torch.bfloat16),
             ((2, 256, 20, 64), torch.bfloat16), ((2, 64, 20, 64), torch.bfloat16),
             ((1, 4096, 1, 512), torch.bfloat16), ((2, 4000, 5, 64), torch.bfloat16),
             ((1, 1000, 1, 512), torch.bfloat16), ((2, 1024, 10, 64), torch.float32),
             ("strided", torch.bfloat16)]
    max_err, headline = 0.0, None
    for shape, dtype in cases:
        if shape == "strided":  # q, k, v as views of one [2, 4096, 3*320] projection
            qkv = torch.randn(2, 4096, 960, generator=gen, device="cuda").to(dtype)
            q, k, v = (t.reshape(2, 4096, 5, 64) for t in qkv.chunk(3, dim=-1))
        else:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_ref(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        ms = median_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = median_ms(lambda: fa.flash_attention_ref(q, k, v))
        label = "x".join(map(str, q.shape)) + (" strided" if shape == "strided" else "")
        print(f"[kernel] {label} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {tol:g}) "
              f"K1 {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(err <= tol, f"K1 disagrees with its plain version at {label}: {err}")
        if dtype == torch.bfloat16:
            max_err = max(max_err, err)
        if shape == (2, 4096, 5, 64):
            headline = (ms, plain_ms)
    return max_err, headline


def build_models():
    import torch

    from diffbir_tpu_torch.models.cldm import ControlLDM
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.swinir import SwinIR

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(cldm, gen).eval()
    swinir = SwinIR(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(swinir, gen).eval()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in cldm.parameters())
    ns = sum(p.numel() for p in swinir.parameters())
    print(f"[models] sd21 ControlLDM {n / 1e6:.1f} M params, SwinIR {ns / 1e6:.2f} M, "
          f"bf16, random from seed 0, built in {time.perf_counter() - t0:.2f} s")
    return cldm, swinir


def phase_model_call(fa, cldm):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    c_img = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    tokens = torch.zeros(2, 77, dtype=torch.long, device="cuda")
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    t = torch.tensor([999.0, 500.0], device="cuda")
    outs = {}
    with torch.no_grad():
        cond = {"c_txt": cldm.encode_text(tokens), "c_img": c_img}
        for impl in ("auto", "plain"):
            cldm.set_attention_impl(impl)
            before = fa.KERNEL.launches
            outs[impl] = cldm(x, t, cond).float()
            torch.cuda.synchronize()
            print(f"[model] attention {impl}: {fa.KERNEL.launches - before} K1 launches")
    cldm.set_attention_impl("auto")
    a, p = outs["auto"], outs["plain"]
    check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all()),
          "non-finite model output")
    rel = ((a - p).abs().max() / p.abs().max()).item()
    print(f"[model] ControlLDM forward [2,64,64,4]: K1 vs plain attention relative "
          f"max err {rel:.3e} (tol {MODEL_REL_TOL:g}), output max |x| {p.abs().max().item():.3f}")
    check(rel <= MODEL_REL_TOL, f"model call through K1 disagrees: {rel}")


def phase_slice(fa, cldm, swinir):
    import numpy as np
    import torch

    from diffbir_tpu_torch.pipeline import SwinIRPipeline
    from diffbir_tpu_torch.schedule import Schedule

    pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), torch.device("cuda"))
    lqs = {s: np.random.default_rng(100 + s).integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
           for s in SEEDS}
    outs, lat = {}, []
    torch.cuda.reset_peak_memory_stats()
    fa.KERNEL.launches = 0  # count only the main path from here
    for seed in SEEDS + SEEDS[:1]:
        timings = {}
        before = fa.KERNEL.launches
        t0 = time.perf_counter()
        out = pipe.run(lqs[seed], steps=STEPS, cfg_scale=CFG, seed=seed, timings=timings)
        dt = time.perf_counter() - t0
        n = fa.KERNEL.launches - before
        split = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        print(f"[slice] seed {seed}: {dt:.3f} s ({split} s); K1 launches {n}")
        check(n == K1_PER_REQUEST, f"expected {K1_PER_REQUEST} K1 launches, got {n}")
        check(out.shape == (1, SIZE, SIZE, 3) and out.dtype == np.uint8,
              f"bad output {out.shape} {out.dtype}")
        check(float(out.std()) > 1.0, f"constant output for seed {seed}")
        if seed in outs:
            check(np.array_equal(out, outs[seed]), "repeated seed gave a different output")
            print(f"[slice] seed {seed} again: identical output")
        else:
            outs[seed] = out
            lat.append(dt)
    launches = fa.KERNEL.launches
    check(not np.array_equal(outs[SEEDS[0]], outs[SEEDS[1]]), "distinct seeds gave one output")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[slice] per-request latency {', '.join(f'{x:.3f}' for x in lat)} s "
          f"(median {statistics.median(lat):.3f} s); peak device memory {peak:.2f} GiB")
    return launches


def main() -> int:
    # one card: the first, unless the caller chose which ones are visible
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        from diffbir_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        phase_device()
        phase_build(fa)
        max_err, (ms, plain_ms) = phase_kernel(fa)
        cldm, swinir = build_models()
        phase_model_call(fa, cldm)
        launches = phase_slice(fa, cldm, swinir)
    except (SmokeFailure, RuntimeError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "diffbir_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "diffbir_tpu/ops/flash_attention.py:81",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
