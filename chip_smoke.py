#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check them.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  0. device: the card's name and power limit; TF32 off for fp32 matmuls and
     convolutions, so fp32 comparisons are exact-math comparisons.
  1. build every kernel from diffbir_tpu_torch/csrc, one nvcc per source, all
     started together: K1/K3 (flash forward, plain and prescaled-q entry),
     K2a/K2b (flash backward), K4 (int8 matmul), K5 (packed-int4 matmul), K6
     (fused ResBlock), K7 (fused GEGLU FFN).
  2. K1 against its plain PyTorch version at the serving shapes, at the
     training path's frozen VAE encodes ([8,4096,1,512]) and at the
     captioner's vision tower ([1,577,16,64]), with median times of both and
     of the library call.
  3. K1 with its logsumexp, K2a (dq) and K2b (dk, dv) against their plain
     versions at the training shapes (batch 8), a ragged, a strided and an
     fp32 case and d = 128/256/512; the backward run twice must give
     bit-identical gradients; a kernel that skips a kv tile must fail the
     limits (their power); median times of kernel, plain version and the
     library call (scaled_dot_product_attention forward, and its backward
     through autograd), beside the bound.
  4. the serving modes' and the captioner's kernels at their paths' shapes,
     each against its plain version, each with a planted fault that must
     fail the limits, and with median times of kernel, plain version and a
     library yardstick beside the bound: K3 at the 4 self-attention shapes
     of the 512x512 path (batch 2; fault: q scaled twice), K4 at its 18
     dense shapes and at the int8 captioner's 6 (fault: the last 16-deep K
     slice dropped), K5 (packed-int4 matmul) at the LLaVA-1.5-7B prefill
     (M = 624) and decode (M = 1) shapes of the 7 big linears, a ragged and
     an fp32 case (fault: the two scale groups of every window swapped), K6
     float and int8 at the 14 ResBlock sites (fault: the last tap of conv2
     skipped), K7 at the 4 FFN shapes (fault: the last K slice of its first
     product dropped).
  5. model call: one full-width SD2.1 ControlLDM forward (random bf16 weights)
     at batch 2 on a 64x64 latent, through K1 and through plain attention.
  6. serving path: SwinIRPipeline.run on 512x512 uint8 LQs, 50 spaced steps,
     CFG 4.0, the v2.1 schedule, distinct seeds, then one seed again; K1's
     launch count per request, latency, stage split and peak memory.
  7. the serving modes: one full-width model call in the "fused" mode
     (fused ResBlock + fused FFN + packed flash: K6, K7, K3) against the
     unfused float path on the same weights, then SwinIRPipeline.run on 512x512
     LQs in that mode; then a copy of the model with its UNet and ControlNet
     quantised ("int8": int8 dense + fused ResBlock on int8 convs + packed:
     K4, K6, K3), one model call against the unfused path on the dequantised
     weights, and requests in that mode. Each model call records every
     kernel call's shape and checks it against the site tables below; each
     request checks its launch counts, latency, stage split and peak memory.
  8. the LLaVA-1.5-7B captioner at full width (CLIP ViT-L/14-336 +
     projector + Llama-7B, random bf16 weights from seed 0 generated on the
     card), a seeded 512x512
     LQ, a 624-row prompt of stand-in ids, 60 greedy tokens with an EOS that
     never matches, in the modes int4 (K5), int8 (K4) and bf16: exact launch
     counts, stage times, tokens/s and peak memory per mode; for int4 and
     int8, teacher forcing of the generated ids through the same model on
     the plain products (logits within a relative limit, ids equal to the
     plain argmax wherever its top-2 margin exceeds it). Then one captioned
     request: the int4 caption of the LQ, then SwinIRPipeline.run on it.
  9. training path: stage-2 IRControlNet train steps at full width (SD2.1 +
     IRControlNet with gradient checkpointing, ControlNet initialised from the
     UNet, frozen realesrgan SwinIR cleaner, v2.1 schedule, noise aug at 200,
     lr 1e-5), batch 8 at 512x512 from seeded numpy, empty prompts: 2 warm-up
     and 5 timed steps; finite losses, only the ControlNet changes, K1/K2a/K2b
     launches per step; then at batch 2 one step's ControlNet gradient through
     K1+K2 against the same through plain attention, and the same with the
     attention sites' q/k/v gradients dropped must fail the limits.
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
# Kernel vs plain version, error limit = TOL * max|ref| (the reference's own
# size, so small gradients get a small limit). bf16: both sides accumulate in
# fp32 and round p, ds and the output to bf16; they differ where the fp32 sums
# fall on either side of a rounding step, by one bf16 ulp of an element, at
# most 2^-7 of the largest one: the limit is two such ulps. fp32 (and the
# logsumexp, fp32 on both sides for either input dtype): the same math with
# sums in another order, ~1e-6 relative.
BF16_TOL, FP32_TOL, MODEL_REL_TOL = 2.0 ** -6, 1e-4, 5e-2
# self-attention sites per denoise step: UNet 6 in + 1 mid + 9 out,
# ControlNet 6 in + 1 mid, each called once at batch 2 under folded CFG;
# plus the VAE mid-block attention in the encode and in the decode
K1_SITES_PER_STEP, K1_VAE_SITES = 23, 2
K1_PER_REQUEST = K1_SITES_PER_STEP * STEPS + K1_VAE_SITES
# Training step: gradients reach the 7 ControlNet sites and the 9 UNet
# output-block sites, not the UNet's 6 input and 1 middle sites (control is
# added after the middle block). K1 runs at all 23 sites in the forward, at
# the VAE's mid-block in the two frozen encodes (gt and the cleaned lq), and
# again at the 16 sites with gradients when checkpointing recomputes them.
K2_SITES_PER_TRAIN_STEP = 7 + 9
K1_PER_TRAIN_STEP = K1_SITES_PER_STEP + 2 + K2_SITES_PER_TRAIN_STEP
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED = 8, 2, 5
# kernel vs plain attention, one step's ControlNet gradient at batch 2 in
# bf16: both paths round every activation and gradient to bf16 and differ
# only where attention rounds (one bf16 ulp of an element, see BF16_TOL).
# Measured on an H100: norms 1.8e-4 apart, 1 - cosine 7e-6; the limits are
# ~10x those. The same step with the attention sites' q/k/v gradients dropped
# must fail them (the check's power is shown in the run).
GRAD_COS_MIN, GRAD_NORM_REL_TOL = 0.9999, 2e-3
# The serving modes, per model call at batch 2 (folded CFG) on a 64x64 latent:
# K6 runs at every ResBlock, 32: the UNet's 8 input, 2 middle and 12 output
# blocks (whose inputs concatenate the skips, hence Cin up to 2560) and the
# ControlNet's 8 + 2, keyed (Cin, Cout, H = W);
K6_SITES = {(320, 320, 64): 4, (960, 320, 64): 1, (640, 320, 64): 2, (320, 640, 32): 2,
            (640, 640, 32): 2, (1920, 640, 32): 1, (1280, 640, 32): 1, (960, 640, 32): 1,
            (640, 1280, 16): 2, (1280, 1280, 16): 2, (2560, 1280, 16): 2,
            (1920, 1280, 16): 1, (1280, 1280, 8): 8, (2560, 1280, 8): 3}
# the 23 transformers (7 at each of the levels 64^2, 32^2, 16^2: UNet 2 input
# + 3 output, ControlNet 2; 2 in the middles at 8^2) hold one FFN (K7, keyed
# tokens per image, width) and one self-attention site (K3, keyed tokens,
# heads of 64) each;
K7_SITES = {(4096, 320): 7, (1024, 640): 7, (256, 1280): 7, (64, 1280): 2}
K3_SITES = {(4096, 5): 7, (1024, 10): 7, (256, 20): 7, (64, 20): 2}
K6_PER_CALL, K7_PER_CALL, K3_PER_CALL = 32, 23, 23
# K4 (int8 dense), keyed (M rows, K, N): per transformer 8 width-square
# products on the 2*tokens rows (proj_in, self q/k/v/out, cross q/out,
# proj_out), the cross k/v on the 2 x 77 text rows, GEGLU proj (N = 8 C) and
# net.2 (K = 4 C); per ResBlock emb_layers.1 on the 2 timestep rows (Cout 320
# at 7 blocks, 640 at 7, 1280 at 18): 23 x 12 + 32 = 308 per call.
K4_PER_CALL = 308


def k4_sites() -> dict:
    sites = {}

    def add(key, n):
        sites[key] = sites.get(key, 0) + n

    for tokens, c, n in ((4096, 320, 7), (1024, 640, 7), (256, 1280, 7), (64, 1280, 2)):
        m = 2 * tokens
        add((m, c, c), 8 * n)
        add((154, 1024, c), 2 * n)
        add((m, c, 8 * c), n)
        add((m, 4 * c, c), n)
    for c, n in ((320, 7), (640, 7), (1280, 18)):
        add((2, 1280, c), n)
    assert sum(sites.values()) == K4_PER_CALL
    return sites


K4_SITES = k4_sites()
# Per request (STEPS model calls, plus K1 at the VAE's two d=512 sites):
# "fused" (fused ResBlock + fused FFN + packed flash) and "int8" (int8 dense
# + fused ResBlock on int8 convs + packed flash).
PER_REQUEST = {
    "serve": {"K1": K1_PER_REQUEST},
    "serve_fused": {"K1": K1_VAE_SITES, "K3": K3_PER_CALL * STEPS, "K6": K6_PER_CALL * STEPS,
                    "K7": K7_PER_CALL * STEPS},
    "serve_int8": {"K1": K1_VAE_SITES, "K3": K3_PER_CALL * STEPS, "K4": K4_PER_CALL * STEPS,
                   "K6": K6_PER_CALL * STEPS},
}
MODE_SEEDS = (1, 2)
# The LLaVA-1.5-7B captioner: 35 prompt ids before the image (BOS first), its
# 576 patch embeddings, 13 ids after (the 624 prefill rows of
# scripts/bench_llava.py), 60 new tokens; the EOS id never matches, so every
# caption runs the prefill and 59 decode steps (the 60th token's step is
# skipped). K5 (int4) or K4 (int8) runs at the 7 big linears of the 32
# layers in each of those 60 passes; K1 at the tower's 23 layers that run.
CAPTION_PRE, CAPTION_POST, CAPTION_NEW, NEVER_EOS = 35, 13, 60, -1
CAPTION_ROWS = CAPTION_PRE + 576 + CAPTION_POST
LLAMA_LAYERS = 32
QUANT_PER_CAPTION = 7 * LLAMA_LAYERS * CAPTION_NEW
K1_PER_CAPTION = 23
CAPTION_PATHS = {
    "caption_int4": {"K1": K1_PER_CAPTION, "K5": QUANT_PER_CAPTION},
    "caption_int8": {"K1": K1_PER_CAPTION, "K4": QUANT_PER_CAPTION},
    "caption_bf16": {"K1": K1_PER_CAPTION},
    "captioned_request": {"K1": K1_PER_CAPTION + K1_PER_REQUEST, "K5": QUANT_PER_CAPTION},
}
# (M, K, N) of the 7 linears per layer and pass: q/k/v/o, gate/up, down;
# M = 624 in the prefill, 1 in each of the 59 decode steps
LLAVA_SITES = {(4096, 4096): 4, (4096, 11008): 2, (11008, 4096): 1}
# the teacher-forced check: the kernel path's logits at the 60 generated
# positions against the plain products' on the same ids, error limit
# CAPTION_REL_TOL x max|plain logits|. Both paths round every activation to
# bf16 and differ in sum order (and decode against prefill), so a
# difference grows through 32 layers: measured 1.85e-2 on an H100 in both
# quantised modes. The float model's logits on the same ids must fail the
# limit against the int4 path's plain products (the check's power).
CAPTION_REL_TOL = 3e-2
# H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor cores, fp32 on the
# CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


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


def bound_ms(products: int, b: int, h: int, sq: int, skv: int, d: int, dtype,
             n_bytes: int):
    """The least time for ``products`` matrix products of 2*Sq*Skv*d flops
    per (batch, head) and ``n_bytes`` moved: (ms, "operations" or "bytes")."""
    flops = products * 2.0 * b * h * sq * skv * d
    t_ops = flops / PEAK_FLOPS[str(dtype)[6:]]
    t_bytes = n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gemm_bound(m: int, k: int, n: int, *tensors):
    """(ms, "operations" or "bytes") of an M x K x N product that reads and
    writes ``tensors`` once, against the bf16 tensor-core peak."""
    t_ops = 2.0 * m * k * n / PEAK_FLOPS["bfloat16"]
    t_bytes = nbytes(*tensors) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def per_caption_ms(times: dict) -> float:
    """Kernel ms per caption from per-shape ms keyed (M, K, N): the prefill
    once and 59 decode steps, 32 layers each."""
    return LLAMA_LAYERS * sum(
        c * (times[(CAPTION_ROWS, k, n)] + (CAPTION_NEW - 1) * times[(1, k, n)])
        for (k, n), c in LLAVA_SITES.items())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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


# name -> CudaKernel of every kernel the port has, filled by main() once the
# port is imported
KERNELS = {}


def phase_build():
    """One nvcc per source, all started together, then every entry point
    loaded (K1/K3 and K2a/K2b share a library each)."""
    from diffbir_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.load_all(list(KERNELS.values()))
    sources = sorted({k.source.name for k in KERNELS.values()})
    print(f"[build] {', '.join(sources)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    seen = set()
    for kernel in KERNELS.values():
        if kernel.source in seen:
            continue
        seen.add(kernel.source)
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {kernel.source.name}:", line.strip())


def sdpa_fwd(q, k, v, scale=None):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), scale=scale)


def limit_of(ref, tol: float) -> float:
    """The error limit against a reference: ``tol`` times its largest |value|."""
    return tol * ref.float().abs().max().item()


def phase_kernel(fa):
    """K1 against its plain version at the serving shapes, at the frozen
    VAE encodes' batch-8 shape of training and at the captioner's vision
    tower ([1,577,16,64]); returns the kernel line's numbers at
    [2,4096,5,64] bf16."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [((2, 4096, 5, 64), torch.bfloat16), ((2, 1024, 10, 64), torch.bfloat16),
             ((2, 256, 20, 64), torch.bfloat16), ((2, 64, 20, 64), torch.bfloat16),
             ((1, 4096, 1, 512), torch.bfloat16), ((8, 4096, 1, 512), torch.bfloat16),
             ((2, 4000, 5, 64), torch.bfloat16), ((1, 577, 16, 64), torch.bfloat16),
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
        limit = limit_of(ref, tol)
        iters = 5 if q.shape[0] * q.shape[1] * q.shape[3] > 2**22 else 20
        ms = median_ms(lambda: fa.flash_attention(q, k, v), iters)
        plain_ms = median_ms(lambda: fa.flash_attention_ref(q, k, v), iters)
        label = "x".join(map(str, q.shape)) + (" strided" if shape == "strided" else "")
        b, sq, h, d = q.shape
        bms, by = bound_ms(2, b, h, sq, sq, d, dtype, nbytes(q, k, v, out))
        lib = ""
        if shape in ((2, 4096, 5, 64), (1, 577, 16, 64)):  # the UNet's, the vision tower's
            lib_ms = median_ms(lambda: sdpa_fwd(q, k, v))
            lib = f", library {lib_ms:.4f} ms"
        if shape == (2, 4096, 5, 64):
            headline = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
        print(f"[kernel] K1 {label} {str(dtype)[6:]}: max_abs_err {err:.3e}, max|ref| "
              f"{ref.float().abs().max().item():.3e}, limit {limit:.3e} ({tol:g} x max|ref|); "
              f"K1 {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound {bms:.4f} ms ({by})")
        check(err <= limit, f"K1 disagrees with its plain version at {label}: {err} > {limit}")
        if dtype == torch.bfloat16:
            max_err = max(max_err, err)
    headline["max_abs_err"] = max_err
    return headline


NAMES = ("o", "lse", "dq", "dk", "dv")


def check_power(fa, q, k, v, g, o, lse, refs, limits):
    """The limits catch a kernel that skips the last 64-row kv tile: K1 and
    K2 run without it (K2 with the full lse, as a kernel that drops the tile
    would) and each of o, lse, dq, dk and dv must then fail its limit."""
    import torch

    kt, vt = k[:, :-64], v[:, :-64]
    o_f, lse_f = fa.flash_attention_fwd(q, kt, vt, with_lse=True)
    dq_f, dk_f, dv_f = fa.flash_attention_bwd(q, kt, vt, o, lse, g)
    pad = torch.zeros_like(k[:, -64:])
    faulty = dict(zip(NAMES, (o_f, lse_f, dq_f, torch.cat([dk_f, pad], 1),
                              torch.cat([dv_f, pad], 1))))
    ratios = {n: (faulty[n].float() - refs[n].float()).abs().max().item() / limits[n]
              for n in NAMES}
    print("[bwd] a kernel that skips the last kv tile: max err / limit " +
          ", ".join(f"{n} {r:.1f}" for n, r in ratios.items()))
    check(all(r > 1.0 for r in ratios.values()),
          f"the limits do not catch a skipped kv tile: {ratios}")


def phase_backward_kernels(fa):
    """K1 with lse, K2a and K2b against their plain versions; returns the
    kernel lines' numbers for K2a and K2b at [8,4096,5,64] bf16."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [((8, 4096, 5, 64), bf), ((8, 1024, 10, 64), bf), ((8, 256, 20, 64), bf),
             ((8, 64, 20, 64), bf), ((2, 4000, 5, 64), bf), ("strided", bf),
             ((2, 300, 4, 128), bf), ((1, 300, 2, 256), bf), ((1, 600, 1, 512), bf),
             ((2, 1024, 10, 64), f32), ((1, 300, 1, 512), f32)]
    max_err = {"dq": 0.0, "dkv": 0.0}
    headline = None
    for shape, dtype in cases:
        if shape == "strided":  # q, k, v views of one projection; dO a strided view too
            qkv = torch.randn(2, 4096, 960, generator=gen, device="cuda").to(dtype)
            q, k, v = (t.reshape(2, 4096, 5, 64) for t in qkv.chunk(3, dim=-1))
            g = torch.randn(2, 4096, 5, 128, generator=gen, device="cuda").to(dtype)[..., :64]
        else:
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                          for _ in range(4))
        b, sq, h, d = q.shape
        label = "x".join(map(str, q.shape)) + (" strided" if shape == "strided" else "")
        tol = BF16_TOL if dtype == bf else FP32_TOL

        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, g)
        again = fa.flash_attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        check(all(torch.equal(a, c) for a, c in zip(grads, again)),
              f"K2 is not bit-deterministic at {label}")
        refs = dict(zip(NAMES, (o_ref, lse_ref, *fa.flash_attention_bwd_ref(q, k, v, o, lse, g))))
        limits = {n: limit_of(r, FP32_TOL if n == "lse" else tol) for n, r in refs.items()}
        errs = {}
        for name, out in zip(NAMES, (o, lse, *grads)):
            errs[name] = (out.float() - refs[name].float()).abs().max().item()
            check(errs[name] <= limits[name], f"{name} disagrees with its plain version at "
                  f"{label}: {errs[name]} > {limits[name]}")
        if shape == (8, 4096, 5, 64):
            check_power(fa, q, k, v, g, o, lse, refs, limits)
        if dtype == bf:
            max_err["dq"] = max(max_err["dq"], errs["dq"])
            max_err["dkv"] = max(max_err["dkv"], errs["dk"], errs["dv"])

        big = sq >= 4000
        iters = 5 if big else 20
        t = {
            "K1+lse": median_ms(lambda: fa.flash_attention_fwd(q, k, v, with_lse=True), iters),
            "K2a": median_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, g),
                             iters),
            "K2b": median_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, o, lse, g),
                             iters),
            "plain K2a": median_ms(lambda: fa.flash_attention_bwd_dq_ref(q, k, v, o, lse, g),
                                   iters),
            "plain K2b": median_ms(lambda: fa.flash_attention_bwd_dkv_ref(q, k, v, o, lse, g),
                                   iters),
        }
        lib_ms = None
        if shape in ((8, 4096, 5, 64), (8, 1024, 10, 64)):
            qt, kt, vt = (x.detach().clone().requires_grad_() for x in (q, k, v))
            out_lib = sdpa_fwd(qt, kt, vt)
            g_lib = g.transpose(1, 2)
            lib_ms = median_ms(lambda: torch.autograd.grad(out_lib, (qt, kt, vt), g_lib,
                                                           retain_graph=True), iters)
            t["library bwd"] = lib_ms
        in_bytes = nbytes(q, k, v, o, g, lse)
        b_dq = bound_ms(3, b, h, sq, sq, d, dtype, in_bytes + nbytes(grads[0]))
        b_dkv = bound_ms(4, b, h, sq, sq, d, dtype, in_bytes + nbytes(*grads[1:]))
        b_all = bound_ms(5, b, h, sq, sq, d, dtype, in_bytes + nbytes(*grads))
        print(f"[bwd] {label} {str(dtype)[6:]}: max err / limit " +
              ", ".join(f"{n} {e:.3e} / {limits[n]:.3e}" for n, e in errs.items()) +
              f" (limit {tol:g} x max|ref|, lse {FP32_TOL:g} x max|ref|); "
              "backward bit-identical on a second run")
        print(f"[bwd] {label} {str(dtype)[6:]}: ms " +
              ", ".join(f"{n} {x:.4f}" for n, x in t.items()) +
              f"; bound K2a {b_dq[0]:.4f} ({b_dq[1]}, 3 products), K2b {b_dkv[0]:.4f} "
              f"({b_dkv[1]}, 4 products), whole backward {b_all[0]:.4f} ({b_all[1]}, 5 products)")
        if shape == (8, 4096, 5, 64):
            headline = {
                "dq": {"ms": t["K2a"], "plain_ms": t["plain K2a"], "bound_ms": b_dq[0],
                       "bound_by": b_dq[1], "library_ms": lib_ms},
                "dkv": {"ms": t["K2b"], "plain_ms": t["plain K2b"], "bound_ms": b_dkv[0],
                        "bound_by": b_dkv[1], "library_ms": lib_ms},
            }
        del q, k, v, g, o, lse, grads, again, refs
        torch.cuda.empty_cache()
    headline["dq"]["max_abs_err"] = max_err["dq"]
    headline["dkv"]["max_abs_err"] = max_err["dkv"]
    return headline


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
          f"bf16, random from seed 0, built in "
          f"{time.perf_counter() - t0:.2f} s")
    return cldm, swinir


def empty_tokens(bs: int):
    import torch

    tokens = torch.zeros(bs, 77, dtype=torch.long, device="cuda")
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    return tokens


def phase_model_call(fa, cldm):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    c_img = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    t = torch.tensor([999.0, 500.0], device="cuda")
    outs = {}
    with torch.no_grad():
        cond = {"c_txt": cldm.encode_text(empty_tokens(2)), "c_img": c_img}
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


def reset_counts():
    for kernel in KERNELS.values():
        kernel.launches = 0


def counts() -> dict:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def launched_since(before: dict) -> dict:
    """Launches per kernel since ``before`` (kernels with none left out)."""
    now = counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def phase_slice(path: str, cldm, swinir, seeds, repeat: bool = True):
    """The serving path in one mode: SwinIRPipeline.run on SIZE x SIZE LQs,
    one request per seed (and the first seed again with ``repeat``); every
    request must launch exactly PER_REQUEST[path]. Returns the launch counts
    of the path's run."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.pipeline import SwinIRPipeline
    from diffbir_tpu_torch.schedule import Schedule

    pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), torch.device("cuda"))
    lqs = {s: np.random.default_rng(100 + s).integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
           for s in seeds}
    expected = PER_REQUEST[path]
    outs, lat = {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count only this path from here
    for seed in tuple(seeds) + (seeds[:1] if repeat else ()):
        timings = {}
        before = counts()
        t0 = time.perf_counter()
        out = pipe.run(lqs[seed], steps=STEPS, cfg_scale=CFG, seed=seed, timings=timings)
        dt = time.perf_counter() - t0
        n = launched_since(before)
        split = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        print(f"[{path}] seed {seed}: {dt:.3f} s ({split} s); launches "
              + ", ".join(f"{k} {v}" for k, v in n.items()))
        check(n == expected, f"{path}: expected launches {expected} per request, got {n}")
        check(out.shape == (1, SIZE, SIZE, 3) and out.dtype == np.uint8,
              f"bad output {out.shape} {out.dtype}")
        check(float(out.std()) > 1.0, f"constant output for seed {seed}")
        if seed in outs:
            check(np.array_equal(out, outs[seed]), "repeated seed gave a different output")
            print(f"[{path}] seed {seed} again: identical output")
        else:
            outs[seed] = out
            lat.append(dt)
    launches = counts()
    if len(seeds) > 1:
        check(not np.array_equal(outs[seeds[0]], outs[seeds[1]]), "distinct seeds gave one output")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{path}] per-request latency {', '.join(f'{x:.3f}' for x in lat)} s "
          f"(median {statistics.median(lat):.3f} s); peak device memory {peak:.2f} GiB")
    return launches


# --------------------------------------------------------------------------- #
# the serving modes' kernels: K3, K4, K6, K7
# --------------------------------------------------------------------------- #
def err_limit(out, ref, tol: float):
    """(max abs error of out against ref, the limit tol * max|ref|)."""
    return (out.float() - ref.float()).abs().max().item(), limit_of(ref, tol)


def show(out, ref, tol: float = BF16_TOL) -> str:
    err, limit = err_limit(out, ref, tol)
    return f"max_abs_err {err:.3e}, limit {limit:.3e} ({tol:g} x max|ref|)"


def hold(label: str, out, ref, tol: float) -> float:
    err, limit = err_limit(out, ref, tol)
    check(err <= limit, f"{label} disagrees with its plain version: {err} > {limit}")
    return err


def planted(label: str, faulty, ref, tol: float) -> None:
    """A planted fault must fail the limit the kernel is held to."""
    err, limit = err_limit(faulty, ref, tol)
    print(f"[{label.split()[0]}] planted fault ({label}): max err / limit {err / limit:.1f}")
    check(err > limit, f"the limits do not catch {label}: {err} <= {limit}")


def randomize_(module, gen):
    """random_init_ (N(0, 1/fan_in) weights), then biases N(0, 0.1^2) and
    norm scales 1 + N(0, 0.1^2), so every term of the block carries signal."""
    import torch

    from diffbir_tpu_torch.models.layers import random_init_

    random_init_(module, gen)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                noise = 0.1 * torch.randn(p.shape, generator=gen, device=gen.device)
                p.copy_(noise + 1.0 if name.endswith("weight") else noise)
    return module.eval()


def k3_scaled_twice(fa, q, k, v):
    """K3 with its fault planted: q rounded as bf16(q * d^-1/2) and the
    logits scaled by d^-1/2 again."""
    import torch

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        fa.KERNEL_PRESCALED.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   None, 1, b, h, sq, k.shape[1], d, *fa._strides(q, k, v),
                                   d ** -0.5, d ** -0.5, torch.cuda.current_stream().cuda_stream)
    return out


def phase_k3(fa):
    """K3 against its plain version at the four self-attention shapes of the
    serving path (bf16); returns the kernel line's numbers at
    [2,4096,5,64]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err, headline, per_call = 0.0, None, 0.0
    for (tokens, heads), sites in K3_SITES.items():
        q, k, v = (torch.randn(2, tokens, heads, 64, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out = fa.flash_attention_fwd(q, k, v, prescale_q=True)
        ref = fa.flash_attention_ref(q, k, v, prescale_q=True)
        label = f"2x{tokens}x{heads}x64"
        max_err = max(max_err, hold(f"K3 at {label}", out, ref, BF16_TOL))
        iters = 5 if tokens >= 4096 else 20
        ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v, prescale_q=True), iters)
        plain_ms = median_ms(lambda: fa.flash_attention_ref(q, k, v, prescale_q=True), iters)
        lib_ms = median_ms(lambda: sdpa_fwd(q, k, v, scale=64 ** -0.5), iters)
        bms, by = bound_ms(2, 2, heads, tokens, tokens, 64, torch.bfloat16, nbytes(q, k, v, out))
        per_call += sites * ms
        print(f"[K3] {label} bf16 ({sites} sites per call): "
              f"{show(out, ref)}; K3 "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA, same scale) "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if tokens == 4096:
            planted("K3 scaling q twice", k3_scaled_twice(fa, q, k, v), ref, BF16_TOL)
            headline = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": lib_ms}
        del q, k, v, out, ref
    print(f"[K3] per model call ({K3_PER_CALL} sites): {per_call:.3f} ms")
    headline["max_abs_err"] = max_err
    return headline


def phase_k4(qm):
    """K4 against its plain version at the 18 dense shapes of the int8 path
    and the 6 of the int8 captioner (bf16 activations); returns the kernel
    line's numbers at the GEGLU projection of the 64^2 level,
    (8192, 320, 2560)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    max_err, headline, per_call, caption = 0.0, None, 0.0, {}
    cases = [(shape, f"{sites} per call") for shape, sites in K4_SITES.items()]
    cases += [((m, k, n), "captioner") for m in (CAPTION_ROWS, 1) for k, n in LLAVA_SITES]
    for (m, k, n), where in cases:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        w_q, scale = qm.quantize_weight(w.to(torch.bfloat16))
        w_deq = (w_q.float() * scale).to(torch.bfloat16)
        out = qm.quant_matmul(x, w_q, scale)
        ref = qm.quant_matmul_ref(x, w_q, scale)
        label = f"({m}, {k}, {n})"
        max_err = max(max_err, hold(f"K4 at {label}", out, ref, BF16_TOL))
        iters = 10 if m * k * n > 2 ** 32 else 20
        ms = median_ms(lambda: qm.quant_matmul(x, w_q, scale), iters)
        plain_ms = median_ms(lambda: qm.quant_matmul_ref(x, w_q, scale), iters)
        lib_ms = median_ms(lambda: x @ w_deq, iters)
        bms, by = gemm_bound(m, k, n, x, w_q, scale, out)
        if where == "captioner":
            caption[(m, k, n)] = ms
        else:
            per_call += K4_SITES[(m, k, n)] * ms
        print(f"[K4] (M, K, N) {label} ({where}): "
              f"{show(out, ref)}; K4 "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (x @ dequantised bf16 W) "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if (m, k, n) == (8192, 320, 2560):
            planted("K4 dropping the last K slice",
                    qm.quant_matmul(x[:, :-16].contiguous(), w_q[:-16].contiguous(), scale),
                    ref, BF16_TOL)
            headline = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": lib_ms}
        del x, w, w_q, scale, w_deq, out, ref
    print(f"[K4] per model call ({K4_PER_CALL} sites): {per_call:.3f} ms; per int8 caption "
          f"({QUANT_PER_CAPTION} launches): {per_caption_ms(caption):.3f} ms")
    headline["max_abs_err"] = max_err
    return headline


def int8_params(fr, p: dict) -> dict:
    """The int8 twin of a float K6 parameter dict (OIHW -> HWIO, quantised)."""
    q = {k: v for k, v in p.items() if not k.startswith("w")}
    for name, scale in (("w1", "s1"), ("w2", "s2"), ("w_skip", "s_skip")):
        if name in p:
            q[name + "_q"], q[scale] = fr.quantize_conv_weight(p[name].permute(2, 3, 1, 0))
    return q


def without_last_tap(p: dict) -> dict:
    """conv2 without its last tap (ky = kx = 2), in either weight mode."""
    p = dict(p)
    if "w2_q" in p:
        p["w2_q"] = p["w2_q"].clone()
        p["w2_q"][2, 2] = 0
    else:
        p["w2"] = p["w2"].clone()
        p["w2"][:, :, 2, 2] = 0
    return p


def phase_k6(fr):
    """K6, float and int8 weights, against its plain version at the 14
    ResBlock sites of the serving path (bf16, batch 2); the library
    yardstick is the unfused ResBlock module (GroupNorm, SiLU and cuDNN
    convolutions: several library calls). Returns the kernel line's numbers
    at (320, 320, 64^2) in float mode."""
    import torch

    from diffbir_tpu_torch.models.unet import ResBlock

    gen = torch.Generator(device="cuda").manual_seed(4)
    max_err, headline = 0.0, None
    per_call = {"float": 0.0, "int8": 0.0}
    for (cin, cout, hw), sites in K6_SITES.items():
        block = randomize_(ResBlock(cin, cout, 1280, torch.bfloat16, device="cuda"), gen)
        x = torch.randn(2, cin, hw, hw, generator=gen, device="cuda").to(torch.bfloat16)
        emb = torch.randn(2, 1280, generator=gen, device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            e = block.emb_layers(emb)
            p = block.fused_params()
            lib_ms = median_ms(lambda: block(x, emb), 10)
        params = {"float": p, "int8": int8_params(fr, p)}
        label = f"({cin}, {cout}, {hw}^2)"
        flops = 2.0 * 2 * hw * hw * cout * (9 * cin + 9 * cout + (cin if cin != cout else 0))
        t_ops = flops / PEAK_FLOPS["bfloat16"]
        for mode, pm in params.items():
            out = fr.fused_resblock(x, e, pm)
            ref = fr.fused_resblock_ref(x, e, pm)
            max_err = max(max_err, hold(f"K6 {mode} at {label}", out, ref, BF16_TOL))
            ms = median_ms(lambda: fr.fused_resblock(x, e, pm), 10)
            plain_ms = median_ms(lambda: fr.fused_resblock_ref(x, e, pm), 10)
            t_bytes = nbytes(x, e, out, *pm.values()) / PEAK_BYTES
            bms, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
            per_call[mode] += sites * ms
            print(f"[K6] {mode} {label} ({sites} per call): "
                  f"{show(out, ref)}; "
                  f"K6 {ms:.4f} ms, plain {plain_ms:.4f} ms, library (unfused ResBlock module, "
                  f"several calls) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
            if (cin, cout, hw) == (320, 320, 64):
                planted(f"K6 {mode} skipping the last tap of conv2",
                        fr.fused_resblock(x, e, without_last_tap(pm)), ref, BF16_TOL)
                if mode == "float":
                    headline = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                                "bound_by": by, "library_ms": lib_ms}
        del block, x, params, p
    print(f"[K6] per model call ({K6_PER_CALL} ResBlocks): float {per_call['float']:.3f} ms, "
          f"int8 {per_call['int8']:.3f} ms")
    headline["max_abs_err"] = max_err
    return headline


def phase_k7(ff):
    """K7 against its plain version at the four FFN shapes of the serving
    path (bf16, batch 2); the library yardstick is the unfused FeedForward
    module. Returns the kernel line's numbers at (8192 rows, d = 320)."""
    import torch

    from diffbir_tpu_torch.models.unet import FeedForward

    gen = torch.Generator(device="cuda").manual_seed(5)
    max_err, headline, per_call = 0.0, None, 0.0
    for (tokens, d), sites in K7_SITES.items():
        ffm = randomize_(FeedForward(d, torch.bfloat16, device="cuda"), gen)
        x = torch.randn(2 * tokens, d, generator=gen, device="cuda").to(torch.bfloat16)
        proj, down = ffm.net[0].proj, ffm.net[2]
        args = (x, proj.weight, proj.bias, down.weight, down.bias)
        with torch.no_grad():
            out = ff.fused_ffn(*args)
            ref = ff.fused_ffn_ref(*args)
            label = f"({2 * tokens}, {d})"
            max_err = max(max_err, hold(f"K7 at {label}", out, ref, BF16_TOL))
            ms = median_ms(lambda: ff.fused_ffn(*args), 10)
            plain_ms = median_ms(lambda: ff.fused_ffn_ref(*args), 10)
            lib_ms = median_ms(lambda: ffm(x), 10)
        n, inner = 2 * tokens, 4 * d
        t_ops = 6.0 * n * d * inner / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes(out, *args) / PEAK_BYTES
        bms, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        per_call += sites * ms
        print(f"[K7] (rows, d) {label} ({sites} per call): "
              f"{show(out, ref)}; K7 "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (unfused FeedForward module) "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if d == 320:  # the last 16 columns of x and of W1 zero: that slice's products drop
            x_f, w1_f = x.clone(), proj.weight.clone()
            x_f[:, -16:], w1_f[:, -16:] = 0, 0
            with torch.no_grad():
                faulty = ff.fused_ffn(x_f, w1_f, proj.bias, down.weight, down.bias)
            planted("K7 dropping the last K slice of its first product", faulty, ref, BF16_TOL)
            headline = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": lib_ms}
    print(f"[K7] per model call ({K7_PER_CALL} FFNs): {per_call:.3f} ms")
    headline["max_abs_err"] = max_err
    return headline


# --------------------------------------------------------------------------- #
# the serving modes end to end
# --------------------------------------------------------------------------- #
def record_sites(cldm):
    """Forward hooks on the UNet and ControlNet that record the shape of each
    K3, K4, K6 and K7 call of a model call, keyed as the site tables; returns
    (records, the hooks' handles)."""
    from collections import Counter

    from diffbir_tpu_torch.models.layers import QuantLinear
    from diffbir_tpu_torch.models.unet import CrossAttention, FeedForward, ResBlock

    rec = {name: Counter() for name in ("K3", "K4", "K6", "K7")}

    def hook(name, key):
        return lambda mod, inp, out: rec[name].update([key(mod, inp, out)])

    handles = []
    for root in (cldm.unet, cldm.controlnet):
        for m in root.modules():
            if isinstance(m, ResBlock) and m.fused:
                handles.append(m.register_forward_hook(hook(
                    "K6", lambda m, i, o: (i[0].shape[1], o.shape[1], i[0].shape[2]))))
            elif isinstance(m, FeedForward) and m.fused:
                handles.append(m.register_forward_hook(hook(
                    "K7", lambda m, i, o: tuple(i[0].shape[1:]))))
            elif isinstance(m, CrossAttention) and m.flash_layout == "packed":
                handles.append(m.register_forward_hook(hook(  # self-attention: no context
                    "K3", lambda m, i, o: (i[0].shape[1], m.heads) if len(i) == 1 else None)))
            elif isinstance(m, QuantLinear):
                handles.append(m.register_forward_hook(hook(
                    "K4", lambda m, i, o: (i[0].numel() // i[0].shape[-1], *m.weight_q.shape))))
    return rec, handles


def mode_call(label: str, model, inputs, ref, expected: dict, tables: dict):
    """One model call of ``model`` in a serving mode on ``inputs`` (x, t,
    cond): its launches, the shape of every kernel call against the site
    tables, and its output against ``ref`` (the unfused float path)."""
    import torch

    x, t, cond = inputs
    rec, handles = record_sites(model)
    try:
        with torch.no_grad():
            before = counts()
            out = model(x, t, cond).float()
            torch.cuda.synchronize()
            n = launched_since(before)
    finally:
        for h in handles:
            h.remove()
    rec = {k: {site: c for site, c in v.items() if site is not None} for k, v in rec.items()}
    print(f"[{label}] model call launches " + ", ".join(f"{k} {v}" for k, v in n.items()))
    check(n == expected, f"{label}: expected launches {expected} per model call, got {n}")
    for name, table in tables.items():
        check(rec[name] == table, f"{label}: {name} sites {rec[name]} != the table {table}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite model output")
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    print(f"[{label}] ControlLDM forward [2,64,64,4]: against the unfused float path, "
          f"relative max err {rel:.3e} (tol {MODEL_REL_TOL:g}); every kernel call at a site "
          f"of the tables")
    check(rel <= MODEL_REL_TOL, f"{label}: the model call disagrees: {rel}")


def unfused_call(cldm, inputs):
    import torch

    cldm.set_fused(resblock=False, ffn=False)
    cldm.set_flash_layout("folded")
    with torch.no_grad():
        return cldm(*inputs).float()


def dequantise_into(float_cldm, int8_cldm) -> None:
    """Overwrite the float model's weights at every int8 site of the int8
    model with the dequantised values (w_q * scale, in the float dtype)."""
    import torch

    from diffbir_tpu_torch.models.layers import QuantConv, QuantLinear

    with torch.no_grad():
        for fr_root, q_root in ((float_cldm.unet, int8_cldm.unet),
                                (float_cldm.controlnet, int8_cldm.controlnet)):
            for name, m in q_root.named_modules():
                if isinstance(m, QuantLinear):
                    w = (m.weight_q.float() * m.weight_scale).T  # [in, out] -> [out, in]
                elif isinstance(m, QuantConv):
                    w = (m.weight_q.float() * m.weight_scale).permute(3, 2, 0, 1)  # -> OIHW
                else:
                    continue
                target = fr_root.get_submodule(name).weight
                target.copy_(w.to(target.dtype))


def phase_modes(cldm, swinir):
    """The two serving modes: a model call each against the unfused float
    path, then requests; returns {path: launch counts of its requests}."""
    import copy

    import torch

    from diffbir_tpu_torch.models.cldm import quantize_conv_params, quantize_dense_params

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    c_img = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    with torch.no_grad():
        cond = {"c_txt": cldm.encode_text(empty_tokens(2)), "c_img": c_img}
    inputs = (x, torch.tensor([999.0, 500.0], device="cuda"), cond)
    launches = {}

    # "fused": fused ResBlock + fused FFN + packed flash, on the float weights
    ref = unfused_call(cldm, inputs)
    cldm.set_fused(resblock=True, ffn=True)
    cldm.set_flash_layout("packed")
    mode_call("serve_fused", cldm, inputs, ref,
              {"K3": K3_PER_CALL, "K6": K6_PER_CALL, "K7": K7_PER_CALL},
              {"K3": K3_SITES, "K6": K6_SITES, "K7": K7_SITES})
    launches["serve_fused"] = phase_slice("serve_fused", cldm, swinir, MODE_SEEDS, repeat=False)

    # "int8": the UNet and ControlNet quantised in place (dense, then convs)
    cldm.set_fused(resblock=False, ffn=False)
    cldm.set_flash_layout("folded")
    t0 = time.perf_counter()
    int8 = quantize_dense_params(copy.deepcopy(cldm))
    int8.set_fused(resblock=True, ffn=False)
    quantize_conv_params(int8)
    int8.set_flash_layout("packed")
    torch.cuda.synchronize()
    print(f"[serve_int8] copied and quantised in {time.perf_counter() - t0:.2f} s")
    dequantise_into(cldm, int8)
    ref = unfused_call(cldm, inputs)
    mode_call("serve_int8", int8, inputs, ref,
              {"K3": K3_PER_CALL, "K4": K4_PER_CALL, "K6": K6_PER_CALL},
              {"K3": K3_SITES, "K4": K4_SITES, "K6": K6_SITES})
    launches["serve_int8"] = phase_slice("serve_int8", int8, swinir, MODE_SEEDS, repeat=False)
    del int8
    return launches



# --------------------------------------------------------------------------- #
# the LLaVA-1.5-7B captioner: K5 at its shapes, then captions
# --------------------------------------------------------------------------- #
def swapped_groups(scale):
    """scale_g [K/128, N] with the two groups of every 256-row window
    swapped: K5 run on it is a group-index fault."""
    k2, n = scale.shape
    return scale.reshape(k2 // 2, 2, n).flip(1).reshape(k2, n).contiguous()


def phase_k5(qm):
    """K5 against its plain version at the captioner's shapes (bf16 x), a
    ragged case in each form and fp32 x; the planted fault at the prefill
    and the decode shape. Returns the kernel line's numbers at the decode
    shape (1, 4096, 4096)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes = [(m, k, n) for m in (CAPTION_ROWS, 1) for k, n in LLAVA_SITES]
    cases = ([(s, torch.bfloat16) for s in shapes] + [((77, 4096, 4001), torch.bfloat16),
             ((3, 4096, 4001), torch.bfloat16), ((CAPTION_ROWS, 4096, 4096), torch.float32),
             ((1, 4096, 4096), torch.float32)])
    max_err, headline, times = 0.0, None, {}
    for (m, k, n), dtype in cases:
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        packed, scale = qm.quantize_weight_int4(w)
        del w
        w_deq = qm.unpack_int4(packed).reshape(k // 128, 128, n).float().mul_(
            scale[:, None]).reshape(k, n).to(torch.bfloat16)
        out = qm.quant_matmul_int4(x, packed, scale)
        ref = qm.quant_matmul_int4_ref(x, packed, scale)
        label = f"({m}, {k}, {n}) {str(dtype)[6:]}"
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        err = hold(f"K5 at {label}", out, ref, tol)
        iters = 10 if m > 8 else 50
        ms = median_ms(lambda: qm.quant_matmul_int4(x, packed, scale), iters)
        plain_ms = median_ms(lambda: qm.quant_matmul_int4_ref(x, packed, scale), iters)
        lib_ms = median_ms(lambda: x.to(torch.bfloat16) @ w_deq, iters)
        bms, by = gemm_bound(m, k, n, x, packed, scale, out)
        print(f"[K5] (M, K, N) {label}: {show(out, ref, tol)}; K5 {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (x @ dequantised bf16 W) {lib_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by})")
        if dtype == torch.bfloat16:
            max_err = max(max_err, err)
            times[(m, k, n)] = ms
        if (m, k, n) in ((CAPTION_ROWS, 4096, 4096), (1, 4096, 4096)) and dtype == torch.bfloat16:
            planted(f"K5 at M = {m} with the scale groups of each window swapped",
                    qm.quant_matmul_int4(x, packed, swapped_groups(scale)), ref, tol)
            if m == 1:
                headline = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                            "library_ms": lib_ms}
        del x, packed, scale, w_deq, out, ref
    print(f"[K5] per caption ({QUANT_PER_CAPTION} launches): {per_caption_ms(times):.3f} ms")
    headline["max_abs_err"] = max_err
    return headline


def build_llava():
    """LLaVA-1.5-7B in bf16 with random weights from seed 0, generated on
    the card parameter by parameter (N(0, 1/fan_in), norms 1, biases 0);
    then an int4 and an int8 copy (``quantize_llama_`` in place)."""
    import copy

    import torch

    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.llava import Llava, quantize_llama_

    t0 = time.perf_counter()
    model = Llava.llava15_7b(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    models = {"caption_bf16": model}
    for bits in (4, 8):
        models[f"caption_int{bits}"] = quantize_llama_(copy.deepcopy(model), bits)
    torch.cuda.synchronize()
    sizes = ", ".join(f"{path[8:]} {nbytes(*m.parameters(), *m.buffers()) / 2**30:.2f} GiB"
                      for path, m in models.items())
    n = sum(p.numel() for p in model.parameters())
    print(f"[llava] LLaVA-1.5-7B {n / 1e9:.3f} B params, random bf16 from seed 0, built, "
          f"copied and quantised in {time.perf_counter() - t0:.2f} s ({sizes})")
    return models


def caption_inputs():
    """The seeded 512x512 LQ and the stand-in prompt ids (BOS = 1 first)."""
    import numpy as np

    rng = np.random.default_rng(300)
    lq = rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
    pre = [1] + rng.integers(3, 32000, CAPTION_PRE - 1).tolist()
    return lq, pre, rng.integers(3, 32000, CAPTION_POST).tolist()


class plain_products:
    """Within it, every K4 and K5 site of the port runs its plain version."""

    def __init__(self, qm):
        self.qm = qm

    def __enter__(self):
        self.saved = self.qm.quant_matmul, self.qm.quant_matmul_int4
        self.qm.quant_matmul = self.qm.quant_matmul_ref
        self.qm.quant_matmul_int4 = self.qm.quant_matmul_int4_ref

    def __exit__(self, *exc):
        self.qm.quant_matmul, self.qm.quant_matmul_int4 = self.saved


def teacher_forced(path, qm, cap, lq, tokens, step_logits, float_lm):
    """The generated ids through the same model on the plain products in one
    prefill: logits at the 60 generated positions against the kernel path's
    within CAPTION_REL_TOL x max|plain logits|, and each id equal to the
    plain argmax wherever the plain top-2 margin exceeds that limit. The
    float model (``float_lm``) on the same ids must fail the limit in the
    int4 mode."""
    import torch

    lm = cap.model.language_model
    with torch.no_grad(), plain_products(qm):
        embeds = cap.prompt_embeds(lq)
        seq = torch.cat([embeds, lm.model.embed_tokens(tokens[:, :-1])], dim=1)
        plain = lm(seq)[0, embeds.shape[1] - 1:].float()
        unquantised = float_lm(seq)[0, embeds.shape[1] - 1:].float()
    kernel = torch.cat(step_logits).float()
    limit = CAPTION_REL_TOL * plain.abs().max().item()
    err = (kernel - plain).abs().max().item()
    err_float = (unquantised - plain).abs().max().item()
    top2 = plain.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > limit
    same = bool(torch.equal(tokens[0][clear], plain.argmax(-1)[clear]))
    agree = int((tokens[0] == plain.argmax(-1)).sum())
    print(f"[{path}] teacher forcing on the plain products: logits max err {err:.3e}, limit "
          f"{limit:.3e} ({CAPTION_REL_TOL:g} x max|plain|); ids equal to the plain argmax at "
          f"{agree}/{CAPTION_NEW} positions, at all {int(clear.sum())} with a top-2 margin above "
          f"the limit: {same}; the float model on the same ids: max err {err_float:.3e} "
          f"({err_float / limit:.1f} x the limit)")
    check(err <= limit, f"{path}: kernel logits disagree with the plain products: {err} > {limit}")
    check(same, f"{path}: an id differs from the plain argmax where the margin is clear")
    if path == "caption_int4":
        check(err_float > limit, f"the limit does not see int4 quantisation: {err_float} <= {limit}")


def phase_caption(path, qm, model, lq, pre, post, float_lm):
    """One caption of the LQ in one mode (after a warm-up caption): launch
    counts, stage times, tokens/s, memory; teacher forcing for the quantised
    modes. Returns (launch counts, ids)."""
    import torch

    from diffbir_tpu_torch.captioners.llava import LLaVACaptioner

    cap = LLaVACaptioner(model, pre, post, max_new_tokens=CAPTION_NEW, eos_id=NEVER_EOS)
    cap.generate(lq[0])  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    timings, step_logits = {}, []
    reset_counts()  # count only this caption from here
    t0 = time.perf_counter()
    tokens = cap.generate(lq[0], timings=timings, step_logits=step_logits)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    ran = {k: v for k, v in launches.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    weights = nbytes(*model.parameters(), *model.buffers()) / 2**30
    steps = timings["decode_steps"]
    print(f"[{path}] caption {dt:.3f} s: vision {1e3 * timings['vision']:.2f} ms, prefill "
          f"({CAPTION_ROWS} rows) {1e3 * timings['prefill']:.2f} ms, decode "
          f"{1e3 * timings['decode'] / steps:.3f} ms per token over {steps} steps; "
          f"{CAPTION_NEW / (timings['prefill'] + timings['decode']):.2f} tokens/s after the "
          f"tower; device memory: this mode's weights {weights:.2f} GiB + the caption's "
          f"{peak - resident:.2f} GiB above what was resident ({resident:.2f} GiB, every mode's "
          f"model and the SD models), peak {peak:.2f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in ran.items()))
    check(steps == CAPTION_NEW - 1, f"{path}: {steps} decode steps")
    check(ran == CAPTION_PATHS[path], f"{path}: expected launches {CAPTION_PATHS[path]}, got {ran}")
    check(tokens.shape == (1, CAPTION_NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < 32000, f"{path}: bad ids {tokens}")
    check(all(bool(torch.isfinite(lg).all()) for lg in step_logits), f"{path}: non-finite logits")
    print(f"[{path}] ids {tokens[0].tolist()}")
    if path != "caption_bf16":
        teacher_forced(path, qm, cap, lq[0], tokens, step_logits, float_lm)
    return launches, tokens


def phase_captioned_request(model, cldm, swinir, lq, pre, post):
    """The int4 caption of the LQ, then the default SwinIRPipeline.run on the
    same LQ, both models resident. The SD prompt stays the empty-prompt ids
    (the caption ids cannot be tokenised for CLIP without the vocabulary)."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.captioners.llava import LLaVACaptioner
    from diffbir_tpu_torch.pipeline import SwinIRPipeline
    from diffbir_tpu_torch.schedule import Schedule

    cap = LLaVACaptioner(model, pre, post, max_new_tokens=CAPTION_NEW, eos_id=NEVER_EOS)
    pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count only this request from here
    t0 = time.perf_counter()
    ids = cap(lq[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    timings = {}
    out = pipe.run(lq, steps=STEPS, cfg_scale=CFG, seed=1, timings=timings)
    t2 = time.perf_counter()
    launches = counts()
    ran = {k: v for k, v in launches.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[captioned_request] caption {t1 - t0:.3f} s ({len(ids)} ids), restore "
          f"{t2 - t1:.3f} s, total {t2 - t0:.3f} s; peak device memory {peak:.2f} GiB; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in ran.items()))
    print(f"[captioned_request] caption ids {ids}")
    check(ran == CAPTION_PATHS["captioned_request"],
          f"captioned_request: expected launches {CAPTION_PATHS['captioned_request']}, got {ran}")
    check(len(ids) == CAPTION_NEW, f"captioned_request: {len(ids)} ids")
    check(out.shape == (1, SIZE, SIZE, 3) and out.dtype == np.uint8 and float(out.std()) > 1.0,
          f"captioned_request: bad output {out.shape} {out.dtype}")
    return launches


def phase_llava(qm, cldm, swinir):
    """The three caption modes and the captioned request; returns {path:
    launch counts}."""
    import torch

    models = build_llava()
    lq, pre, post = caption_inputs()
    launches, ids = {}, {}
    for path in ("caption_int4", "caption_int8", "caption_bf16"):
        launches[path], ids[path] = phase_caption(path, qm, models[path], lq, pre, post,
                                                  models["caption_bf16"].language_model)
    same = {p: int((ids[p] == ids["caption_bf16"]).sum()) for p in ("caption_int4", "caption_int8")}
    print(f"[llava] ids equal to the bf16 caption's: int4 {same['caption_int4']}/{CAPTION_NEW}, "
          f"int8 {same['caption_int8']}/{CAPTION_NEW} (random weights: no quality claim)")
    del models["caption_int8"], models["caption_bf16"]
    torch.cuda.empty_cache()
    launches["captioned_request"] = phase_captioned_request(
        models["caption_int4"], cldm, swinir, lq, pre, post)
    return launches



def controlnet_grad(cldm, loss_fn, batch, draws):
    """The ControlNet's flattened gradient of one loss (zeros for a tensor
    that got none) and the number of its tensors that got none."""
    import torch

    loss_fn(batch, draws=draws).backward()
    params = list(cldm.controlnet.parameters())
    flat = torch.cat([p.grad.float().flatten() if p.grad is not None
                      else torch.zeros(p.numel(), device=p.device) for p in params])
    missing = sum(p.grad is None for p in params)
    cldm.controlnet.zero_grad(set_to_none=True)
    return flat.double(), missing  # float64 sums over 363 M terms


def compare_grads(a, p):
    """(relative norm difference, cosine similarity) of a against p."""
    na, np_ = a.norm().item(), p.norm().item()
    return abs(na - np_) / np_, (a @ p).item() / (na * np_)


def phase_train(fa):
    """The training path; returns the launch counts of its timed and warm-up
    steps."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.profile_step import NOISE_AUG, TRAIN_LR, build_train_setup
    from diffbir_tpu_torch.train import stage2

    t0 = time.perf_counter()
    setup = build_train_setup(0, torch.device("cuda"), TRAIN_BATCH, SIZE)
    cldm, swinir, opt = setup.cldm, setup.swinir, setup.optimizer
    n_cn = sum(p.numel() for p in cldm.controlnet.parameters())
    print(f"[train] sd21 ControlLDM with checkpointing, ControlNet from the UNet, SwinIR "
          f"cleaner, random bf16 weights from seed 0, built in {time.perf_counter() - t0:.2f} s; "
          f"ControlNet {n_cn / 1e6:.1f} M trainable params (fp32 masters, AdamW "
          f"lr {TRAIN_LR:g}, weight decay 0), UNet/VAE/CLIP/SwinIR frozen")

    frozen = {name: [p.detach().clone() for p in mod.parameters()]
              for name, mod in (("UNet", cldm.unet), ("VAE", cldm.vae), ("CLIP", cldm.clip),
                                ("SwinIR", swinir))}
    masters0 = [m.clone() for m in opt.masters]
    module0 = [p.detach().clone() for p in cldm.controlnet.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count only the training path from here
    step_s = []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        before = counts()
        t0 = time.perf_counter()
        m = setup.train_step(setup.batch, gen)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = launched_since(before)
        kind = "warm-up" if i < TRAIN_WARMUP else "timed"
        print(f"[train] step {i} ({kind}): loss {loss:.5f}, grad norm {gnorm:.5f}, "
              f"{dt:.3f} s; launches " + ", ".join(f"{k} {v}" for k, v in n.items()))
        check(np.isfinite(loss) and np.isfinite(gnorm), f"non-finite loss or grad norm at {i}")
        expected = {"K1": K1_PER_TRAIN_STEP, "K2a": K2_SITES_PER_TRAIN_STEP,
                    "K2b": K2_SITES_PER_TRAIN_STEP}
        check(n == expected, f"expected launches {expected} per step, got {n}")
        if i >= TRAIN_WARMUP:
            step_s.append(dt)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(step_s)
    print(f"[train] batch {TRAIN_BATCH} at {SIZE}x{SIZE}: timed steps "
          f"{', '.join(f'{x:.3f}' for x in step_s)} s (median {med:.3f} s, "
          f"{TRAIN_BATCH / med:.2f} images/s); peak device memory {peak:.2f} GiB")

    for name, before in frozen.items():
        mod = {"UNet": cldm.unet, "VAE": cldm.vae, "CLIP": cldm.clip, "SwinIR": swinir}[name]
        check(all(torch.equal(a, p) for a, p in zip(before, mod.parameters())),
              f"the frozen {name} changed")
    moved_masters = sum(not torch.equal(a, m) for a, m in zip(masters0, opt.masters))
    moved = sum(int((a != p).sum()) for a, p in zip(module0, cldm.controlnet.parameters()))
    print(f"[train] ControlNet: {moved_masters}/{len(masters0)} fp32 master tensors and "
          f"{moved}/{n_cn} module elements changed; UNet, VAE, CLIP, SwinIR unchanged")
    check(moved_masters == len(masters0), "some ControlNet master tensors did not move")
    check(moved > 0, "the ControlNet's module weights did not change")
    del frozen, masters0, module0

    # one step's ControlNet gradient at batch 2: through K1+K2, then plain
    loss_fn = stage2.make_loss_fn(cldm, setup.schedule, setup.cleaner, NOISE_AUG)
    small = {k: v[:2] for k, v in setup.batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    latent = (2, SIZE // 8, SIZE // 8, 4)
    draws = {"posterior": torch.randn(latent, generator=gen, device="cuda"),
             "aug": torch.randn(latent, generator=gen, device="cuda"),
             "t": torch.randint(0, setup.schedule.num_timesteps, (2,), generator=gen,
                                device="cuda"),
             "noise": torch.randn(latent, generator=gen, device="cuda")}
    flat = {}
    for impl in ("auto", "plain"):
        cldm.set_attention_impl(impl)
        flat[impl], missing = controlnet_grad(cldm, loss_fn, small, draws)
        check(missing == 0, f"{missing} ControlNet tensors got no gradient ({impl} attention)")
    cldm.set_attention_impl("auto")
    rel, cos = compare_grads(flat["auto"], flat["plain"])
    print(f"[train] batch-2 ControlNet gradient, K1+K2 vs plain attention: grad norms "
          f"{flat['auto'].norm().item():.5f} / {flat['plain'].norm().item():.5f}, relative "
          f"difference {rel:.3e} (tol {GRAD_NORM_REL_TOL:g}), cosine similarity {cos:.7f} "
          f"(min {GRAD_COS_MIN:g})")
    check(rel <= GRAD_NORM_REL_TOL and cos >= GRAD_COS_MIN,
          "the ControlNet gradient through K1+K2 disagrees with plain attention")

    # the check's power: K1 without its autograd Function drops the gradients
    # of q, k and v at every flash site; that gradient must fail the limits
    flash = fa.flash_attention
    fa.flash_attention = lambda q, k, v: fa.flash_attention_fwd(q.detach(), k.detach(),
                                                                v.detach())
    try:
        dropped, missing = controlnet_grad(cldm, loss_fn, small, draws)
    finally:
        fa.flash_attention = flash
    rel_d, cos_d = compare_grads(dropped, flat["plain"])
    print(f"[train] the same with q/k/v gradients dropped at the flash sites: {missing} "
          f"ControlNet tensors got no gradient, relative difference {rel_d:.3e}, cosine "
          f"similarity {cos_d:.7f}")
    check(rel_d > GRAD_NORM_REL_TOL or cos_d < GRAD_COS_MIN,
          "the gradient limits do not catch dropped attention gradients")
    return launches


def main() -> int:
    # one card: the first that the caller shows, or the first of the machine
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0] if visible is not None else "0"
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
        from diffbir_tpu_torch.ops import fused_ffn as ff
        from diffbir_tpu_torch.ops import fused_resblock as fr
        from diffbir_tpu_torch.ops import quant_matmul as qm
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    KERNELS.update(K1=fa.KERNEL, K2a=fa.KERNEL_DQ, K2b=fa.KERNEL_DKV, K3=fa.KERNEL_PRESCALED,
                   K4=qm.KERNEL, K5=qm.KERNEL_INT4, K6=fr.KERNEL, K7=ff.KERNEL)
    t_start = time.perf_counter()
    try:
        check(torch.cuda.device_count() == 1,
              f"expected one visible card, got {torch.cuda.device_count()}")
        phase_device()
        phase_build()
        numbers = {"K1": phase_kernel(fa)}
        k2 = phase_backward_kernels(fa)
        numbers.update(K2a=k2["dq"], K2b=k2["dkv"], K3=phase_k3(fa), K4=phase_k4(qm),
                       K5=phase_k5(qm), K6=phase_k6(fr), K7=phase_k7(ff))
        torch.cuda.empty_cache()
        cldm, swinir = build_models()
        phase_model_call(fa, cldm)
        paths = {"serve": phase_slice("serve", cldm, swinir, SEEDS)}
        paths.update(phase_modes(cldm, swinir))
        paths.update(phase_llava(qm, cldm, swinir))
        del cldm, swinir
        torch.cuda.empty_cache()
        paths["train"] = phase_train(fa)
        for path, expected in {**PER_REQUEST, **CAPTION_PATHS}.items():  # and no other kernel
            check(all(n == 0 for k, n in paths[path].items() if k not in expected),
                  f"{path} launched other kernels: {paths[path]}")
    except (SmokeFailure, RuntimeError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    src, ref = "diffbir_tpu_torch/csrc/", "diffbir_tpu/ops/"
    entries = (
        ("K1", "flash_attention_fwd", "flash_attention_fwd.cu", "flash_attention.py:81"),
        ("K2a", "flash_attention_bwd_dq", "flash_attention_bwd.cu", "flash_attention.py:371"),
        ("K2b", "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "flash_attention.py:410"),
        ("K3", "flash_attention_fwd_prescaled", "flash_attention_fwd.cu",
         "flash_attention.py:229"),
        ("K4", "quant_matmul", "quant_matmul.cu", "quant_matmul.py:45"),
        ("K5", "quant_matmul_int4", "quant_matmul_int4.cu", "quant_matmul.py:232"),
        ("K6", "fused_resblock", "fused_resblock.cu", "fused_resblock.py:141"),
        ("K7", "fused_ffn", "fused_ffn.cu", "fused_ffn.py:91"),
    )
    kernels = []
    for key, name, source, replaces in entries:
        by_path = {path: n[key] for path, n in paths.items()}
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": ref + replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **numbers[key]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
