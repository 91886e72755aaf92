#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check them.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  0. device: the card's name and power limit; TF32 off for fp32 matmuls and
     convolutions, so fp32 comparisons are exact-math comparisons.
  1. build the flash-attention kernels from diffbir_tpu_torch/csrc, one nvcc
     per source, both started together: K1 (forward) and K2a/K2b (backward).
  2. K1 against its plain PyTorch version at the serving shapes and at the
     training path's frozen VAE encodes ([8,4096,1,512]), with median times of
     both and of the library call.
  3. K1 with its logsumexp, K2a (dq) and K2b (dk, dv) against their plain
     versions at the training shapes (batch 8), a ragged, a strided and an
     fp32 case and d = 128/256/512; the backward run twice must give
     bit-identical gradients; a kernel that skips a kv tile must fail the
     limits (their power); median times of kernel, plain version and the
     library call (scaled_dot_product_attention forward, and its backward
     through autograd), beside the bound.
  4. model call: one full-width SD2.1 ControlLDM forward (random bf16 weights)
     at batch 2 on a 64x64 latent, through K1 and through plain attention.
  5. serving path: SwinIRPipeline.run on 512x512 uint8 LQs, 50 spaced steps,
     CFG 4.0, the v2.1 schedule, distinct seeds, then one seed again; K1's
     launch count per request, latency, stage split and peak memory.
  6. training path: stage-2 IRControlNet train steps at full width (SD2.1 +
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

import concurrent.futures
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


def phase_build(fa):
    """One nvcc per source, started together; K2b shares K2a's library."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(kernel.load) for kernel in (fa.KERNEL, fa.KERNEL_DQ)]
        for f in futures:
            f.result()
    fa.KERNEL_DKV.load()
    print(f"[build] flash_attention_fwd.cu and flash_attention_bwd.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for kernel in (fa.KERNEL, fa.KERNEL_DQ):
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("[build]", line.strip())


def sdpa_fwd(q, k, v):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2))


def limit_of(ref, tol: float) -> float:
    """The error limit against a reference: ``tol`` times its largest |value|."""
    return tol * ref.float().abs().max().item()


def phase_kernel(fa):
    """K1 against its plain version at the serving shapes and at the frozen
    VAE encodes' batch-8 shape of training; returns the kernel line's numbers
    at [2,4096,5,64] bf16."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [((2, 4096, 5, 64), torch.bfloat16), ((2, 1024, 10, 64), torch.bfloat16),
             ((2, 256, 20, 64), torch.bfloat16), ((2, 64, 20, 64), torch.bfloat16),
             ((1, 4096, 1, 512), torch.bfloat16), ((8, 4096, 1, 512), torch.bfloat16),
             ((2, 4000, 5, 64), torch.bfloat16),
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
        if shape == (2, 4096, 5, 64):
            lib_ms = median_ms(lambda: sdpa_fwd(q, k, v))
            lib = f", library {lib_ms:.4f} ms"
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


def reset_counts(fa):
    for kernel in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV):
        kernel.launches = 0


def counts(fa):
    return fa.KERNEL.launches, fa.KERNEL_DQ.launches, fa.KERNEL_DKV.launches


def phase_slice(fa, cldm, swinir):
    """The serving path; returns the launch counts of (K1, K2a, K2b) in it."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.pipeline import SwinIRPipeline
    from diffbir_tpu_torch.schedule import Schedule

    pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), torch.device("cuda"))
    lqs = {s: np.random.default_rng(100 + s).integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
           for s in SEEDS}
    outs, lat = {}, []
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)  # count only the serving path from here
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
    launches = counts(fa)
    check(launches[1:] == (0, 0), f"the serving path launched the backward: {launches}")
    check(not np.array_equal(outs[SEEDS[0]], outs[SEEDS[1]]), "distinct seeds gave one output")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[slice] per-request latency {', '.join(f'{x:.3f}' for x in lat)} s "
          f"(median {statistics.median(lat):.3f} s); peak device memory {peak:.2f} GiB")
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
    """The training path; returns the launch counts of (K1, K2a, K2b) in its
    timed and warm-up steps."""
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
    reset_counts(fa)  # count only the training path from here
    step_s = []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        before = counts(fa)
        t0 = time.perf_counter()
        m = setup.train_step(setup.batch, gen)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = tuple(a - b for a, b in zip(counts(fa), before))
        kind = "warm-up" if i < TRAIN_WARMUP else "timed"
        print(f"[train] step {i} ({kind}): loss {loss:.5f}, grad norm {gnorm:.5f}, "
              f"{dt:.3f} s; launches K1 {n[0]}, K2a {n[1]}, K2b {n[2]}")
        check(np.isfinite(loss) and np.isfinite(gnorm), f"non-finite loss or grad norm at {i}")
        check(n == (K1_PER_TRAIN_STEP, K2_SITES_PER_TRAIN_STEP, K2_SITES_PER_TRAIN_STEP),
              f"expected ({K1_PER_TRAIN_STEP}, {K2_SITES_PER_TRAIN_STEP}, "
              f"{K2_SITES_PER_TRAIN_STEP}) launches per step, got {n}")
        if i >= TRAIN_WARMUP:
            step_s.append(dt)
    launches = counts(fa)
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
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        check(torch.cuda.device_count() == 1,
              f"expected one visible card, got {torch.cuda.device_count()}")
        phase_device()
        phase_build(fa)
        k1 = phase_kernel(fa)
        k2 = phase_backward_kernels(fa)
        cldm, swinir = build_models()
        phase_model_call(fa, cldm)
        serve = phase_slice(fa, cldm, swinir)
        del cldm, swinir
        torch.cuda.empty_cache()
        train = phase_train(fa)
    except (SmokeFailure, RuntimeError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    src = "diffbir_tpu_torch/csrc/"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": src + "flash_attention_fwd.cu",
         "replaces": "diffbir_tpu/ops/flash_attention.py:81",
         "launches": serve[0] + train[0],
         "launches_by_path": {"serve": serve[0], "train": train[0]}, **k1},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": "diffbir_tpu/ops/flash_attention.py:371",
         "launches": serve[1] + train[1],
         "launches_by_path": {"serve": serve[1], "train": train[1]}, **k2["dq"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": "diffbir_tpu/ops/flash_attention.py:410",
         "launches": serve[2] + train[2],
         "launches_by_path": {"serve": serve[2], "train": train[2]}, **k2["dkv"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
