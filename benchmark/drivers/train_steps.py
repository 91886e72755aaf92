"""Back-to-back stage-2 training steps.

Set-up builds the step the port's trainer runs (``train.stage2``:
``init_train_state``, ``make_train_step`` with the frozen SwinIR cleaner,
the v2.1 schedule and ``MasterAdamW``) on the configuration's networks with
gradient checkpointing and the ControlNet initialised from the UNet, and a
pool of batches made on the device from the seed (gt in [-1, 1], lq in
[0, 1], prompt ids with the traffic file's share of empty prompts; the
rows of any three pool batches all differ). It drives that step through its
first ``checked_steps`` steps, reading the loss of each, the first
gradient from the optimiser's first moment after one step, and each
ControlNet leaf's change after the last; then the same object runs the
window. Every step takes its draws (posterior, augmentation and q_sample
noise, timesteps) from the benchmark's own generator, handed in through the
step's ``draws``, so the reference gets the same.

Window: steps back to back, issued while the host clock is inside the
window, then waited for: images per second over all of them and all that
time. The traced run profiles ``profiled_steps`` whole steps in the middle.

Correctness: the float32 reference (``reference.train``) follows the same
first steps from the same weights, batches and draws; compared are the
largest relative gap of a step's loss, and by the worst leaf the gaps of
the first gradient's norm and of the change's norm (each against the
reference's norm of that leaf or of the median leaf, whichever is larger;
leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the change).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from ..lib import flops
from ..lib.tokenizer import stand_in_tokenizer
from ..lib.trace import KERNELS, SubWindow, Trace
from .common import (Context, checked, device_info, log, program_networks, reference_networks,
                     reference_precision, release, sizes_json)

CAPTIONS = ("a photo of a street at night with wet asphalt and neon signs",
            "portrait of an old man with a grey beard, studio light",
            "a red bicycle leaning on a brick wall", "mountains above a lake at sunrise",
            "a bowl of fruit on a wooden table", "a dog running on a beach")


def make_pool(seed: int, n_batches: int, batch: int, side: int, p_empty: float, ctx_len: int,
              device) -> list:
    """``n_batches`` batches of ``batch`` rows, made on the device from the
    seed: gt [-1, 1] and lq [0, 1] NHWC float32 (a smooth field plus noise,
    lq a blurred and noisier copy), prompt ids (empty with ``p_empty``)."""
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    tok = stand_in_tokenizer(seed, ctx_len)
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(n_batches):
        coarse = torch.rand(batch, 3, side // 32, side // 32, generator=g, device=device)
        field = torch.nn.functional.interpolate(coarse, size=(side, side), mode="bilinear")
        fine = torch.randn(batch, 3, side, side, generator=g, device=device)
        gt = (field * 1.6 - 0.8 + 0.15 * fine).clamp(-1, 1)
        lq = ((torch.nn.functional.avg_pool2d(gt, 5, 1, 2) + 1) / 2
              + 0.05 * torch.randn(batch, 3, side, side, generator=g, device=device))
        texts = ["" if rng.random() < p_empty else CAPTIONS[rng.integers(len(CAPTIONS))]
                 for _ in range(batch)]
        pool.append({"gt": gt.permute(0, 2, 3, 1).contiguous(),
                     "lq": lq.clamp(0, 1).permute(0, 2, 3, 1).contiguous(),
                     "tokens": torch.as_tensor(tok(texts), device=device)})
    return pool


def make_draws(g: torch.Generator, batch: int, lat: int, device) -> dict:
    return {"posterior": torch.randn(batch, lat, lat, 4, generator=g, device=device),
            "aug": torch.randn(batch, lat, lat, 4, generator=g, device=device),
            "t": torch.randint(0, 1000, (batch,), generator=g, device=device),
            "noise": torch.randn(batch, lat, lat, 4, generator=g, device=device)}


def _launches() -> dict:
    from diffbir_tpu_torch.ops import flash_attention as fa

    return {"K2a": fa.KERNEL_DQ_TC.launches, "K2b": fa.KERNEL_DKV_TC.launches}


def run(ctx: Context) -> dict:
    from diffbir_tpu_torch.schedule import Schedule
    from diffbir_tpu_torch.train import stage2

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    bs, side = cfg["batch_size"], tr["side"]
    lat, n_check = side // 8, tr["checked_steps"]
    cldm, swinir = program_networks(cfg, dev, ctx.seed, use_checkpoint=True)
    cldm.load_controlnet_from_unet()
    swinir.eval().requires_grad_(False)

    def cleaner(lq):
        return swinir(lq).clamp(0.0, 1.0)

    optimizer = stage2.init_train_state(cldm, cfg["learning_rate"])
    step = stage2.make_train_step(cldm, Schedule.v21(), optimizer, cleaner, cfg["noise_aug"])
    if "step" in ctx.faults:
        step = ctx.faults["step"](step, optimizer)
    pool = make_pool(ctx.seed, tr["pool_batches"], bs, side, tr["p_empty_prompt"],
                     cldm.clip.context_length, dev)
    g = torch.Generator(device=dev).manual_seed(int(ctx.seed) + 2)
    names = [n for n, _ in cldm.controlnet.named_parameters()]
    before = [m.detach().clone() for m in optimizer.masters]
    losses = []
    grad = change = None
    for k in range(n_check):
        out = step(pool[k % len(pool)], draws=make_draws(g, bs, lat, dev))
        losses.append(float(out["loss"]))
        if k == 0:
            state = optimizer.optimizer.state
            grad = {n: float(state[m]["exp_avg"].norm()) / 0.1 if m in state else 0.0
                    for n, m in zip(names, optimizer.masters)}
    change = {n: float((m - b).norm()) for n, m, b in zip(names, optimizer.masters, before)}
    del before
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if ctx.trace:
        SubWindow().warm()
    setup_s = time.perf_counter() - ctx.t_process
    log(f"set-up {setup_s:.1f} s (with {n_check} checked steps); batch {bs}")

    prof_at = tr["profile_after_steps"]
    n_prof = tr["profiled_steps"] if ctx.trace else 0
    steps_done, steady_s = 0, 0.0
    t0 = time.perf_counter()
    t_close = t0 + ctx.seconds
    k = n_check
    profiled = []  # (sub-window, launches) of each profiled step
    while time.perf_counter() < t_close:
        sub = None
        if prof_at <= steps_done < prof_at + n_prof:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if steps_done == prof_at:
                steady_s = time.perf_counter() - t0
            sub, before = SubWindow(), _launches()
            sub.start()
        step(pool[k % len(pool)], draws=make_draws(g, bs, lat, dev))
        k += 1
        steps_done += 1
        if sub is not None:
            sub.stop()
            profiled.append((sub, {n: v - before[n] for n, v in _launches().items()}))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"{steps_done} steps in {window:.2f} s")
    e2e = {"train_images_per_s": {"value": steps_done * bs / window, "unit": "images/s"},
           "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
           "setup_s": {"value": setup_s, "unit": "s"}}
    readings = None
    if ctx.trace:
        if len(profiled) != n_prof:
            raise RuntimeError(f"the window ended before step {prof_at + n_prof}: "
                               "no profiled sub-window")
        sites = flops.attention_sites(cfg["cldm"]["unet"], (lat, lat))
        grad_sites = sites["cn_in"] + sites["cn_mid"] + sites["unet_out"]
        traces = []
        for sub, launches in profiled:  # whole records only (the profiler can drop some)
            t = sub.reduce()
            seen = [len(t.kernel_us(KERNELS[n])) for n in ("K2a", "K2b")]
            counts = seen + [launches["K2a"], launches["K2b"], len(grad_sites)]
            if len(set(counts)) == 1:
                traces.append(t)
            else:
                log(f"a profiled step left out: K2a, K2b launches (profiler, counter, "
                    f"shapes) {counts}")
        readings = {
            "trace": Trace.merge(traces), "steps_profiled": len(traces),
            "k2_least_us": len(traces) * sum(flops.least_us(*flops.attn_bwd(bs, s))
                                             for s in grad_sites),
            "k2_symbols": (KERNELS["K2a"], KERNELS["K2b"]),
            "steady_flops": prof_at * bs * flops.train_flops(sizes_json(cfg), side),
            "steady_s": steady_s,
        }
    del step, optimizer, cldm, swinir, pool
    release(dev)
    program = {"loss": losses, "grad": grad, "change": change}
    compared = _compare(ctx, program) if ctx.check else []
    return {"attempted": steps_done, "failed": 0, "e2e": e2e, "readings": readings,
            "program": program, "device": device_info(dev, peak), "compared": compared}


def reference_readings(ctx: Context, prepare=None) -> dict:
    """The float32 reference's first steps from the run's weights, batches
    and draws; ``prepare(cldm)`` may change its networks first (the int8
    control)."""
    from ..reference.train import train_steps

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    bs, side = cfg["batch_size"], tr["side"]
    reference_precision()
    ref_cldm, ref_swinir = reference_networks(cfg, dev, ctx.seed)
    ref_cldm.controlnet_from_unet_()
    if prepare is not None:
        prepare(ref_cldm)
    ref_cldm.requires_grad_(False)
    ref_swinir.requires_grad_(False)
    ref_cldm.controlnet.requires_grad_(True)
    pool = make_pool(ctx.seed, tr["pool_batches"], bs, side, tr["p_empty_prompt"],
                     ref_cldm.clip.context_length, dev)
    g = torch.Generator(device=dev).manual_seed(int(ctx.seed) + 2)
    n_check = tr["checked_steps"]
    batches = [pool[k % len(pool)] for k in range(n_check)]
    draws = [make_draws(g, bs, side // 8, dev) for _ in range(n_check)]
    out = train_steps(ref_cldm, ref_swinir, batches, draws, cfg["learning_rate"],
                      cfg["noise_aug"], tr["reference_block"], getattr(torch, cfg["dtype"]))
    del ref_cldm, ref_swinir, pool
    release(dev)
    return out


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers of ``prog``'s readings against ``ref``'s."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    med_g = statistics.median(ref["grad"].values())
    grad_gap = max(abs(prog["grad"][n] - r) / max(r, med_g) for n, r in ref["grad"].items())
    moved = [n for n, r in ref["grad"].items() if r >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][n] for n in moved)
    change_gap = max(abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], med_c)
                     for n in moved)
    out = sorted(set(ref["grad"]) - set(moved))
    log(f"losses {prog['loss']} reference {ref['loss']}; {len(out)} leaves left out of the "
        f"change (reference gradient under 1e-3 x the median leaf's): {out[:8]}")
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap}


def _compare(ctx: Context, program: dict) -> list:
    g = gaps(program, reference_readings(ctx))
    return [checked(k, v, ctx.traffic[f"limit_{k}"]) for k, v in g.items()]
