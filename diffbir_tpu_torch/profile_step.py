"""Profile one denoise step of the port on a CUDA device.

The step is the model call a 512x512 request makes 50 times: a full-width
SD2.1 ControlLDM (UNet + IRControlNet, random bf16 weights from seed 0) at
batch 2 on a 64x64 latent, classifier-free guidance folded into the batch.
Prints

- host and device time per step, with the flash kernel (K1) and with plain
  attention, in the order plain, K1, K1, plain: the medians over 10 calls of
  the host's enqueue time (call to return), of the wall time (call to device
  sync) and of the device span between two CUDA events;
- a ``torch.profiler`` view of 3 steps through K1: device time by kernel,
  device kernels and ``aten::copy_`` calls per step, K1's device time, and the
  device's busy share of the profiled window.

Run from the repository root on a machine with a card:

    python3 -m diffbir_tpu_torch.profile_step [--trace step_trace.json]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch
from torch.autograd import DeviceType

from .models.cldm import ControlLDM
from .models.layers import random_init_
from .pipeline import EOT, SOT
from .sampler.base import cfg_model_call

LATENT, CFG, SEED = 64, 4.0, 0
TIMED_STEPS, PROFILED_STEPS = 10, 3


def build_step(seed: int, device: torch.device):
    """A full-width bf16 ControlLDM and one sampler step's folded-CFG call."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device=device)
    random_init_(cldm, gen).eval()
    tokens = torch.zeros(1, cldm.clip.context_length, dtype=torch.long, device=device)
    tokens[:, 0], tokens[:, 1] = SOT, EOT
    size = 8 * LATENT
    with torch.no_grad():
        img = torch.rand(1, size, size, 3, generator=gen, device=device)
        cond = cldm.prepare_condition(img, tokens)
        uncond = dict(c_txt=cldm.encode_text(tokens), c_img=cond["c_img"])
    x = torch.randn(1, LATENT, LATENT, 4, generator=gen, device=device)
    t = torch.full((1,), 999.0, device=device)

    @torch.no_grad()
    def step():
        return cfg_model_call(lambda xx, tt, cc: cldm(xx, tt, cc), x, t, cond, uncond, CFG)

    return cldm, step


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
    k1 = [e.time_range.elapsed_us() for e in kernels if "flash_fwd_kernel" in e.name]
    copies = sum(1 for e in events if e.name == "aten::copy_")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    return {"table": table, "steps": n, "window_ms": window / 1e3,
            "busy_ms_per_step": busy / 1e3 / n, "kernels_per_step": len(kernels) / n,
            "k1_ms_per_step": sum(k1) / 1e3 / n,
            "k1_launches_per_step": len(k1) / n, "copies_per_step": copies / n,
            "busy_share": busy / window}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the profiled steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    cldm, step = build_step(SEED, device)
    print(f"[profile] {torch.cuda.get_device_name(0)}; ControlLDM sd21 bf16, batch 2 "
          f"(CFG {CFG} folded), {LATENT}x{LATENT} latent")
    for impl in ("plain", "auto", "auto", "plain"):
        cldm.set_attention_impl(impl)
        r = time_steps(step, TIMED_STEPS)
        name = "K1" if impl == "auto" else "plain"
        print(f"[step] attention {name}: median of {TIMED_STEPS} steps: enqueue "
              f"{r['enqueue_ms']:.2f} ms, wall {r['wall_ms']:.2f} ms, "
              f"device span {r['device_ms']:.2f} ms")
    cldm.set_attention_impl("auto")
    p = profile_steps(step, PROFILED_STEPS, args.trace)
    print(p["table"])
    print(f"[profile] {p['steps']} steps through K1 ({p['k1_launches_per_step']:.0f} K1 "
          f"launches per step): device busy {p['busy_ms_per_step']:.2f} "
          f"ms per step, {p['kernels_per_step']:.0f} device kernels per step, "
          f"{p['copies_per_step']:.0f} aten::copy_ per step, K1 "
          f"{p['k1_ms_per_step']:.2f} ms per step "
          f"({p['k1_ms_per_step'] / p['busy_ms_per_step']:.1%} of busy); busy share of the "
          f"{p['window_ms']:.2f} ms window {p['busy_share']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
