"""Served restorations under an open loop.

Set-up: the port's SwinIR pipeline (``SwinIRPipeline``) behind its
``BatchingServer`` at the traffic file's batch, wait and bucket, with a
recording proxy in the pipeline's place that counts the requests of each
``run`` call and, in the traced run, takes the pipeline's stage times
(``timings=``, which sync the device) and profiles a few whole calls. Each
batch size the server can form is run once before the window.

Window: the requests' arrivals are a Poisson process at the traffic file's
rate: the same set of exponential gaps for every seed, in the seed's order.
Each request is an LQ image made from the seed, upscaled by
``serve.upscale_image`` as the server's handler does, then submitted from a
thread of its own at its due time; it is timed from that due time until its
image is back. After the window every request due in it is waited for, a
minute past the close at most; one that never returns, or that raises, is
counted as failed and as missing any latency.

The run delivers the cell's traffic only while each request starts on
time: the generator's largest lateness (``generator_late_ms``, over the
whole window, or in the traced run over the steady part before the first
profiled call, whose profiler stalls the host) is held to the traffic
file's limit beside the comparison.

Correctness: every request due in the window has to return
(``failed_requests``, limit 0), and a sample of the returned images, drawn
from the seed, is restored again by the float32 reference
(``reference.restore``) from the same LQ and weights, with each request's
start noise drawn as the pipeline draws it for the batch the server
formed. Compared is the worst sampled image's share of pixels (of the
8-bit values of all three channels) that lie more than
``image_gap_levels`` from the reference's (``image_gap_share``).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..lib import flops, stats
from ..lib.tokenizer import stand_in_tokenizer
from ..lib.trace import KERNELS, SubWindow, Trace
from .common import (Context, checked, device_info, log, program_networks, reference_networks,
                     reference_precision, release, sizes_json)

POS_PROMPT = ("Cinematic, High Contrast, highly detailed, taken using a Canon EOS R camera, "
              "hyper detailed photo - realistic maximum detail, 32k, Color Grading, ultra HD, "
              "extreme meticulous detailing, skin pore detailing, hyper sharpness, perfect "
              "without deformations.")
NEG_PROMPT = ("painting, oil painting, illustration, drawing, art, sketch, anime, cartoon, "
              "CG Style, 3D render, unreal engine, blurring, bokeh, ugly, dirty, messy, "
              "worst quality, low quality, frames, watermark, signature, jpeg artifacts, "
              "deformed, lowres, over-smooth")


def lq_images(rng: np.random.Generator, n: int, side: int) -> np.ndarray:
    """n uint8 LQ images [n, side, side, 3]: a smooth random field (bilinear
    from an 8 x 8 grid) plus pixel noise."""
    coarse = rng.random((n, 3, 8, 8), dtype=np.float32)
    smooth = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=(side, side),
                                             mode="bilinear", align_corners=False).numpy()
    img = smooth.transpose(0, 2, 3, 1) * 200 + rng.normal(0, 12, (n, side, side, 3))
    return np.clip(img + 20, 0, 255).astype(np.uint8)


def _key(img: np.ndarray) -> bytes:
    return img[::29, ::31].tobytes()


class RecordingPipeline:
    """The pipeline behind the server: records each ``run`` call's requests
    (by their images), start and end, and in the traced run its stage
    times; profiles each of the calls ``profile_calls`` names in a
    sub-window of its own, with the port's launch counters around it.
    While ``warming`` it only passes calls through (and in the traced run
    pays the profiler's start-up in the server's own thread)."""

    def __init__(self, pipe, ids_of, traced: bool, profile_calls=range(0)):
        self.pipe, self.ids_of, self.traced = pipe, ids_of, traced
        self.profile_calls = profile_calls
        self.calls = []
        self.faults = {}
        self.warming = False

    def run(self, lq, **kw):
        if self.warming:
            if self.traced:
                SubWindow().warm()
            return self.pipe.run(lq, **kw)
        idx = len(self.calls)
        ids = [self.ids_of.get(_key(row)) for row in lq]
        sub = None
        if idx in self.profile_calls:
            sub, before = SubWindow(), _launches()
            sub.start()
        timings = {} if self.traced else None
        t0 = time.perf_counter()
        out = self.pipe.run(lq, timings=timings, **kw)
        if "answer" in self.faults:
            out = self.faults["answer"](out)
        t1 = time.perf_counter()
        call = {"ids": ids, "start": t0, "end": t1, "timings": timings, "sub": sub}
        if sub is not None:
            sub.stop()
            call["launches"] = {k: v - before[k] for k, v in _launches().items()}
        self.calls.append(call)
        return out


def _launches() -> dict:
    from diffbir_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.KERNEL_TC.launches}


def run(ctx: Context) -> dict:
    from diffbir_tpu_torch.pipeline import SwinIRPipeline
    from diffbir_tpu_torch.schedule import Schedule
    from diffbir_tpu_torch.serve import BatchingServer, upscale_image

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    rng = np.random.default_rng(ctx.seed)
    cldm, swinir = program_networks(cfg, dev, ctx.seed)
    cldm.eval()
    swinir.eval()
    if cfg["serving_mode"] != "default":
        cldm.set_mode(cfg["serving_mode"])
    tokenizer = stand_in_tokenizer(ctx.seed)
    pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), dev, min_cond_size=cfg["min_cond_size"],
                          tokenizer=tokenizer)
    n_req = max(1, round(tr["rate_per_s"] * ctx.seconds))
    side, up = tr["lq_side"], tr["upscale"]
    lq = lq_images(rng, n_req, side)
    arrivals = np.concatenate([[0.0], np.cumsum(stats.exponential_gaps(
        n_req, tr["rate_per_s"], rng.permutation(n_req)))[:-1]])
    # the requests' images as the server will see them (for the proxy's ids
    # and the reference; each request upscales its own in the window)
    upscaled = [upscale_image(img, up) for img in lq]
    ids_of = {_key(img): i for i, img in enumerate(upscaled)}
    n_prof, first_prof = tr["profiled_calls"], tr["profile_after_calls"]
    proxy = RecordingPipeline(pipe, ids_of, ctx.trace,
                              range(first_prof, first_prof + n_prof) if ctx.trace else range(0))
    proxy.faults = ctx.faults
    kw = dict(steps=tr["steps"], cfg_scale=tr["cfg_scale"], pos=POS_PROMPT, neg=NEG_PROMPT,
              sampler=tr["sampler"], seed=tr["request_seed"])
    run_kw = dict(steps=kw["steps"], cfg_scale=kw["cfg_scale"], pos_prompt=POS_PROMPT,
                  neg_prompt=NEG_PROMPT, sampler_type=kw["sampler"], seed=kw["seed"],
                  size_bucket=tr["size_bucket"])
    for b in range(1, tr["batch"] + 1):  # every batch the server can form
        pipe.run(np.stack(upscaled[:b]), **run_kw)
    server = BatchingServer(proxy, tr["batch"], tr["max_wait_ms"], tr["size_bucket"])
    proxy.warming = True  # one request through the server's own thread
    server.submit(upscaled[0], kw["steps"], kw["cfg_scale"], kw["pos"], kw["neg"], kw["sampler"],
                  kw["seed"])
    proxy.warming = False
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_process
    log(f"set-up {setup_s:.1f} s; {n_req} requests over {ctx.seconds} s")

    results = [None] * n_req
    started = [None] * n_req
    submitted = [None] * n_req

    def client(i: int, due: float) -> None:
        started[i] = time.perf_counter()
        try:
            img = upscale_image(lq[i], up)
            submitted[i] = time.perf_counter()
            out = server.submit(img, kw["steps"], kw["cfg_scale"], kw["pos"], kw["neg"],
                                kw["sampler"], kw["seed"])
            results[i] = (due, time.perf_counter(), out)
        except Exception as e:  # noqa: BLE001 - a failed request is counted, not raised
            results[i] = (due, None, e)

    threads = []
    t0 = time.perf_counter()
    for i in range(n_req):
        due = t0 + arrivals[i]
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=client, args=(i, due), daemon=True)
        th.start()
        threads.append(th)
    t_close = t0 + ctx.seconds
    time.sleep(max(0.0, t_close - time.perf_counter()))
    for th in threads:
        th.join(timeout=max(0.0, t_close + 60.0 - time.perf_counter()))
    t_wait_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    done = [r for r in results if r is not None and r[1] is not None]
    failed = n_req - len(done)
    # every request due in the window: one that never returned counts with its wait
    lat = [r[1] - r[0] if r is not None and r[1] is not None else t_wait_end - (t0 + a)
           for a, r in zip(arrivals, results)]
    log(f"{len(done)} of {n_req} returned, {failed} failed; {len(proxy.calls)} pipeline calls")
    server.stop()

    e2e = {"latency_p50_s": {"value": stats.percentile(lat, 50), "unit": "s"},
           "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
           "setup_s": {"value": setup_s, "unit": "s"}}
    readings = None
    t_steady = t_wait_end
    if ctx.trace:
        readings = _readings(ctx, proxy, t0)
        t_steady = readings["t_profiled"]
        readings.update(submitted=submitted, steady_latencies=[
            r[1] - r[0] for r in done if r[1] <= t_steady])
    late = [s - (t0 + a) for s, a in zip(started, arrivals) if s is not None and t0 + a < t_steady]
    late_ms = 1e3 * max(late, default=0.0)
    log(f"generator late by at most {late_ms:.1f} ms over {len(late)} requests")
    calls = proxy.calls
    del server, proxy, pipe, cldm, swinir
    release(dev)
    compared = [checked("failed_requests", failed, 0),
                checked("generator_late_ms", late_ms, tr["limit_generator_late_ms"])]
    if ctx.check:
        compared += _compare(ctx, rng, lq, results, calls)
    return {"attempted": n_req, "failed": failed, "e2e": e2e, "readings": readings,
            "latencies": [r[1] - r[0] if r is not None and r[1] is not None else None
                          for r in results],
            "backlog": sum(1 for r in results if r is None or r[1] is None or r[1] > t_close),
            "device": device_info(dev, peak), "compared": compared}


def _readings(ctx: Context, proxy: RecordingPipeline, t0: float) -> dict:
    """What the per-layer readers read: the trace of the profiled calls
    whose kernel records are whole (K1's launches as the shapes predict, as
    the profiler saw and as ``CudaKernel.launches`` counted: the profiler
    can drop records), and the steady part of the window before the first
    profiled call (the profiler's start and stop stall the host for
    seconds, so what follows it is left out): its calls, and the time
    spent inside them."""
    cfg, tr = ctx.config, ctx.traffic
    lat = tr["lq_side"] * tr["upscale"] // 8
    sites = flops.attention_sites(cfg["cldm"]["unet"], (lat, lat))
    per_image = [s for part in sites.values() for s in part]
    prof = [c for c in proxy.calls if c["sub"] is not None]
    if len(prof) != len(proxy.profile_calls):
        raise RuntimeError(f"the window ended before pipeline call {proxy.profile_calls.stop}:"
                           " no profiled sub-window")
    expected = tr["steps"] * len(per_image)
    whole, traces = [], []
    for c in prof:
        t = c["sub"].reduce()
        seen = len(t.kernel_us(KERNELS["K1"]))
        if seen == expected == c["launches"]["K1"]:
            whole.append(c)
            traces.append(t)
        else:
            log(f"a profiled call left out: K1 launches (profiler, shapes, counter) "
                f"{(seen, expected, c['launches']['K1'])}")
    t_prof = prof[0]["start"]
    steady = [c for c in proxy.calls if c["start"] >= t0 and c["end"] <= t_prof]
    per_flops = flops.serve_flops(sizes_json(cfg), lat * 8, tr["steps"])
    return {
        "steady_calls": steady, "steady_s": sum(c["end"] - c["start"] for c in steady),
        "t_profiled": t_prof,
        "trace": Trace.merge(traces), "denoiser_calls": tr["steps"] * len(whole),
        "k1_least_us": sum(flops.least_us(*flops.attn_fwd(2 * len(c["ids"]), s))
                           for c in whole for _ in range(tr["steps"]) for s in per_image),
        "k1_symbol": KERNELS["K1"],
        "steady_flops": per_flops * sum(len(c["ids"]) for c in steady),
    }


def _compare(ctx: Context, rng: np.random.Generator, lq: np.ndarray, results, calls) -> list:
    """The worst sampled request's mean absolute gap to the reference."""
    from ..reference.restore import pil_bicubic_upscale, restore_rows

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    where = {}
    for c in calls:
        for j, i in enumerate(c["ids"]):
            if i is not None:
                where[i] = (len(c["ids"]), j)
    returned = [i for i, r in enumerate(results) if r is not None and r[1] is not None
                and i in where]
    k = min(tr["checked_requests"], len(returned))
    sample = sorted(rng.choice(returned, size=k, replace=False).tolist()) if k else []
    if not sample:
        return [checked("returned_requests", 0, -1)]
    reference_precision()
    ref_cldm, ref_swinir = reference_networks(cfg, dev, ctx.seed)
    tok = stand_in_tokenizer(ctx.seed)
    pos, neg = (torch.as_tensor(tok([t]), device=dev) for t in (POS_PROMPT, NEG_PROMPT))
    lat = tr["lq_side"] * tr["upscale"] // 8
    gaps, shares = [], []
    for s in range(0, len(sample), tr["batch"]):
        rows = sample[s:s + tr["batch"]]
        x_T = []
        for i in rows:
            b, j = where[i]
            g = torch.Generator(device=dev).manual_seed(tr["request_seed"])
            x_T.append(torch.randn((b, lat, lat, 4), generator=g, device=dev)[j])
        lq_ref = np.stack([pil_bicubic_upscale(lq[i], tr["upscale"]) for i in rows])
        ref = restore_rows(ref_cldm, ref_swinir, lq_ref, pos, neg, torch.stack(x_T),
                           tr["steps"], tr["cfg_scale"])
        for i, r in zip(rows, ref.cpu().numpy()):
            d = np.abs(np.asarray(results[i][2]).astype(np.int32) - r.astype(np.int32))
            gaps.append((round(float(d.mean()), 4), int(d.max())))
            shares.append(float((d > tr["image_gap_levels"]).mean()))
    log(f"sampled requests {sample}: (mean, max) |gap| in levels {gaps}; share over "
        f"{tr['image_gap_levels']} levels {shares}")
    return [checked("image_gap_share", max(shares), tr["limit_image_gap_share"])]

