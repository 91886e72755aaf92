"""Request-batching HTTP server over the port's pipelines.

    python -m diffbir_tpu_torch.serve [--port 8000] [--batch 4] [--max_wait_ms 150]
        [--size_bucket 64] [--upscale 4] [--steps 10] [--tasks sr,face] [--device cuda]

Counterpart of the JAX repository's ``serve.py``:

- a collector groups up to ``--batch`` requests of one key that arrive
  within ``--max_wait_ms``; the key holds the task, the padded shape, the
  steps, CFG, prompts, sampler and seed, so that a request shares a batch
  (and its noise stream) only with requests that ask for the same;
- each image is edge-padded to multiples of ``--size_bucket`` before it is
  queued, so sizes of one bucket share a batch, and its output is cropped
  back to its own size;
- one dispatcher thread runs the batches back to back on the card; an error
  reaches every request of its batch; ``stop`` ends it;
- spans (``utils.spans``): ``server.queue`` per request (its ``put`` until
  the collector takes it into a batch), ``server.collect`` per batch (the
  first request taken until the batch closes; ``waited_ms`` past the last
  member's arrival) and ``server.run`` (the pipeline call, parent of its
  stage and model-call spans), each with the batch's request ids;
- ``POST /restore`` {"image": <base64 PNG>, "task", "steps", "cfg_scale",
  "pos_prompt", "neg_prompt", "seed", "sampler"} -> {"image": <base64
  PNG>}; ``GET /healthz`` -> {"ok": true, "queue": N}.

Differences from JAX: images are PNG only (``utils.image_io``; another
format is refused, naming it); the input is upscaled by Pillow's bicubic
bit for bit (``pil_bicubic_resize``); the serving modes are set on the
loaded model (``--fast_gelu``, ``--fused_ffn``, ``--quant_dense`` reach
``ControlLDM.set_serving`` through the loops, as the CLI's flags do), not
by environment variables read at trace time; ``--device`` is "cuda" (the
default) or "cpu". Where the face weights are absent, the face task is
left out with a message and sr is served alone, as in JAX; with no task
left it raises.
"""

from __future__ import annotations

import argparse
import base64
import itertools
import json
import queue
import threading
import time
from argparse import Namespace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .inference.__main__ import build_parser as cli_parser
from .utils import spans
from .utils.common import pil_bicubic_resize
from .utils.image_io import decode_png, encode_png, to_rgb

MAX_SIZE = 2048  # the demo's output cap (run_gradio.MAX_SIZE)


class _Request:
    __slots__ = ("image", "key", "seed", "event", "result", "error", "id", "t_put")

    def __init__(self, image: np.ndarray, key: tuple, seed: int, rid: int):
        self.image = image          # uint8 HWC, upscaled and padded to the bucket
        self.key = key              # the batchable parameters
        self.seed = seed
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.id = rid               # the request's id in its spans
        self.t_put = 0              # perf_counter_ns of its first put


class BatchingServer:
    def __init__(self, pipeline, batch: int, max_wait_ms: float, size_bucket: int = 64,
                 max_size: int = MAX_SIZE):
        # a pipeline (served as "sr") or a {task: pipeline} dict
        self.pipelines = pipeline if isinstance(pipeline, dict) else {"sr": pipeline}
        self.batch = batch
        self.max_wait = max_wait_ms / 1000.0
        self.size_bucket = size_bucket
        self.max_size = max_size
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self._ids = itertools.count()
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, steps, cfg_scale, pos, neg, sampler, seed,
               task: str = "sr") -> np.ndarray:
        """One request (blocks until its batch has run): the restored image
        at ``image``'s size."""
        if task not in self.pipelines:
            raise ValueError(f"task {task!r} unavailable (serving: {sorted(self.pipelines)})")
        if max(image.shape[:2]) > self.max_size:
            raise ValueError(f"input larger than {self.max_size} not allowed")
        h0, w0 = image.shape[:2]
        b = self.size_bucket
        ph, pw = (-h0) % b, (-w0) % b
        if ph or pw:
            image = np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge")
        key = (str(task), image.shape[0], image.shape[1], int(steps), float(cfg_scale),
               str(pos), str(neg), str(sampler), int(seed))
        req = _Request(image, key, int(seed), next(self._ids))
        req.t_put = time.perf_counter_ns()
        self.q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result[:h0, :w0]

    def stop(self) -> None:
        """End the dispatcher once the requests queued before this call have
        run (its thread holds the pipelines until then)."""
        self.q.put(None)
        self._thread.join()

    def _collect(self):
        """Block for one request, then gather requests of its key for up to
        max_wait or until the batch is full; others go back to the queue.
        None once ``stop`` is reached."""
        first = self.q.get()
        if first is None:
            return None
        t_first = time.perf_counter_ns()
        spans.record("server.queue", first.t_put, t_first, requests=(first.id,))
        group, leftover = [first], []
        deadline = time.time() + self.max_wait
        while len(group) < self.batch:
            timeout = deadline - time.time()
            if timeout <= 0:
                break
            try:
                r = self.q.get(timeout=timeout)
            except queue.Empty:
                break
            if r is None:  # stop: after this group
                leftover.append(r)
                break
            if r.key == first.key:
                group.append(r)
                spans.record("server.queue", r.t_put, time.perf_counter_ns(), requests=(r.id,))
            else:
                leftover.append(r)
        for r in leftover:
            self.q.put(r)
        t_close = time.perf_counter_ns()
        spans.record("server.collect", t_first, t_close, requests=[r.id for r in group],
                     waited_ms=(t_close - max(r.t_put for r in group)) / 1e6)
        return group

    def _dispatch(self):
        while True:
            group = self._collect()
            if group is None:
                return
            try:
                task, _, _, steps, cfg, pos, neg, sampler, _ = group[0].key
                with spans.span("server.run", requests=[r.id for r in group]):
                    out = self.pipelines[task].run(
                        np.stack([r.image for r in group]), steps=steps, cfg_scale=cfg,
                        pos_prompt=pos, neg_prompt=neg, sampler_type=sampler,
                        seed=group[0].seed, size_bucket=self.size_bucket)
                for i, r in enumerate(group):
                    r.result = out[i]
            except Exception as e:  # noqa: BLE001 - every waiter gets the error
                for r in group:
                    r.error = e
            finally:
                for r in group:
                    r.event.set()


def upscale_image(img: np.ndarray, upscale: float) -> np.ndarray:
    """Pillow's bicubic resize by ``upscale`` (the JAX front ends'; a copy
    where the size stays, as Pillow's)."""
    h, w = img.shape[:2]
    size = (int(h * upscale), int(w * upscale))
    if size == (h, w):
        return img.copy()
    return pil_bicubic_resize(torch.from_numpy(np.ascontiguousarray(img)), size).numpy()


def decode_request_image(b64: str) -> np.ndarray:
    """A request's base64 PNG as uint8 RGB."""
    return to_rgb(decode_png(base64.b64decode(b64), "the request's image"))


def json_reply(handler: BaseHTTPRequestHandler, obj) -> None:
    body = json.dumps(obj).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "application/json")
    handler.end_headers()
    handler.wfile.write(body)


def make_handler(server: BatchingServer, upscale: float):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            json_reply(self, {"ok": True, "queue": server.q.qsize()})

        def do_POST(self):
            if self.path != "/restore":
                self.send_error(404)
                return
            try:
                req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                img = upscale_image(decode_request_image(req["image"]), upscale)
                out = server.submit(
                    img, task=req.get("task", "sr"), steps=req.get("steps", 10),
                    cfg_scale=req.get("cfg_scale", 6.0), pos=req.get("pos_prompt", ""),
                    neg=req.get("neg_prompt", ""), sampler=req.get("sampler", "edm_dpm++_3m_sde"),
                    seed=req.get("seed", 231))
                json_reply(self, {"image": base64.b64encode(encode_png(np.asarray(out))).decode()})
            except Exception as e:  # noqa: BLE001 - the client gets the message
                self.send_error(500, str(e))

    return Handler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m diffbir_tpu_torch.serve")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max_wait_ms", type=float, default=150.0)
    ap.add_argument("--size_bucket", type=int, default=64)
    ap.add_argument("--upscale", type=float, default=4.0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--precision", default="bf16", choices=["fp32", "fp16", "bf16"])
    ap.add_argument("--fast_gelu", action="store_true",
                    help="the tanh GELU in every unfused GEGLU (ControlLDM.set_serving)")
    ap.add_argument("--fused_ffn", action="store_true",
                    help="each transformer FFN as one fused GEGLU kernel (K7)")
    ap.add_argument("--quant_dense", action="store_true",
                    help="int8 weight-only UNet/ControlNet dense sites (K4)")
    ap.add_argument("--tasks", default="sr", help="comma list: sr,face")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def loop_args(args: Namespace, task: str, **overrides) -> Namespace:
    """The CLI's arguments for a v2.1 ``task`` loop with the server's
    precision, steps, upscale, serving modes and device (the CLI's defaults
    otherwise; the default prompts are the CLI's)."""
    a = cli_parser().parse_args(["--task", task, "--input", ".", "--output", "."])
    for k in ("precision", "steps", "upscale", "fast_gelu", "fused_ffn", "quant_dense",
              "device"):
        if hasattr(args, k):
            setattr(a, k, getattr(args, k))
    for k, v in overrides.items():
        setattr(a, k, v)
    return a


def build_pipelines(args: Namespace, tasks: Sequence[str]) -> Dict[str, object]:
    """{task: pipeline} of the v2.1 loops: sr (``BSRInferenceLoop``) and face
    (``BFRInferenceLoop``; left out, with a message, where its weights are
    absent, as in JAX). RuntimeError when none loads."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    from .inference import BFRInferenceLoop, BSRInferenceLoop

    unknown = [t for t in tasks if t not in ("sr", "face")]
    if unknown:
        raise ValueError(f"unknown --tasks entries {unknown}; valid: sr, face")
    pipelines = {}
    if "sr" in tasks:
        pipelines["sr"] = BSRInferenceLoop(loop_args(args, "sr")).pipeline
    if "face" in tasks:
        try:
            pipelines["face"] = BFRInferenceLoop(loop_args(args, "face")).pipeline
        except FileNotFoundError as e:  # the face weights are absent: sr alone
            print(f"face pipeline unavailable ({e})")
    if not pipelines:
        raise RuntimeError("no task pipeline could be loaded")
    return pipelines


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    tasks = [t.strip() for t in args.tasks.split(",") if t.strip()]
    srv = BatchingServer(build_pipelines(args, tasks), args.batch, args.max_wait_ms,
                         args.size_bucket)
    print(f"serving {sorted(srv.pipelines)} on :{args.port} (batch {args.batch}, wait "
          f"{args.max_wait_ms} ms, bucket {args.size_bucket}px, {args.device})")
    ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(srv, args.upscale)).serve_forever()


if __name__ == "__main__":
    main()
