"""The port's serving front ends on the CPU: ``diffbir_tpu_torch.serve``'s
request-batching server and ``diffbir_tpu_torch.run_gradio``'s runner.

- ``BatchingServer`` through the behaviours ``tests/test_serve.py`` holds
  the JAX ``serve.py`` to, on the same stub pipeline: same-key requests
  batch together; different shapes never share a batch; sizes of one
  bucket do, cropped back to their own; oversize inputs are refused; the
  HTTP round trip (``POST /restore``, ``GET /healthz``); seeds never share
  a batch; tasks route, an unknown one raises naming it; an error reaches
  every waiter of its batch, and ``stop`` ends the dispatcher; a JPEG body is refused, naming the format;
- one tiny real port pipeline (``IdentityCleanerPipeline`` on a random
  ``ControlLDM.tiny``, 2 steps) behind the handler at ``--upscale 4``: the
  response bit-equal to ``pipeline.run`` of the same request;
- ``decode_png``/``encode_png`` equal to ``read_png``/``write_png`` on the
  same image; other formats raise, naming them;
- ``build_pipelines``: the face task left out where its weights are absent,
  RuntimeError with no task, and no card without ``--device cpu``;
- the port's ``process`` and the JAX ``run_gradio.process`` route the same
  knobs into ``pipeline.run`` (recorder pipelines in both; the same
  upscaled image, keywords and guidance), and the port's ``_Handler``
  ignores unknown keys.
"""

import base64
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from argparse import Namespace
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import run_gradio as jax_run_gradio  # noqa: E402
from diffbir_tpu.inference import bfr_loop as jax_bfr_loop  # noqa: E402
from diffbir_tpu.inference import bsr_loop as jax_bsr_loop  # noqa: E402
from diffbir_tpu.utils import jax_cache  # noqa: E402

from diffbir_tpu_torch import inference as port_inference  # noqa: E402
from diffbir_tpu_torch import run_gradio, serve  # noqa: E402
from diffbir_tpu_torch.models.cldm import ControlLDM  # noqa: E402
from diffbir_tpu_torch.models.layers import random_init_  # noqa: E402
from diffbir_tpu_torch.pipeline import IdentityCleanerPipeline  # noqa: E402
from diffbir_tpu_torch.schedule import Schedule  # noqa: E402
from diffbir_tpu_torch.utils.common import pil_bicubic_resize  # noqa: E402
from diffbir_tpu_torch.utils.image_io import (decode_png, encode_png, read_png,  # noqa: E402
                                              write_png)


class StubPipeline:
    """Records the batch size of every run() call; echoes its inputs."""

    def __init__(self, delay=0.0):
        self.batches, self.seeds = [], []
        self.delay = delay
        self.lock = threading.Lock()

    def run(self, imgs, **kw):
        with self.lock:
            self.batches.append(len(imgs))
            self.seeds.append((len(imgs), kw["seed"]))
        time.sleep(self.delay)
        return np.asarray(imgs)


def submit_async(srv, img, **kw):
    out = {}

    def go():
        try:
            out["result"] = srv.submit(img, steps=kw.get("steps", 4), cfg_scale=2.0, pos="",
                                       neg="", sampler="spaced", seed=kw.get("seed", 1))
        except Exception as e:  # noqa: BLE001
            out["error"] = e

    t = threading.Thread(target=go)
    t.start()
    return t, out


def join(jobs):
    for t, _ in jobs:
        t.join(timeout=30)


def test_same_key_requests_batch_together():
    pipe = StubPipeline(delay=0.05)
    srv = serve.BatchingServer(pipe, batch=4, max_wait_ms=250)
    jobs = [submit_async(srv, np.zeros((32, 32, 3), np.uint8)) for _ in range(4)]
    join(jobs)
    assert all(o["result"].shape == (32, 32, 3) for _, o in jobs)
    assert max(pipe.batches) >= 2 and sum(pipe.batches) == 4


def test_different_shapes_never_share_a_batch():
    pipe = StubPipeline()
    srv = serve.BatchingServer(pipe, batch=4, max_wait_ms=100, size_bucket=16)
    a, b = np.zeros((32, 32, 3), np.uint8), np.zeros((48, 32, 3), np.uint8)
    jobs = [submit_async(srv, x) for x in (a, b, a, b)]
    join(jobs)
    assert jobs[0][1]["result"].shape == (32, 32, 3)
    assert jobs[1][1]["result"].shape == (48, 32, 3)
    assert sum(pipe.batches) == 4


def test_same_bucket_different_sizes_batch_together():
    pipe = StubPipeline(delay=0.05)
    srv = serve.BatchingServer(pipe, batch=2, max_wait_ms=500, size_bucket=32)
    a, b = np.full((30, 30, 3), 7, np.uint8), np.full((25, 32, 3), 9, np.uint8)
    ja, jb = submit_async(srv, a), submit_async(srv, b)
    join([ja, jb])
    np.testing.assert_array_equal(ja[1]["result"], a)
    np.testing.assert_array_equal(jb[1]["result"], b)
    assert 2 in pipe.batches


def test_oversize_rejected():
    srv = serve.BatchingServer(StubPipeline(), batch=1, max_wait_ms=10, max_size=64)
    with pytest.raises(ValueError, match="larger than 64"):
        srv.submit(np.zeros((128, 128, 3), np.uint8), steps=1, cfg_scale=1.0, pos="", neg="",
                   sampler="spaced", seed=0)


def test_different_seeds_never_share_a_batch():
    pipe = StubPipeline(delay=0.05)
    srv = serve.BatchingServer(pipe, batch=4, max_wait_ms=250)
    jobs = [submit_async(srv, np.zeros((32, 32, 3), np.uint8), seed=s) for s in (1, 1, 2, 2)]
    join(jobs)
    assert sorted(set(s for _, s in pipe.seeds)) == [1, 2]
    assert sum(n for n, _ in pipe.seeds) == 4 and len(pipe.seeds) >= 2


def test_task_routing_and_unavailable_task():
    sr, face = StubPipeline(), StubPipeline()
    srv = serve.BatchingServer({"sr": sr, "face": face}, batch=2, max_wait_ms=30)
    img = (np.random.default_rng(0).random((64, 64, 3)) * 255).astype(np.uint8)
    kw = dict(steps=2, cfg_scale=1.0, pos="", neg="", sampler="spaced", seed=1)
    assert srv.submit(img, task="face", **kw).shape == (64, 64, 3)
    assert (len(sr.batches), len(face.batches)) == (0, 1)
    srv = serve.BatchingServer({"sr": sr}, batch=2, max_wait_ms=30)
    with pytest.raises(ValueError, match="face"):
        srv.submit(img, task="face", **kw)


def test_an_error_reaches_every_waiter():
    class Failing(StubPipeline):
        def run(self, imgs, **kw):
            super().run(imgs, **kw)
            raise RuntimeError("the card fell over")

    pipe = Failing(delay=0.05)
    srv = serve.BatchingServer(pipe, batch=3, max_wait_ms=300)
    jobs = [submit_async(srv, np.zeros((16, 16, 3), np.uint8)) for _ in range(3)]
    join(jobs)
    assert all("the card fell over" in str(o["error"]) for _, o in jobs)
    srv.stop()
    assert not srv._thread.is_alive()


def post(port, payload, path="/restore"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.fixture
def http():
    """Start a handler on an ephemeral port: http(handler) -> port."""
    servers = []

    def start(handler):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
        return httpd.server_address[1]

    yield start
    for httpd in servers:
        httpd.shutdown()
        httpd.server_close()


def b64png(img):
    return base64.b64encode(encode_png(img)).decode()


def test_png_bytes_equal_the_files(tmp_path):
    """``decode_png``/``encode_png`` against ``read_png``/``write_png``."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    data = encode_png(img)
    assert data == (tmp_path / "a.png").read_bytes()
    np.testing.assert_array_equal(decode_png(data), read_png(str(tmp_path / "a.png")))
    np.testing.assert_array_equal(decode_png(data), img)
    for magic, name in ((b"\xff\xd8\xff", "JPEG"), (b"GIF89a", "GIF"), (b"RIFF", "WebP"),
                        (b"xyz", "unknown")):
        with pytest.raises(ValueError, match=name):
            decode_png(magic + bytes(16))
    with pytest.raises(ValueError, match="uint8"):
        encode_png(img.astype(np.float32))


def test_http_round_trip(http):
    srv = serve.BatchingServer(StubPipeline(), batch=2, max_wait_ms=20)
    port = http(serve.make_handler(srv, 1.0))
    img = np.random.default_rng(0).integers(0, 255, (16, 16, 3), dtype=np.uint8)
    out = post(port, {"image": b64png(img), "steps": 2})
    np.testing.assert_array_equal(decode_png(base64.b64decode(out["image"])), img)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
        assert json.loads(resp.read()) == {"ok": True, "queue": 0}
    jpeg = base64.b64encode(b"\xff\xd8\xff\xe0" + bytes(64)).decode()
    with pytest.raises(urllib.error.HTTPError) as e:
        post(port, {"image": jpeg})
    assert e.value.code == 500 and "JPEG" in e.value.read().decode()


def test_a_real_pipeline_through_http_equals_pipeline_run(http):
    cldm = random_init_(ControlLDM.tiny(), torch.Generator().manual_seed(0)).eval()
    pipe = IdentityCleanerPipeline(cldm, Schedule.v21(), "cpu", min_cond_size=64)
    srv = serve.BatchingServer(pipe, batch=2, max_wait_ms=20)
    port = http(serve.make_handler(srv, 4.0))
    img = np.random.default_rng(1).integers(0, 256, (16, 14, 3), dtype=np.uint8)
    req = dict(steps=2, cfg_scale=3.0, seed=5, sampler="edm_dpm++_3m_sde")
    out = decode_png(base64.b64decode(post(port, {"image": b64png(img), **req})["image"]))
    up = pil_bicubic_resize(torch.from_numpy(img), (64, 56)).numpy()
    ref = pipe.run(np.pad(up, ((0, 0), (0, 8), (0, 0)), mode="edge")[None], steps=2,
                   cfg_scale=3.0, pos_prompt="", neg_prompt="", sampler_type="edm_dpm++_3m_sde",
                   seed=5, size_bucket=64)[0][:64, :56]
    assert out.shape == (64, 56, 3) and out.std() > 1.0
    np.testing.assert_array_equal(out, ref)


class FakeLoop:
    """A loop class whose pipeline records; ``absent`` raises as a loop
    without its weights does."""

    absent = False

    def __init__(self, args):
        if self.absent:
            raise FileNotFoundError("weights file face_swinir_v1.ckpt not found")
        self.args = args
        self.pipeline = Recorder()


def recording_loop(made, key):
    """A FakeLoop class that files its recorder under ``made[key]``."""
    class Loop(FakeLoop):
        def __init__(self, args):
            super().__init__(args)
            made[key] = self.pipeline

    return Loop


class Recorder:
    def __init__(self):
        self.calls, self.cond_fn = [], None

    def run(self, batch, **kw):
        guide = self.cond_fn
        self.calls.append((np.array(batch), kw, None if guide is None else (
            type(guide).__name__, guide.scale, guide.t_start, guide.t_stop, guide.space,
            guide.repeat)))
        return np.asarray(batch)


def test_build_pipelines_leaves_out_an_absent_face_task(monkeypatch, capsys):
    absent = type("Absent", (FakeLoop,), {"absent": True})
    monkeypatch.setattr(port_inference, "BSRInferenceLoop", FakeLoop)
    monkeypatch.setattr(port_inference, "BFRInferenceLoop", absent)
    args = serve.build_parser().parse_args(["--device", "cpu", "--fast_gelu", "--upscale", "2"])
    pipes = serve.build_pipelines(args, ["sr", "face"])
    assert list(pipes) == ["sr"] and "face pipeline unavailable" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no task pipeline"):
        serve.build_pipelines(args, ["face"])
    a = serve.loop_args(args, "sr")
    assert (a.fast_gelu, a.fused_ffn, a.upscale, a.version, a.device) == (
        True, False, 2.0, "v2.1", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.build_pipelines(serve.build_parser().parse_args([]), ["sr"])


KNOBS = dict(task="face", upscale=2, steps=3, cfg_scale=4.5, pos_prompt="a", neg_prompt="b",
             seed=7, sampler="edm_heun", strength=0.8, noise_aug=10, rescale_cfg=True,
             start_point_type="cond", cleaner_tiled=True, cleaner_tile_size=256,
             cleaner_tile_stride=128, vae_encoder_tiled=True, vae_encoder_tile_size=128,
             vae_decoder_tiled=True, vae_decoder_tile_size=192, cldm_tiled=True,
             cldm_tile_size=256, cldm_tile_stride=192, guidance=True, g_loss="mse", g_scale=0.5,
             g_space="rgb", g_start=900, g_stop=100, g_repeat=2, s_churn=1.0, s_tmin=0.1,
             s_tmax=200.0, s_noise=1.01, order=2, eta=0.5)


def test_process_routes_the_knobs_as_jax_does(monkeypatch, http):
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda *a: None)
    made = {}  # (package, task) -> its loop's recorder
    for pkg, mod, name, task in (("jax", jax_bsr_loop, "BSRInferenceLoop", "sr"),
                                 ("jax", jax_bfr_loop, "BFRInferenceLoop", "face"),
                                 ("port", port_inference, "BSRInferenceLoop", "sr"),
                                 ("port", port_inference, "BFRInferenceLoop", "face")):
        monkeypatch.setattr(mod, name, recording_loop(made, (pkg, task)))
    args = Namespace(upscale=4.0, steps=10, precision="bf16", version="v2.1", tasks="sr,face",
                     device="cpu")
    img = np.random.default_rng(2).integers(0, 256, (21, 17, 3), dtype=np.uint8)
    process, jax_process = run_gradio.build_runner(args), jax_run_gradio.build_runner(args)
    assert process.tasks == jax_process.tasks == ["sr", "face"]
    for knobs in ({}, KNOBS):
        np.testing.assert_array_equal(process(img, **knobs), jax_process(img, **knobs))
    for task in ("sr", "face"):
        ours, theirs = made["port", task].calls, made["jax", task].calls
        assert len(ours) == len(theirs) == 1
        for (a, kw_a, g_a), (b, kw_b, g_b) in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
            assert kw_a == kw_b and g_a == g_b
    guide = made["port", "face"].calls[0][2]
    assert guide[0] == "MSEGuidance" and guide[2:] == (900, 100, "rgb", 2)
    with pytest.raises(ValueError, match="2048"):
        process(img, upscale=100)
    run_gradio._Handler.process = staticmethod(process)
    port = http(run_gradio._Handler)
    out = post(port, {"image": b64png(img), "upscale": 1, "not_a_knob": 3})
    np.testing.assert_array_equal(decode_png(base64.b64decode(out["image"])), img)
