"""``--task unaligned_face`` through the port's CLI against the JAX loop, on
the CPU at tiny sizes.

``python -m diffbir_tpu_torch.inference --task unaligned_face --device cpu
--precision fp32`` runs in process on a 32x32 PNG at ``--upscale 2`` (1
step of the CLI's sampler: a 512x512 face request costs ~2.4 s a step of
the tiny UNet on two CPU threads) with the tiny random models of
``tests/test_torch_tasks.py`` (the face SwinIR, the background SwinIR or
BSRNet, ``ControlLDM.tiny``) and, in both packages, a stub ``detect_faces``
installed by monkeypatching (the port's ``load_detector``, the JAX
``load_jax_detector``) that finds faces placed by the image's size; no
parser file, so both paste with the box mask. The JAX
``UnAlignedBFRInferenceLoop`` then runs on the same input with JAX
pipelines on the port loop's own weights (converted by the JAX
``fill_flax_params``), and the port's pipelines run on JAX's draws. Held,
for v2.1 (two faces, two samples: each background sample pasted with the
faces of its index) and v2 (one face; BSRNet on the original LQ):

- the same files in the output folder and in ``cropped_faces/``,
  ``restored_faces/`` and ``restored_backgrounds/``, and the same
  ``prompt.csv`` rows;
- the crops within 1 uint8 level of JAX's (a few values in a million, where
  OpenCV's fp32 warp rounds a .5 the other way) and each restored face and
  background, and each merged PNG, within 1 level.
"""

import csv
import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffbir_tpu.inference.unaligned_bfr_loop import (
    UnAlignedBFRInferenceLoop as JaxUnAlignedLoop)
from diffbir_tpu.models.cldm import ControlLDM as JaxControlLDM
from diffbir_tpu.pipeline import BSRNetPipeline as JaxBSRNetPipeline
from diffbir_tpu.pipeline import SwinIRPipeline as JaxSwinIRPipeline
from diffbir_tpu.utils import face as jface

from diffbir_tpu_torch import pipeline as port_pipeline
from diffbir_tpu_torch.inference import unaligned_bfr_loop as ua
from diffbir_tpu_torch.inference.__main__ import main
from diffbir_tpu_torch.models.bsrnet import RRDBNet
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.utils.face import FFHQ_TEMPLATE_512, FaceRestoreHelper
from diffbir_tpu_torch.utils.image_io import read_png
from tests.test_torch_loop import _jax_weights
from tests.test_torch_pipeline import jax_noise
from tests.test_torch_tasks import (EPS, RRDB_KW, SWIN_KW, TINY, _cli, _schedule, _tiny,  # noqa: F401
                                    tiny)


class StubDetector:
    """``faces`` (1 or 2) faces placed by the image's size, in facexlib's
    [N, 15] layout."""

    def __init__(self, faces: int = 2):
        self.faces = faces

    def detect_faces(self, img_bgr, conf_threshold=0.8):
        h, w = img_bgr.shape[:2]
        rows = []
        for cx, cy, a, s in ((0.3 * w, 0.35 * h, 0.2, 0.3),
                             (0.68 * w, 0.6 * h, -0.1, 0.4))[:self.faces]:
            rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) * s * w / 512
            lm = (FFHQ_TEMPLATE_512 - 256) @ rot.T + [cx, cy]
            x1, y1 = lm.min(0) - 40
            x2, y2 = lm.max(0) + 40
            rows.append([x1, y1, x2, y2, 0.99, *lm.ravel()])
        return np.asarray(rows, np.float32)


def install(monkeypatch, faces: int) -> None:
    """The stub detector of ``faces`` faces in both packages."""
    monkeypatch.setattr(ua, "load_detector", lambda device: StubDetector(faces))
    monkeypatch.setattr(jface, "load_jax_detector", lambda: StubDetector(faces))


@pytest.fixture
def unaligned(tiny, monkeypatch):  # noqa: F811
    monkeypatch.setattr(ua, "SwinIR", _tiny(SwinIR, SWIN_KW))
    monkeypatch.setattr(ua, "RRDBNet", _tiny(RRDBNet, RRDB_KW))
    install(monkeypatch, 2)
    monkeypatch.setenv("DIFFBIR_TPU_WEIGHTS", str(tiny / "weights"))  # no parser file
    run = port_pipeline.Pipeline.run

    def on_jax_draws(self, lq, **kw):
        """JAX's draws for the request: faces a 64x64 latent, the
        background an 8x8 one."""
        latent = 64 if lq.shape[1] == 512 else 8
        x_T, noise = jax_noise(kw["seed"], (len(lq), latent, latent, 4), kw["steps"])
        return run(self, lq, x_T=x_T, noise_table=noise, **kw)

    monkeypatch.setattr(port_pipeline.Pipeline, "run", on_jax_draws)
    return tiny


def jax_loop(loop, out_dir):
    """The JAX loop on the port loop's arguments and weights (its pipelines
    JAX's, built on the converted tiny models)."""
    v2 = loop.args.version == "v2"
    jc = JaxControlLDM.tiny()
    shapes = jc.eval_shapes((8, 8))
    params = {n: _jax_weights(shapes[n], getattr(loop.cldm, n)) for n in shapes}

    def cleaner(kind, module):
        _, jax_cls, kw = TINY[kind]
        jm = jax_cls(**kw)
        p = _jax_weights(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 64, 64, 3))), module)
        return jax.jit(lambda x: jnp.clip(jm.apply(p, x), 0.0, 1.0))

    common = dict(cldm=jc, params=params,
                  schedule=_schedule(*(EPS if v2 else ("v", True))),
                  tokenizer=loop.pipeline.tokenizer, min_cond_size=64)
    face_pipe = JaxSwinIRPipeline(cleaner("swinir", loop.face_cleaner), **common)
    bg_pipe = (JaxBSRNetPipeline(cleaner("bsrnet", loop.bg_cleaner), upscale=loop.args.upscale,
                                 **common) if v2
               else JaxSwinIRPipeline(cleaner("swinir", loop.bg_cleaner), **common))
    jl = JaxUnAlignedLoop.__new__(JaxUnAlignedLoop)
    jl.args = Namespace(**{**vars(loop.args), "output": out_dir})
    jl.loop_ctx, jl.captioner = {}, lambda lq: ""
    jl.pipeline_dict = {"face": face_pipe, "background": bg_pipe}
    jl.pipeline = face_pipe
    jl.run()


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def rows(root):
    with open(os.path.join(root, "prompt.csv"), newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("version,faces,samples", [("v2.1", 2, 2), ("v2", 1, 1)])
def test_unaligned_face_matches_the_jax_loop(unaligned, monkeypatch, version, faces, samples):
    install(monkeypatch, faces)
    loop = main(_cli(unaligned, "unaligned_face", "--precision", "fp32", "--version", version,
                     "--n_samples", str(samples), "--steps", "1"))
    assert isinstance(loop, ua.UnAlignedBFRInferenceLoop)
    assert isinstance(loop.bg_cleaner, RRDBNet if version == "v2" else SwinIR)
    assert isinstance(loop.face_cleaner, SwinIR) and loop.face_parser is None
    assert {"detect_align", "paste"} <= set(loop.timings)
    out, ref = str(unaligned / "out"), str(unaligned / "jax_out")
    jax_loop(loop, ref)
    names = files(out)
    assert names == files(ref)
    stems = ["lq"] if samples == 1 else ["lq_0", "lq_1"]
    assert [n for n in names if "/" not in n] == sorted(["prompt.csv"] + [
        s + ".png" for s in stems])
    assert sum(n.startswith("cropped_faces/") for n in names) == faces
    assert sum(n.startswith("restored_faces/") for n in names) == faces * samples
    assert rows(out) == rows(ref)
    for name in names:
        if not name.endswith(".png"):
            continue
        a, b = read_png(os.path.join(out, name)), read_png(os.path.join(ref, name))
        assert a.shape == b.shape, name
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
        if name.startswith("cropped_faces/"):
            assert a.shape == (512, 512, 3)
            assert (a != b).mean() < 1e-4, name
    merged = read_png(os.path.join(out, stems[0] + ".png"))
    assert merged.shape == (512, 512, 3) and merged.std() > 1.0
    bg = read_png(os.path.join(out, "restored_backgrounds", "lq_0.png"))
    assert bg.shape == (64, 64, 3)


def test_the_face_helper_hook(unaligned, monkeypatch):
    """``face_helper`` is where a caller hands in landmarks: one face here."""
    seen = []

    def one_face(img):
        seen.append(img.shape)
        return StubDetector().detect_faces(img)[:1, 5:].reshape(1, 5, 2)

    monkeypatch.setattr(ua.UnAlignedBFRInferenceLoop, "face_helper", lambda self: FaceRestoreHelper(
        landmarks_fn=one_face, face_parser=self.face_parser, device=self.device))
    main(_cli(unaligned, "unaligned_face", "--precision", "fp32"))
    assert seen == [(640, 640, 3)]
    crops = [n for n in files(str(unaligned / "out")) if n.startswith("cropped_faces/")]
    assert crops == ["cropped_faces/lq_face0.png"]
    assert read_png(str(unaligned / "out" / "lq.png")).shape == (512, 512, 3)
