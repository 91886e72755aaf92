"""The port's other tasks and versions through its CLI, on the CPU at tiny
sizes, against the JAX package.

``python -m diffbir_tpu_torch.inference --device cpu --precision fp32`` runs
in process at 2 steps of the CLI's sampler on a 32x32 PNG, with tiny
random-init models swapped in for the full-size ones (``ControlLDM.sd21``
-> ``tiny``; SwinIR, BSRNet and SCUNet -> small configs; the minimum
condition 64 pixels) and JAX's draws handed to the port's ``pipeline.run``:

- ``--task denoise`` at v1 (SwinIR) and v2 (SCUNet), ``--task face`` at v1
  (the face SwinIR), ``--task sr --version v2`` (BSRNet, x4, resized to
  lq x ``--upscale``) and ``--version custom`` (a train config's SwinIR
  and schedule, the SD base and ControlNet read from files the test
  writes in bf16): each PNG within 1 uint8 level of the JAX pipeline of
  that task (``SwinIRPipeline``, ``SCUNetPipeline``, ``BSRNetPipeline``)
  on the loop's own weights (converted by the JAX ``fill_flax_params``),
  the version's schedule and JAX's draws;
- the version and task matrix of the checkpoints: every cleaner and the
  v1/v2/v2.1 ControlNets and SD bases by name, a KAIR-layout cleaner
  checkpoint loaded strictly;
- ``--task unaligned_face`` without the detector's weights (naming the
  file) and at v1, and an orbax directory as ``--ckpt``, raise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbir_tpu.models.bsrnet import RRDBNet as JaxRRDBNet
from diffbir_tpu.models.cldm import ControlLDM as JaxControlLDM
from diffbir_tpu.models.scunet import SCUNet as JaxSCUNet
from diffbir_tpu.models.swinir import SwinIR as JaxSwinIR
from diffbir_tpu.pipeline import BSRNetPipeline as JaxBSRNetPipeline
from diffbir_tpu.pipeline import SCUNetPipeline as JaxSCUNetPipeline
from diffbir_tpu.pipeline import SwinIRPipeline as JaxSwinIRPipeline
from diffbir_tpu.schedule import Schedule as JaxSchedule

from diffbir_tpu_torch import pipeline as port_pipeline
from diffbir_tpu_torch.inference import bfr_loop, bid_loop, bsr_loop
from diffbir_tpu_torch.inference.__main__ import DEFAULT_NEG_PROMPT, DEFAULT_POS_PROMPT, main
from diffbir_tpu_torch.inference.loop import controlnet_name
from diffbir_tpu_torch.models import tokenizer as port_tok
from diffbir_tpu_torch.models.bsrnet import RRDBNet
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.models.layers import random_init_
from diffbir_tpu_torch.models.scunet import SCUNet
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.utils.image_io import read_png, read_rgb, write_png
from diffbir_tpu_torch.weights.convert import SD_MODULE_MAP
from tests.test_torch_loop import _jax_weights
from tests.test_torch_pipeline import jax_noise

SWIN_KW = dict(embed_dim=24, depths=(2,), num_heads=(4,), window_size=4)
RRDB_KW = dict(nf=8, nb=1, gc=4)
SCU_KW = dict(config=(2, 1, 1, 2, 1, 1, 2), dim=16, head_dim=8)
TINY = {"swinir": (SwinIR, JaxSwinIR, SWIN_KW), "bsrnet": (RRDBNet, JaxRRDBNet, RRDB_KW),
        "scunet": (SCUNet, JaxSCUNet, SCU_KW)}
# the model section of configs/train/train_stage2_v2.1.yaml, its SwinIR cut
# to the tiny config
TRAIN_CFG = """\
model:
  zero_snr: true
  parameterization: v
  cldm:
    use_checkpoint: true
  swinir:
    target: diffbir_tpu.models.swinir.SwinIR
    params:
      img_size: 64
      in_chans: 3
      embed_dim: 24
      depths: [2]
      num_heads: [4]
      window_size: 4
      mlp_ratio: 2
      sf: 8
      img_range: 1.0
      upsampler: "nearest+conv"
      resi_connection: "1conv"
      unshuffle: true
      unshuffle_scale: 8
train:
  sd_path: {sd}
  swinir_path: swinir_realesrgan   # random init: not read
  learning_rate: 1e-5
"""


def _tiny(cls, kw):
    return lambda dtype=torch.float32, device=None: cls(**kw, dtype=dtype, device=device)


_CLEANER_INIT = port_pipeline.CleanerPipeline.__init__


def _small_cond_init(self, *args, **kw):
    """The cleaner pipelines with a 64-pixel minimum condition (tiny sizes)."""
    _CLEANER_INIT(self, *args, **{**kw, "min_cond_size": 64})


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """Random-init tiny models behind the real loops, a stand-in merges file
    for the prompts, a folder holding one 32x32 PNG."""
    monkeypatch.setenv("DIFFBIR_TPU_RANDOM_INIT", "1")
    monkeypatch.setattr(ControlLDM, "sd21", classmethod(
        lambda cls, dtype=torch.float32, device=None, **kw: cls.tiny(dtype=dtype, device=device)))
    for mod in (bsr_loop, bid_loop, bfr_loop):
        monkeypatch.setattr(mod, "SwinIR", _tiny(SwinIR, SWIN_KW))
    monkeypatch.setattr(bsr_loop, "RRDBNet", _tiny(RRDBNet, RRDB_KW))
    monkeypatch.setattr(bid_loop, "SCUNet", _tiny(SCUNet, SCU_KW))
    monkeypatch.setattr(port_pipeline.CleanerPipeline, "__init__", _small_cond_init)
    bpe = str(tmp_path / port_tok.BPE_NAME)
    port_tok.write_stand_in_merges(bpe, [DEFAULT_POS_PROMPT, DEFAULT_NEG_PROMPT])
    monkeypatch.setenv("DIFFBIR_TPU_BPE_PATH", bpe)
    port_tok.get_tokenizer.cache_clear()
    (tmp_path / "in").mkdir()
    write_png(str(tmp_path / "in" / "lq.png"),
              np.random.default_rng(2).integers(0, 256, (32, 32, 3), dtype=np.uint8))
    yield tmp_path
    port_tok.get_tokenizer.cache_clear()


def _cli(root, task, *extra):
    return ["--task", task, "--input", str(root / "in"), "--output", str(root / "out"),
            "--device", "cpu", "--steps", "2", "--upscale", "2", *extra]


def _schedule(parameterization: str, zero_snr: bool):
    return JaxSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                              linear_end=0.0120, parameterization=parameterization,
                              zero_snr=zero_snr)


def _jax_reference(loop, lq, cleaner: str, pipe_cls, schedule, **pipe_kw):
    """The JAX pipeline ``pipe_cls`` on the loop's tiny cleaner and ControlLDM
    (converted), its tokenizer, ``schedule``, the loop's request."""
    a = loop.args
    _, jax_cls, kw = TINY[cleaner]
    jm = jax_cls(**kw)
    cparams = _jax_weights(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 64, 64, 3))), loop.cleaner)
    jc = JaxControlLDM.tiny()
    shapes = jc.eval_shapes((8, 8))
    params = {n: _jax_weights(shapes[n], getattr(loop.cldm, n)) for n in shapes}
    jp = pipe_cls(jax.jit(lambda x: jnp.clip(jm.apply(cparams, x), 0.0, 1.0)), jc, params,
                  schedule, tokenizer=loop.pipeline.tokenizer, min_cond_size=64, **pipe_kw)
    return jp.run(lq[None], steps=a.steps, pos_prompt=a.pos_prompt, neg_prompt=a.neg_prompt,
                  cfg_scale=a.cfg_scale, sampler_type=a.sampler, seed=a.seed, eta=a.eta,
                  s_tmax=a.s_tmax, order=a.order)[0]


def _on_jax_draws(monkeypatch, latent: int):
    x_T, noise = jax_noise(231, (1, latent, latent, 4), 2)
    run = port_pipeline.Pipeline.run
    monkeypatch.setattr(port_pipeline.Pipeline, "run", lambda self, lq, **kw: run(
        self, lq, x_T=x_T, noise_table=noise, **kw))


EPS = ("eps", False)
CASES = {
    # task, flags, cleaner, JAX pipeline, its keywords, schedule (parameterization, zero SNR)
    "denoise_v1": ("denoise", ["--version", "v1"], "swinir", JaxSwinIRPipeline, {}, EPS),
    "denoise_v2": ("denoise", ["--version", "v2"], "scunet", JaxSCUNetPipeline, {}, EPS),
    "face_v1": ("face", ["--version", "v1"], "swinir", JaxSwinIRPipeline, {}, EPS),
    "sr_v2": ("sr", ["--version", "v2"], "bsrnet", JaxBSRNetPipeline, {"upscale": 2.0}, EPS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_task_and_version_match_jax(tiny, monkeypatch, case):
    task, flags, cleaner, pipe_cls, pipe_kw, sched = CASES[case]
    _on_jax_draws(monkeypatch, 8)
    loop = main(_cli(tiny, task, "--precision", "fp32", *flags))
    assert isinstance(loop.cleaner, TINY[cleaner][0])
    out = read_png(str(tiny / "out" / "lq.png"))
    assert out.shape == (64, 64, 3) and out.std() > 1.0
    lq = loop.after_load_lq(read_rgb(str(tiny / "in" / "lq.png")))
    assert lq.shape == ((32, 32, 3) if cleaner == "bsrnet" else (64, 64, 3))
    ref = _jax_reference(loop, lq, cleaner, pipe_cls, _schedule(*sched), **pipe_kw)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def _write_sd_and_controlnet(root):
    """A tiny SD base (the SD checkpoint's key prefixes) and ControlNet
    state_dict, both bf16, from a seeded random model."""
    cldm = ControlLDM.tiny()
    random_init_(cldm, torch.Generator().manual_seed(5))
    sd = {prefix + k: v.to(torch.bfloat16) for name, prefix in SD_MODULE_MAP.items()
          for k, v in getattr(cldm, name).state_dict().items()}
    torch.save({"state_dict": sd}, str(root / "sd.ckpt"))
    torch.save({k: v.to(torch.bfloat16) for k, v in cldm.controlnet.state_dict().items()},
               str(root / "controlnet.pt"))
    return cldm


def test_custom_version_matches_jax(tiny, monkeypatch):
    """--version custom: the train config's SwinIR (its diffbir_tpu target
    read as the port's), its v / zero-SNR schedule, the SD base and the
    ControlNet from the bf16 files."""
    src = _write_sd_and_controlnet(tiny)
    (tiny / "train.yaml").write_text(TRAIN_CFG.format(sd=tiny / "sd.ckpt"))
    _on_jax_draws(monkeypatch, 8)
    loop = main(_cli(tiny, "denoise", "--precision", "fp32", "--version", "custom",
                     "--train_cfg", str(tiny / "train.yaml"), "--ckpt",
                     str(tiny / "controlnet.pt")))
    assert isinstance(loop.cleaner, SwinIR) and len(loop.cleaner.layers) == 1
    assert loop.schedule.parameterization == "v"
    for name in SD_MODULE_MAP:
        for k, v in getattr(src, name).state_dict().items():
            assert torch.equal(getattr(loop.cldm, name).state_dict()[k],
                               v.to(torch.bfloat16).float()), (name, k)
    out = read_png(str(tiny / "out" / "lq.png"))
    assert out.shape == (64, 64, 3) and out.std() > 1.0
    lq = loop.after_load_lq(read_rgb(str(tiny / "in" / "lq.png")))
    ref = _jax_reference(loop, lq, "swinir", JaxSwinIRPipeline, _schedule("v", True))
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_version_and_task_matrix():
    assert [controlnet_name(v, t) for v, t in (("v1", "sr"), ("v1", "denoise"), ("v1", "face"),
                                               ("v2", "face"), ("v2.1", "denoise"))] == [
        "v1_general", "v1_general", "v1_face", "v2", "v2.1"]
    with pytest.raises(ValueError, match="unaligned_face"):
        controlnet_name("v1", "unaligned_face")


@pytest.mark.parametrize("task,version,missing", [
    ("face", "v1", "face_swinir_v1.ckpt"), ("face", "v2.1", "face_swinir_v1.ckpt"),
    ("denoise", "v1", "general_swinir_v1.ckpt"), ("denoise", "v2", "scunet_color_real_psnr.pth"),
    ("denoise", "v2.1", "realesrgan_s4_swinir_100k.pth"), ("sr", "v2", "BSRNet.pth"),
])
def test_each_path_asks_for_its_cleaner_by_name(tiny, monkeypatch, task, version, missing):
    monkeypatch.delenv("DIFFBIR_TPU_RANDOM_INIT")
    monkeypatch.setenv("DIFFBIR_TPU_WEIGHTS", str(tiny / "weights"))
    with pytest.raises(FileNotFoundError, match=missing):
        main(_cli(tiny, task, "--version", version))


@pytest.mark.parametrize("task,version,cleaner,file,sd_file", [
    ("sr", "v2", "bsrnet", "BSRNet.pth", "v2-1_512-ema-pruned.ckpt"),
    ("denoise", "v2", "scunet", "scunet_color_real_psnr.pth", "v2-1_512-ema-pruned.ckpt"),
    ("face", "v2.1", "swinir", "face_swinir_v1.ckpt", "sd2.1-base-zsnr-laionaes5.ckpt"),
])
def test_a_cleaner_checkpoint_loads_then_the_sd_base_is_asked_for(
        tiny, monkeypatch, task, version, cleaner, file, sd_file):
    """A KAIR-layout checkpoint (``module.`` prefixes) of the cleaner loads
    strictly; the loop then asks for the version's SD base."""
    cls, _, kw = TINY[cleaner]
    (tiny / "weights").mkdir()
    torch.save({"module." + k: v for k, v in cls(**kw).state_dict().items()},
               str(tiny / "weights" / file))
    monkeypatch.delenv("DIFFBIR_TPU_RANDOM_INIT")
    monkeypatch.setenv("DIFFBIR_TPU_WEIGHTS", str(tiny / "weights"))
    with pytest.raises(FileNotFoundError, match=sd_file):
        main(_cli(tiny, task, "--version", version))


def test_refusals(tiny, monkeypatch):
    # --task unaligned_face runs (tests/test_torch_unaligned.py) where its
    # detector's weights are; without them it names the file, and v1 has no
    # ControlNet for it, as in JAX
    monkeypatch.setenv("DIFFBIR_TPU_WEIGHTS", str(tiny / "weights"))
    with pytest.raises(FileNotFoundError, match="detection_Resnet50_Final.pth"):
        main(_cli(tiny, "unaligned_face"))
    with pytest.raises(ValueError, match="DiffBIR v1 doesn't support task: unaligned_face"):
        main(_cli(tiny, "unaligned_face", "--version", "v1"))
    orbax = tiny / "ckpt_0001"
    orbax.mkdir()
    (tiny / "train.yaml").write_text(TRAIN_CFG.format(sd="sd_v2.1"))
    with pytest.raises(ValueError, match="ckpt_0001"):
        main(_cli(tiny, "sr", "--version", "custom", "--train_cfg", str(tiny / "train.yaml"),
                  "--ckpt", str(orbax)))
    with pytest.raises(ValueError, match="--ckpt"):
        main(_cli(tiny, "sr", "--version", "custom", "--train_cfg", str(tiny / "train.yaml")))
    assert not os.path.exists(tiny / "out" / "lq.png")
