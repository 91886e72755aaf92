"""The port's inference loop and CLI on the CPU, at tiny sizes.

- PNG reading and writing (``utils.image_io``, zlib alone) against PIL, both
  ways, pixel for pixel (grey, RGB, RGBA; PIL's adaptive row filters);
- the blind-SR pre-upscale (``BSRInferenceLoop.after_load_lq``) bit-equal to
  PIL's bicubic resize;
- a DiffBIR-style checkpoint written by the test, loaded strictly;
- the loop's plumbing on random-init tiny models (``DIFFBIR_TPU_RANDOM_INIT``,
  ``ControlLDM.sd21`` and ``SwinIR`` swapped for the tiny configs): output
  names, the per-chunk seeds, ``prompt.csv`` appended, and ``loop.run``'s
  PNG equal to a direct ``pipeline.run`` of the same request;
- ``python -m diffbir_tpu_torch.inference --device cpu`` (run in process)
  with the CLI's defaults but 2 steps, prompts through a stand-in merges
  file; the tiling flags (cleaner, VAE, diffusion) reach ``pipeline.run``;
  the turbo flags, guidance (latent and RGB) and ``--fast_gelu`` run, the
  PNG within 1 uint8 level of the JAX ``SwinIRPipeline`` on the loop's own
  weights (converted with the JAX ``fill_flax_params``) and JAX's draws
  (handed to the port's ``pipeline.run``); ``--task unaligned_face`` at v1
  (no ControlNet for it) and without the detector's weights, a missing
  weight file and a missing merges file raise, naming them, and without a
  card the CLI refuses to run.
"""

import csv
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffbir_tpu.models.cldm import ControlLDM as JaxControlLDM
from diffbir_tpu.models.swinir import SwinIR as JaxSwinIR
from diffbir_tpu.pipeline import SwinIRPipeline as JaxSwinIRPipeline
from diffbir_tpu.schedule import Schedule as JaxSchedule
from diffbir_tpu.utils import cond_fn as jax_cond
from diffbir_tpu.weights.convert import fill_flax_params

from diffbir_tpu_torch.inference import bsr_loop, loop as loop_mod
from diffbir_tpu_torch.inference.__main__ import DEFAULT_NEG_PROMPT, DEFAULT_POS_PROMPT, main
from diffbir_tpu_torch.inference.pretrained_models import MODELS, resolve_model
from diffbir_tpu_torch.models import tokenizer as port_tok
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.utils.common import pil_bicubic_resize
from diffbir_tpu_torch.utils.image_io import read_png, read_rgb, write_png
from diffbir_tpu_torch.weights.convert import load_into, load_torch_state_dict
from tests.test_torch_pipeline import jax_noise

SWIN_KW = dict(embed_dim=24, depths=(2,), num_heads=(4,), window_size=4)


# --------------------------------------------------------------------------- #
# images
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3), ("RGBA", 4)])
def test_read_png_matches_pil(tmp_path, mode, channels):
    rng = np.random.default_rng(channels)
    # smooth ramps plus noise, so PIL's encoder picks several row filters
    base = np.linspace(0, 200, 23 * 31 * channels).reshape(23, 31, channels)
    img = (base + rng.integers(0, 40, base.shape)).astype(np.uint8)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(path)
    got = read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(read_rgb(path), np.asarray(Image.open(path).convert("RGB")))


def test_write_png_reads_back_in_pil(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (17, 29, 3), dtype=np.uint8)
    path = str(tmp_path / "out.png")
    write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_other_formats_raise_naming_the_file(tmp_path):
    jpg = str(tmp_path / "photo.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpg)
    with pytest.raises(ValueError, match="photo.jpg"):
        read_png(jpg)
    pal = str(tmp_path / "palette.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).convert("P").save(pal)
    with pytest.raises(ValueError, match="palette.png"):
        read_png(pal)


@pytest.mark.parametrize("hw,up", [((37, 29), 4.0), ((16, 24), 2.5), ((20, 20), 1.0)])
def test_after_load_lq_is_pil_bicubic(hw, up):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    size = tuple(int(x * up) for x in (hw[1], hw[0]))
    ref = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))
    loop = bsr_loop.BSRInferenceLoop.__new__(bsr_loop.BSRInferenceLoop)
    loop.args = type("A", (), {"upscale": up, "version": "v2.1"})()
    out = loop.after_load_lq(img)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        pil_bicubic_resize(torch.from_numpy(img), (size[1], size[0])).numpy(), ref)


# --------------------------------------------------------------------------- #
# weights
# --------------------------------------------------------------------------- #
def test_checkpoint_loads_strictly(tmp_path):
    src = SwinIR(**SWIN_KW)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in src.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    path = str(tmp_path / "cleaner.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in src.state_dict().items()}}, path)
    dst = load_into(SwinIR(**SWIN_KW), load_torch_state_dict(path), path=path)
    for (k, a), b in zip(src.state_dict().items(), dst.state_dict().values()):
        assert torch.equal(a, b), k
    sd = load_torch_state_dict(path)
    sd.pop(next(iter(sd)))
    with pytest.raises(KeyError, match="cleaner.pth"):
        load_into(SwinIR(**SWIN_KW), sd, path=path)


def test_missing_weights_raise_naming_file_and_url(tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFBIR_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(FileNotFoundError) as e:
        resolve_model("v2.1")
    assert "DiffBIR_v2.1.pt" in str(e.value) and MODELS["v2.1"] in str(e.value)
    (tmp_path / "DiffBIR_v2.1.pt").write_bytes(b"")
    assert resolve_model("v2.1") == str(tmp_path / "DiffBIR_v2.1.pt")


# --------------------------------------------------------------------------- #
# the loop and the CLI on tiny random models
# --------------------------------------------------------------------------- #
@pytest.fixture
def tiny_cli(tmp_path, monkeypatch):
    """Random-init tiny models behind the real loop; a stand-in merges file
    for the CLI's prompts; a folder holding one 32x32 PNG."""
    monkeypatch.setenv("DIFFBIR_TPU_RANDOM_INIT", "1")
    monkeypatch.setattr(ControlLDM, "sd21", classmethod(
        lambda cls, dtype=torch.float32, device=None, **kw: cls.tiny(dtype=dtype, device=device)))
    monkeypatch.setattr(bsr_loop, "SwinIR",
                        lambda dtype, device=None: SwinIR(**SWIN_KW, dtype=dtype, device=device))
    monkeypatch.setattr(bsr_loop.SwinIRPipeline, "__init__", _small_cond_init)
    bpe = str(tmp_path / port_tok.BPE_NAME)
    port_tok.write_stand_in_merges(bpe, [DEFAULT_POS_PROMPT, DEFAULT_NEG_PROMPT])
    monkeypatch.setenv("DIFFBIR_TPU_BPE_PATH", bpe)
    port_tok.get_tokenizer.cache_clear()
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    write_png(str(in_dir / "lq.png"),
              np.random.default_rng(2).integers(0, 256, (32, 32, 3), dtype=np.uint8))
    yield tmp_path
    port_tok.get_tokenizer.cache_clear()


_SWINIR_INIT = bsr_loop.SwinIRPipeline.__init__


def _small_cond_init(self, *args, **kw):
    """The SwinIR pipeline with a 64-pixel minimum condition (tiny sizes)."""
    _SWINIR_INIT(self, *args, **{**kw, "min_cond_size": 64})


def _cli(tmp_path, *extra):
    return ["--task", "sr", "--input", str(tmp_path / "in"), "--output", str(tmp_path / "out"),
            "--device", "cpu", "--steps", "2", "--upscale", "2", *extra]


def test_cli_runs_on_the_cpu(tiny_cli, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["diffbir_tpu_torch.inference"] + _cli(tiny_cli))
    runpy.run_module("diffbir_tpu_torch.inference", run_name="__main__", alter_sys=True)
    out = read_png(str(tiny_cli / "out" / "lq.png"))
    assert out.shape == (64, 64, 3) and out.std() > 1.0
    with open(tiny_cli / "out" / "prompt.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows == [["file_name", "prompt", "neg_prompt"],
                    ["lq.png", DEFAULT_POS_PROMPT, DEFAULT_NEG_PROMPT]]


def test_loop_names_seeds_prompt_log_and_direct_run(tiny_cli):
    loop = main(_cli(tiny_cli, "--n_samples", "3", "--batch_size", "2",
                     "--pos_prompt", "a fox", "--cfg_scale", "2.0"))
    out_dir = tiny_cli / "out"
    assert sorted(os.listdir(out_dir)) == ["lq_0.png", "lq_1.png", "lq_2.png", "prompt.csv"]
    imgs = [read_png(str(out_dir / f"lq_{i}.png")) for i in range(3)]
    assert np.any(imgs[0] != imgs[1])  # one chunk: two rows of one seed's draws
    assert np.any(imgs[0] != imgs[2])  # the second chunk runs at seed + 2
    stages = set(loop.timings)
    assert {"load", "read", "cleaner", "condition", "hoist", "denoise", "decode",
            "write"} <= stages
    # loop.run against pipeline.run of the same request
    lq = loop.after_load_lq(read_rgb(str(tiny_cli / "in" / "lq.png")))
    direct = loop.pipeline.run(lq[None], steps=2, pos_prompt="a fox",
                               neg_prompt=DEFAULT_NEG_PROMPT, cfg_scale=2.0,
                               sampler_type="edm_dpm++_3m_sde", seed=231 + 2, eta=1.0,
                               s_tmax=300.0, order=4)
    np.testing.assert_array_equal(direct[0], imgs[2])
    main(_cli(tiny_cli, "--pos_prompt", "a fox", "--cfg_scale", "2.0"))  # appends
    with open(out_dir / "prompt.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["file_name", "prompt", "neg_prompt"] and len(rows) == 5
    assert [r[0] for r in rows[1:]] == ["lq_0.png", "lq_1.png", "lq_2.png", "lq.png"]


def _jax_weights(tree_shapes, module):
    """A JAX param tree of ``tree_shapes`` holding ``module``'s tensors."""
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    return jax.tree_util.tree_map(jnp.asarray, fill_flax_params(tree_shapes, sd)[0])


def _jax_cli_reference(loop, lq, monkeypatch):
    """The JAX SwinIRPipeline's output for the loop's request: the loop's
    tiny random SwinIR and ControlLDM converted, its tokenizer, its flags
    (turbo, guidance, and DIFFBIR_TPU_FAST_GELU for --fast_gelu)."""
    a = loop.args
    js = JaxSwinIR(**SWIN_KW)
    sparams = _jax_weights(jax.eval_shape(js.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 64, 64, 3))), loop.cleaner)
    jc = JaxControlLDM.tiny()
    shapes = jc.eval_shapes((8, 8))
    params = {n: _jax_weights(shapes[n], getattr(loop.cldm, n)) for n in shapes}
    cond_fn = None
    if a.guidance:
        cls = {"mse": jax_cond.MSEGuidance, "w_mse": jax_cond.WeightedMSEGuidance}[a.g_loss]
        cond_fn = cls(a.g_scale, a.g_start, a.g_stop, a.g_space, a.g_repeat)
    if a.fast_gelu:
        monkeypatch.setenv("DIFFBIR_TPU_FAST_GELU", "1")
    sched = JaxSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                               linear_end=0.0120, parameterization="v", zero_snr=True)
    jp = JaxSwinIRPipeline(jax.jit(lambda x: jnp.clip(js.apply(sparams, x), 0.0, 1.0)), jc,
                           params, sched, tokenizer=loop.pipeline.tokenizer, cond_fn=cond_fn,
                           min_cond_size=64)
    return jp.run(lq[None], steps=a.steps, pos_prompt=a.pos_prompt, neg_prompt=a.neg_prompt,
                  cfg_scale=a.cfg_scale, sampler_type=a.sampler, seed=a.seed, eta=a.eta,
                  s_tmax=a.s_tmax, order=a.order, control_interval=a.control_interval,
                  turbo_encoder=a.turbo_encoder)[0]


@pytest.mark.parametrize("flag", [
    ["--control_interval", "2", "--turbo_encoder"],
    ["--guidance", "--g_space", "rgb", "--g_scale", "0.05"],
    ["--fast_gelu"],
    ["--guidance", "--g_loss", "mse", "--g_scale", "0.01", "--g_repeat", "2", "--g_start",
     "600", "--g_stop", "200"],
])
def test_unported_flags_raise_naming_the_flag(tiny_cli, monkeypatch, flag):
    """Once refused as unported, now ported: the turbo flags, guidance (RGB
    w_mse; latent mse in a window, two rounds) and --fast_gelu run through
    the CLI (fp32, on JAX's draws), and the PNG is within 1 uint8 level of
    the JAX pipeline's on the same weights and request."""
    x_T, noise = jax_noise(231, (1, 8, 8, 4), 2)
    run = bsr_loop.SwinIRPipeline.run
    monkeypatch.setattr(bsr_loop.SwinIRPipeline, "run", lambda self, lq, **kw: run(
        self, lq, x_T=x_T, noise_table=noise, **kw))
    loop = main(_cli(tiny_cli, "--precision", "fp32", *flag))
    out = read_png(str(tiny_cli / "out" / "lq.png"))
    assert out.shape == (64, 64, 3) and out.std() > 1.0
    lq = loop.after_load_lq(read_rgb(str(tiny_cli / "in" / "lq.png")))
    ref = _jax_cli_reference(loop, lq, monkeypatch)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


TILE_FLAGS = ["--cleaner_tiled", "--cleaner_tile_size", "64", "--cleaner_tile_stride", "32",
              "--vae_encoder_tiled", "--vae_encoder_tile_size", "64",
              "--vae_decoder_tiled", "--vae_decoder_tile_size", "64",
              "--cldm_tiled", "--cldm_tile_size", "64", "--cldm_tile_stride", "32"]


@pytest.mark.parametrize("mode,per", [("blend", 1), ("sync_gn", 4)])
def test_cli_tiling_flags_reach_the_pipeline(tiny_cli, mode, per):
    """The CLI with every tiling flag on a 128x128 condition (--upscale 4):
    9 cleaner tiles, 9 blend or 4 sync_gn VAE tiles, 9 latent tiles per
    step in groups of ``per``; the PNG equals a direct ``pipeline.run``
    with the same tile arguments, and differs from the untiled request."""
    flags = TILE_FLAGS + ["--vae_tile_mode", mode, "--cldm_tiles_per_batch", str(per),
                          "--upscale", "4"]
    loop = main(_cli(tiny_cli, *flags))
    out = read_png(str(tiny_cli / "out" / "lq.png"))
    assert out.shape == (128, 128, 3) and out.std() > 1.0
    lq = loop.after_load_lq(read_rgb(str(tiny_cli / "in" / "lq.png")))
    a = loop.args
    tiles = dict(cleaner_tiled=True, cleaner_tile_size=64, cleaner_tile_stride=32,
                 vae_encoder_tiled=True, vae_encoder_tile_size=64, vae_decoder_tiled=True,
                 vae_decoder_tile_size=64, vae_tile_mode=mode, cldm_tiled=True,
                 cldm_tile_size=64, cldm_tile_stride=32, cldm_tiles_per_batch=per)
    run = dict(steps=2, pos_prompt=a.pos_prompt, neg_prompt=a.neg_prompt, cfg_scale=a.cfg_scale,
               sampler_type=a.sampler, seed=a.seed, eta=a.eta, s_tmax=a.s_tmax, order=a.order)
    np.testing.assert_array_equal(loop.pipeline.run(lq[None], **run, **tiles)[0], out)
    assert np.any(loop.pipeline.run(lq[None], **run)[0] != out)


def test_cli_refusals(tiny_cli, monkeypatch):
    # --task unaligned_face (tests/test_torch_unaligned.py): v1 has no
    # ControlNet for it (ValueError, as in JAX); v2 and v2.1 ask for the face
    # detector's weights by name before anything else loads
    monkeypatch.setenv("DIFFBIR_TPU_WEIGHTS", str(tiny_cli / "weights"))
    with pytest.raises(FileNotFoundError, match="detection_Resnet50_Final.pth"):
        main(_cli(tiny_cli)[:1] + ["unaligned_face"] + _cli(tiny_cli)[2:])
    for version in ("v1", "v2", "v2.1"):
        argv = _cli(tiny_cli, "--version", version)
        error, match = ((ValueError, "unaligned_face") if version == "v1" else
                        (FileNotFoundError, "detection_Resnet50_Final.pth"))
        with pytest.raises(error, match=match):
            main(argv[:1] + ["unaligned_face"] + argv[2:])
    # the default guidance loss (w_mse) weighs an RGB target: on the latent it
    # fails, as in JAX (its gray contraction meets 4 channels)
    with pytest.raises(ValueError, match="--g_space rgb"):
        main(_cli(tiny_cli, "--guidance"))
    if not torch.cuda.is_available():  # the card is the default device
        args = [a for a in _cli(tiny_cli) if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(args)
    with pytest.raises(FileNotFoundError, match="tokenizer.model"):
        main(_cli(tiny_cli, "--captioner", "llava"))
    monkeypatch.setenv("DIFFBIR_TPU_BPE_PATH", str(tiny_cli / "absent.txt.gz"))
    port_tok.get_tokenizer.cache_clear()
    with pytest.raises(FileNotFoundError, match=port_tok.BPE_NAME):
        main(_cli(tiny_cli))
    monkeypatch.delenv("DIFFBIR_TPU_RANDOM_INIT")
    monkeypatch.setenv("DIFFBIR_TPU_WEIGHTS", str(tiny_cli / "weights"))
    with pytest.raises(FileNotFoundError, match="realesrgan_s4_swinir_100k.pth"):
        main(_cli(tiny_cli))
    assert loop_mod.random_init_requested() is False
